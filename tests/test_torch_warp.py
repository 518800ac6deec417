"""The port's warp (plain version on the CPU) against the TPU kernel.

``avd_tpu.ops.pallas.warp.warp_bilinear`` runs in interpret mode, as the
JAX package's own tests run it.  Contract: in-bounds pixels
(0 <= floor(coord) <= size-2) within atol 1e-5, every other pixel exactly 0
(tests/test_pallas_warp.py).  The cases are those of
``tests/test_pallas_warp.py``.
"""

import numpy as np
import pytest
import torch
from scipy.signal import convolve2d

import jax.numpy as jnp

from avd_tpu.ops.pallas import warp as pwarp
from avd_tpu_torch.ops import flow as tflow
from avd_tpu_torch.ops.kernels import warp as twarp

torch.set_num_threads(1)


def _case(seed, b, h, w, scale, smooth=True):
    rng = np.random.default_rng(seed)
    src = rng.random((b, 5, h, w)).astype(np.float32)
    flow = (rng.random((b, 2, h, w)).astype(np.float32) - 0.5) * scale
    if smooth:
        k = np.ones((5, 5)) / 25.0
        flow = np.stack([[convolve2d(f, k, mode="same", boundary="symm")
                          for f in fb] for fb in flow]).astype(np.float32)
    return src, flow


def _check(src, flow, atol=1e-5):
    ref = np.asarray(pwarp.warp_bilinear(jnp.asarray(src), jnp.asarray(flow),
                                         interpret=True))
    ours, inb = tflow._warp_poly(torch.from_numpy(src),
                                 torch.from_numpy(flow))
    ours = ours.numpy()
    inb = inb.numpy()[:, None]
    np.testing.assert_allclose(np.where(inb, ours, 0.0),
                               np.where(inb, ref, 0.0), atol=atol)
    # out of bounds: exactly 0, in the port and in the TPU kernel
    assert not np.where(inb, 0.0, ours).any()
    assert not np.where(inb, 0.0, ref).any()
    return inb


@pytest.mark.parametrize("scale", [0.0, 1.0, 6.0, 40.0])
def test_matches_tpu_warp(scale):
    inb = _check(*_case(0, 2, 80, 128, scale))
    if scale >= 6.0:
        assert not inb.all()  # the out-of-bounds rule is exercised


def test_rough_flow():
    _check(*_case(1, 1, 40, 128, 10.0, smooth=False))


def test_uniform_pan():
    src, _ = _case(3, 1, 40, 128, 0)
    flow = np.empty((1, 2, 40, 128), np.float32)
    flow[:, 0] = 61.0
    flow[:, 1] = 3.0
    _check(src, flow)


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_out_of_bounds_zeroed(sign):
    src, _ = _case(2, 1, 40, 128, 0)
    flow = np.full((1, 2, 40, 128), 500.0 * sign, np.float32)
    out = twarp.warp_bilinear(torch.from_numpy(src), torch.from_numpy(flow))
    assert not out.numpy().any()


def test_integer_flow_is_a_shift():
    """Whole-pixel flow copies the source exactly where in bounds."""
    src, _ = _case(4, 1, 40, 48, 0)
    flow = np.zeros((1, 2, 40, 48), np.float32)
    flow[:, 0] = 2.0
    flow[:, 1] = -1.0
    out = twarp.warp_bilinear(torch.from_numpy(src),
                              torch.from_numpy(flow)).numpy()
    np.testing.assert_array_equal(out[..., 1:39, 0:45],
                                  src[..., 0:38, 2:47])
    assert not out[..., 0, :].any()   # y - 1 < 0
    assert not out[..., :, 46:].any()  # x + 2 > W - 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w,scale", [(2, 40, 56, 4.0), (1, 80, 96, 40.0),
                                         (3, 9, 7, 2.0), (1, 2, 11, 1.0)])
def test_warp_update_on_the_cpu_is_the_plain_composition(dtype, b, h, w,
                                                         scale):
    """On CPU tensors the warp with the update epilogue is
    ``update_from_warped`` after the plain warp, launches nothing, and
    returns float32 M from bf16 fields too."""
    rng = np.random.default_rng(5)
    r0, r1 = (torch.from_numpy(rng.standard_normal((b, 5, h, w))
                               .astype(np.float32)).to(dtype)
              for _ in range(2))
    fl = torch.from_numpy(((rng.random((b, 2, h, w)) - 0.5) * scale)
                          .astype(np.float32))
    counts = (twarp.LAUNCHES, dict(twarp.DTYPE_LAUNCHES),
              dict(twarp.VARIANT_LAUNCHES))
    got = twarp.warp_update(r0, r1, fl)
    assert (twarp.LAUNCHES, twarp.DTYPE_LAUNCHES,
            twarp.VARIANT_LAUNCHES) == counts
    assert got.dtype == torch.float32 and got.shape == (b, 5, h, w)
    assert torch.equal(got, tflow.update_from_warped(
        r0, twarp.warp_bilinear_plain(r1, fl), fl))
    assert torch.equal(got, tflow._update_matrices(r0, r1, fl))


def _edge_scale(p, size):
    """``csrc/update.cuh``'s taper of one axis, in float32: the factor of
    each edge whose 5-px band holds p, both where the bands meet."""
    s = np.float32(1.0)
    if p < 5:
        s = s * np.float32(twarp.BORDER_SCALE[p])
    if size - 1 - p < 5:
        s = s * np.float32(twarp.BORDER_SCALE[size - 1 - p])
    return s


@pytest.mark.parametrize("h", [2, 3, 5, 7, 9, 10, 11, 16, 40])
@pytest.mark.parametrize("w", [2, 4, 6, 9, 10, 13, 320])
def test_the_kernels_taper_rule_is_the_plain_table(h, w):
    """The update kernel forms the taper per pixel as edge_scale(y, H) ·
    edge_scale(x, W); it is ``_border_taper``'s table bit for bit at every
    size, the small ones whose bands meet included."""
    ours = np.array([[_edge_scale(y, h) * _edge_scale(x, w)
                      for x in range(w)] for y in range(h)], np.float32)
    ref = tflow._border_taper(h, w)
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
