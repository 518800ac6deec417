"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where no CUDA device is present.  Run
them on a GPU machine (which needs no jax) with

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

The shapes here are the awkward ones (widths off the 32-pixel tile, tiny
planes, a batch of one); ``chip_smoke.py`` covers the main path's shapes.
"""

import pytest
import torch

from avd_tpu_torch.ops import flow as flow_ops
from avd_tpu_torch.ops.kernels import attention, blur_solve, flow_iter, warp

pytestmark = pytest.mark.cuda

_SHAPES = [(1, 2, 2), (3, 37, 53), (2, 40, 48), (1, 96, 33), (2, 5, 300)]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("b,h,w", _SHAPES)
@pytest.mark.parametrize("scale", [0.0, 3.0, 40.0])
def test_warp_kernel_matches_plain(gen, b, h, w, scale):
    src = torch.rand((b, 5, h, w), generator=gen, device="cuda")
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) \
        * scale
    before = warp.LAUNCHES
    out = warp.warp_bilinear(src, fl)
    assert warp.LAUNCHES == before + 1
    ref = warp.warp_bilinear_plain(src, fl)
    _, inb = flow_ops._warp_poly(src, fl)
    inb = inb[:, None].expand_as(out)
    assert torch.allclose(out[inb], ref[inb], atol=1e-5, rtol=0)
    assert not out[~inb].any()


@pytest.mark.parametrize("b,h,w", _SHAPES)
def test_blur_solve_kernel_matches_plain(gen, b, h, w):
    r4, r5, r6, h1, h2 = torch.randn((5, b, h, w), generator=gen,
                                     device="cuda")
    m = torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                     h1, h2], dim=1).contiguous()
    before = blur_solve.LAUNCHES
    out = blur_solve.box_blur_solve(m)
    assert blur_solve.LAUNCHES == before + 1
    ref = blur_solve.box_blur_solve_plain(m)
    assert torch.allclose(out, ref, atol=2e-4, rtol=1e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    src = torch.rand((1, 5, 8, 8), generator=gen, device="cuda")
    fl = torch.zeros((1, 2, 8, 8), device="cuda")
    with pytest.raises(TypeError):
        warp.warp_bilinear(src.half(), fl)
    with pytest.raises(ValueError):
        warp.warp_bilinear(src.transpose(2, 3), fl)
    with pytest.raises(ValueError):
        warp.warp_bilinear(src, fl[:, :, :4])
    with pytest.raises(ValueError):
        blur_solve.box_blur_solve(src, winsize=9)
    with pytest.raises(ValueError):
        blur_solve.box_blur_solve(src[:, :4].contiguous())


@pytest.mark.parametrize("b,h,w", [(1, 16, 16), (3, 37, 53), (2, 40, 48),
                                   (1, 96, 33), (2, 17, 300), (2, 160, 160)])
@pytest.mark.parametrize("scale", [0.0, 3.0, 40.0])
def test_flow_iter_kernel_matches_plain(gen, b, h, w, scale):
    R0 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    R1 = torch.randn((b, 5, h, w), generator=gen, device="cuda")
    fl = (torch.rand((b, 2, h, w), generator=gen, device="cuda") - 0.5) \
        * scale
    counts = (warp.LAUNCHES, blur_solve.LAUNCHES, flow_iter.LAUNCHES)
    out = flow_iter.solve_iteration(R0, R1, fl)
    assert (warp.LAUNCHES, blur_solve.LAUNCHES, flow_iter.LAUNCHES) == \
        (counts[0], counts[1], counts[2] + 1)
    ref = flow_iter.solve_iteration_plain(R0, R1, fl)
    # the plain version launches none of the three kernels
    assert (warp.LAUNCHES, blur_solve.LAUNCHES, flow_iter.LAUNCHES) == \
        (counts[0], counts[1], counts[2] + 1)
    assert torch.allclose(out, ref, atol=5e-4, rtol=1e-3)


def test_flow_iter_wrapper_refuses_what_the_kernel_does_not_take(gen):
    R = torch.randn((1, 5, 32, 32), generator=gen, device="cuda")
    fl = torch.zeros((1, 2, 32, 32), device="cuda")
    with pytest.raises(ValueError, match="H, W >= 16"):
        flow_iter.solve_iteration(R[..., :8], R[..., :8], fl[..., :8])
    with pytest.raises(ValueError, match="winsize"):
        flow_iter.solve_iteration(R, R, fl, winsize=9)
    with pytest.raises(TypeError):
        flow_iter.solve_iteration(R.double(), R, fl)
    with pytest.raises(ValueError):
        flow_iter.solve_iteration(R, R, fl[:, :1])


def _qkv(gen, shape):
    return [torch.randn(shape, generator=gen, device="cuda").bfloat16()
            for _ in range(3)]


@pytest.mark.parametrize("b,h,t,d", [(2, 3, 17, 8), (8, 4, 17, 64),
                                     (3, 6, 197, 64), (1, 2, 65, 128),
                                     (2, 1, 1, 16), (1, 5, 300, 40)])
def test_mha_kernel_matches_plain(gen, b, h, t, d):
    q, k, v = _qkv(gen, (b, h, t, d))
    before = attention.LAUNCHES
    out = attention.mha(q, k, v)
    assert attention.LAUNCHES == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    ref = attention.mha_plain(q, k, v)
    assert attention.LAUNCHES == before + 1
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("b,t,h,d", [(2, 17, 3, 8), (4, 197, 6, 64)])
def test_attention_reads_the_qkv_views_in_place(gen, b, t, h, d):
    qkv = torch.randn((b, t, 3, h, d), generator=gen,
                      device="cuda").bfloat16()
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    before = attention.LAUNCHES
    out = attention.attention(q, k, v)
    assert attention.LAUNCHES == before + 1
    assert out.shape == (b, t, h * d) and out.is_contiguous()
    ref = attention.attention_plain(q, k, v)
    assert torch.allclose(out.float(), ref.float(), atol=2e-2, rtol=2e-2)


def test_attention_wrapper_refuses_what_the_kernel_does_not_take(gen):
    q, k, v = _qkv(gen, (1, 2, 9, 16))
    with pytest.raises(TypeError):
        attention.mha(q.float(), k, v)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention.mha(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError, match="shapes"):
        attention.mha(q, k[:, :1], v)
    big = _qkv(gen, (1, 1, 4000, 64))
    with pytest.raises(ValueError, match="shared memory"):
        attention.mha(*big)
