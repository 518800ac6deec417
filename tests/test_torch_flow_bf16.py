"""bf16 field storage (``AVD_FLOW_BF16=1``) in the port, on the CPU.

R0/R1 and M are stored in bfloat16 between the flow stages; every sum
stays float32.  The plain warp and blur+solve widen a bf16 input and run
as in float32, within bf16 rounding of the field (8e-3 and 2e-2, the
bounds of ``tests/test_flow_bf16.py``).  ``farneback_flow`` with
``flow_bf16`` against the JAX package's under ``AVD_FLOW_BF16=1``: the
per-pair flow mean within rtol 1e-4.  The variance does not hold rtol
1e-3: the two float32 R0 fields differ in their last bits (summation
order), and a bf16 rounding that lands on the other side of a boundary
moves the variance by up to about 8e-3 relative (measured on the "pan"
pairs: 2.0e-3, 2.8e-3, 8.4e-3).  So the variance is held to the study's
bound, |Δmean| < 0.05, |Δvar| < 0.08 and the same scene-change bit
(``tests/test_flow_bf16.py``), as is the port's bf16 against its f32.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avd_tpu.ops import flow as jflow
from avd_tpu_torch.ops import flow as tflow
from avd_tpu_torch.ops.kernels import blur_solve, warp

torch.set_num_threads(1)


def _pairs(kind, n=3, h=160, w=160):
    rng = np.random.default_rng(7)
    if kind == "noise":
        return (rng.random((n, h, w), np.float32) * 255.0,
                rng.random((n, h, w), np.float32) * 255.0)
    base = rng.random((h + 16, w + 16), np.float32) * 255.0
    base = (base[:-1, :-1] + base[1:, :-1] + base[:-1, 1:]
            + base[1:, 1:]) / 4
    prev = np.stack([base[4:4 + h, 4:4 + w]] * n)
    cur = np.stack([base[4 + dy:4 + dy + h, 6:6 + w]
                    for dy in range(1, n + 1)]).astype(np.float32)
    return prev.astype(np.float32), cur


def _stats(fl):
    mag = np.sqrt(fl[..., 0] ** 2 + fl[..., 1] ** 2)
    return mag.mean(axis=(1, 2)), mag.var(axis=(1, 2))


def _jax_flow(prev, cur, monkeypatch, bf16):
    monkeypatch.setenv("AVD_FLOW_BF16", "1" if bf16 else "0")
    jflow._flow_bf16.cache_clear()
    try:
        return np.asarray(jflow.farneback_flow(jnp.asarray(prev),
                                               jnp.asarray(cur)))
    finally:
        monkeypatch.delenv("AVD_FLOW_BF16")
        jflow._flow_bf16.cache_clear()


def _port_flow(prev, cur, bf16):
    return tflow.farneback_flow(torch.from_numpy(prev),
                                torch.from_numpy(cur),
                                flow_bf16=bf16).numpy()


def _study_bound(got, ref):
    gm, gv = _stats(got)
    rm, rv = _stats(ref)
    assert np.abs(gm - rm).max() < 0.05
    assert np.abs(gv - rv).max() < 0.08
    np.testing.assert_array_equal(gv > 0.5, rv > 0.5)


@pytest.fixture(scope="module", params=["pan", "noise"])
def flows(request):
    prev, cur = _pairs(request.param)
    mp = pytest.MonkeyPatch()
    try:
        return {"port_bf16": _port_flow(prev, cur, True),
                "port_f32": _port_flow(prev, cur, False),
                "jax_bf16": _jax_flow(prev, cur, mp, True)}
    finally:
        mp.undo()


def test_port_bf16_matches_jax_bf16(flows):
    got, ref = flows["port_bf16"], flows["jax_bf16"]
    gm, _ = _stats(got)
    rm, _ = _stats(ref)
    np.testing.assert_allclose(gm, rm, rtol=1e-4)
    _study_bound(got, ref)


def test_port_bf16_within_the_study_bound_of_f32(flows):
    _study_bound(flows["port_bf16"], flows["port_f32"])
    assert not np.array_equal(flows["port_bf16"], flows["port_f32"])


def test_plain_warp_bf16_against_f32():
    rng = np.random.default_rng(3)
    src = torch.from_numpy(rng.random((2, 5, 80, 80)).astype(np.float32))
    fl = torch.from_numpy((rng.random((2, 2, 80, 80)).astype(np.float32)
                           - 0.5) * 6.0)
    before = (warp.LAUNCHES, dict(warp.DTYPE_LAUNCHES))
    f32 = warp.warp_bilinear(src, fl)
    bf = warp.warp_bilinear(src.bfloat16(), fl)
    assert (warp.LAUNCHES, warp.DTYPE_LAUNCHES) == before
    assert bf.dtype == torch.float32
    torch.testing.assert_close(bf, f32, atol=8e-3, rtol=8e-3)
    # the plain version widens, then runs as in float32
    assert torch.equal(bf, warp.warp_bilinear_plain(src.bfloat16().float(),
                                                    fl))


def test_plain_blur_solve_bf16_against_f32():
    rng = np.random.default_rng(4)
    shape = (2, 80, 80)
    g11 = rng.random(shape).astype(np.float32) + 1.0
    g22 = rng.random(shape).astype(np.float32) + 1.0
    g12 = (rng.random(shape).astype(np.float32) - 0.5) * 0.2
    h1 = (rng.random(shape).astype(np.float32) - 0.5) * 2.0
    h2 = (rng.random(shape).astype(np.float32) - 0.5) * 2.0
    m = torch.from_numpy(np.stack([g11, g12, g22, h1, h2], axis=1))
    before = (blur_solve.LAUNCHES, dict(blur_solve.DTYPE_LAUNCHES))
    f32 = blur_solve.box_blur_solve(m)
    bf = blur_solve.box_blur_solve(m.bfloat16())
    assert (blur_solve.LAUNCHES, blur_solve.DTYPE_LAUNCHES) == before
    assert bf.dtype == torch.float32
    torch.testing.assert_close(bf, f32, atol=2e-2, rtol=2e-2)
    assert torch.equal(bf, blur_solve.box_blur_solve_plain(
        m.bfloat16().float()))


def test_the_fused_round_ignores_flow_bf16():
    prev, cur = _pairs("pan", n=2, h=80, w=80)
    p, c = torch.from_numpy(prev), torch.from_numpy(cur)
    assert torch.equal(
        tflow.farneback_flow(p, c, fused_iter=True, flow_bf16=True),
        tflow.farneback_flow(p, c, fused_iter=True))


def test_update_matrices_widen_bf16_fields():
    """``_update_matrices`` on bf16 R0/R1 equals it on their f32 copies:
    the storage is half width, the arithmetic is not."""
    rng = np.random.default_rng(9)
    r0, r1 = (torch.from_numpy(rng.standard_normal((2, 5, 40, 48))
                               .astype(np.float32)).bfloat16()
              for _ in range(2))
    fl = torch.from_numpy((rng.random((2, 2, 40, 48)).astype(np.float32)
                           - 0.5) * 4.0)
    got = tflow._update_matrices(r0, r1, fl)
    assert got.dtype == torch.float32
    assert torch.equal(got, tflow._update_matrices(r0.float(), r1.float(),
                                                   fl))
