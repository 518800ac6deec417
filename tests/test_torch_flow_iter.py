"""The fused Farnebäck round of the port (plain version, CPU) against the
JAX package's Pallas kernel in interpret mode.

``solve_iteration_plain`` composes the port's plain warp, update and
blur+solve; it is held to ``avd_tpu.ops.pallas.flow_iter.solve_iteration``
at the shapes and the tolerance of tests/test_pallas_flow_iter.py (atol
5e-4, rtol 1e-3), and the whole ``farneback_flow(fused_iter=True)`` to the
JAX package's fused flow through the magnitude stats (mean rtol 1e-3,
variance rtol 1e-2).
"""

import os
from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avd_tpu.ops import flow as jflow
from avd_tpu.ops.pallas import flow_iter as jflow_iter
from avd_tpu_torch import config as tconfig
from avd_tpu_torch.ops import flow as tflow
from avd_tpu_torch.ops import video_features as tvf
from avd_tpu_torch.ops.kernels import blur_solve, warp
from avd_tpu_torch.ops.kernels import flow_iter as tflow_iter
from tests import fixtures

torch.set_num_threads(1)


def _fields(seed, b, h, w, flow_scale):
    """The fields of tests/test_pallas_flow_iter.py, as numpy."""
    from scipy.ndimage import uniform_filter
    rng = np.random.default_rng(seed)
    base0 = rng.random((b, h + 10, w + 10)).astype(np.float32) * 255
    base1 = np.roll(base0, (2, 3), axis=(1, 2))
    R0 = np.array(jflow.poly_expansion(jnp.asarray(base0[:, :h, :w]), 5, 1.2))
    R1 = np.array(jflow.poly_expansion(jnp.asarray(base1[:, :h, :w]), 5, 1.2))
    fl = (rng.random((b, 2, h, w)).astype(np.float32) - 0.5) * flow_scale
    fl = np.stack([[uniform_filter(p, 7) for p in fb]
                   for fb in fl]).astype(np.float32)
    return R0, R1, fl


def _both(R0, R1, fl):
    ref = np.asarray(jflow_iter.solve_iteration(
        jnp.asarray(R0), jnp.asarray(R1), jnp.asarray(fl), interpret=True))
    ours = tflow_iter.solve_iteration_plain(
        torch.from_numpy(R0), torch.from_numpy(R1), torch.from_numpy(fl))
    return ours.numpy(), ref


@pytest.mark.parametrize("shape,scale", [
    ((2, 80, 96), 2.0), ((1, 40, 128), 0.0), ((1, 120, 130), 6.0),
])
def test_plain_round_matches_the_pallas_kernel(shape, scale):
    b, h, w = shape
    ours, ref = _both(*_fields(0, b, h, w, scale))
    assert ours.shape == ref.shape == (b, 2, h, w)
    np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-3)


def test_large_uniform_pan():
    """Most pixels leave the image: the masked update must agree."""
    R0, R1, _ = _fields(1, 1, 80, 128, 0)
    fl = np.empty((1, 2, 80, 128), np.float32)
    fl[:, 0] = 61.0
    fl[:, 1] = 3.0
    ours, ref = _both(R0, R1, fl)
    np.testing.assert_allclose(ours, ref, atol=5e-4, rtol=1e-3)


def test_plain_round_is_the_unfused_sequence():
    """On the CPU the wrapper takes the plain version, which equals
    update → blur+solve of ``ops/flow.py`` bit for bit."""
    R0, R1, fl = (torch.from_numpy(x) for x in _fields(2, 2, 40, 56, 4.0))
    counts = (warp.LAUNCHES, blur_solve.LAUNCHES, tflow_iter.LAUNCHES)
    fused = tflow_iter.solve_iteration(R0, R1, fl)
    assert (warp.LAUNCHES, blur_solve.LAUNCHES,
            tflow_iter.LAUNCHES) == counts == (0, 0, 0)
    staged = tflow._blur_solve(tflow._update_matrices(R0, R1, fl), 15)
    assert torch.equal(fused, staged)
    assert torch.equal(fused, tflow_iter.solve_iteration_plain(R0, R1, fl))


def test_update_from_warped_is_update_matrices_after_the_warp():
    R0, R1, fl = (torch.from_numpy(x) for x in _fields(3, 1, 40, 48, 30.0))
    R1w = warp.warp_bilinear_plain(R1, fl)
    assert torch.equal(tflow.update_from_warped(R0, R1w, fl),
                       tflow._update_matrices(R0, R1, fl))


def _tile_walk(R0, R1, fl, th, plant_nan=False):
    """Plain-torch model of ``csrc/flow_iter.cu``'s indexing: per 32×th
    output tile from (y0, x0), M at the staged positions (rows y0 − 7 …,
    columns x0 − 8 … x0 + 39, clamped into the image); row sums as
    ``blur.cuh`` forms them, from the 24-word register window at staged
    column 8·g for the outputs 8·g + o, o < 8, as window words o + 1 …
    o + 15; column sums over th + 14 rows, × 1/225, then the solve; each
    sum left to right, as the kernel adds.  With ``plant_nan`` the staged
    columns 0 and 47, which the kernel reads into the windows but never
    writes, hold NaN."""
    B, _, H, W = R0.shape
    M = tflow.update_from_warped(R0, warp.warp_bilinear_plain(R1, fl), fl)
    nty, ntx = -(-H // th), -(-W // 32)
    rows = (torch.arange(nty)[:, None] * th - 7
            + torch.arange(th + 14)).clamp(0, H - 1)
    cols = (torch.arange(ntx)[:, None] * 32 - 8
            + torch.arange(48)).clamp(0, W - 1)
    # s[b, c, tile row, tile column, staged row, staged column]
    s = M[:, :, rows[:, None, :, None], cols[None, :, None, :]].clone()
    if plant_nan:
        s[..., 0] = float("nan")
        s[..., 47] = float("nan")
    # window[..., g, k] = staged column 8·g + k, k < 24
    win = s[..., torch.arange(4)[:, None] * 8 + torch.arange(24)]
    hs = win[..., 1:9]
    for j in range(2, 16):
        hs = hs + win[..., j:j + 8]
    hs = hs.flatten(-2)  # output column 8·g + o
    vs = hs[..., 0:th, :]
    for j in range(1, 15):
        vs = vs + hs[..., j:j + th, :]
    mean = (vs * (1.0 / 225)).permute(0, 1, 2, 4, 3, 5).reshape(
        B, 5, nty * th, ntx * 32)
    return blur_solve.solve_flow(mean)[..., :H, :W]


def _random_round(seed, b, h, w, scale):
    rng = np.random.default_rng(seed)
    R0, R1 = (torch.from_numpy(rng.standard_normal((b, 5, h, w))
                               .astype(np.float32)) for _ in range(2))
    fl = torch.from_numpy(((rng.random((b, 2, h, w)) - 0.5) * scale)
                          .astype(np.float32))
    return R0, R1, fl


@pytest.mark.parametrize("th", [80, 8])
@pytest.mark.parametrize("shape,scale", [
    ((1, 16, 16), 3.0), ((3, 37, 53), 0.0), ((2, 17, 300), 3.0),
    ((1, 96, 33), 40.0), ((2, 100, 150), 3.0), ((3, 40, 40), 40.0),
    ((1, 161, 81), 3.0),
])
def test_kernel_tile_walk_equals_the_plain_round(th, shape, scale):
    """The kernel's tiles, halo origin, register windows and order of sums
    reproduce the plain round bit for bit at ragged shapes, for the
    kernel's two tile heights (80 and 8)."""
    R0, R1, fl = _random_round(4, *shape, scale)
    assert torch.equal(_tile_walk(R0, R1, fl, th),
                       tflow_iter.solve_iteration_plain(R0, R1, fl))


@pytest.mark.parametrize("th", [80, 8])
def test_tile_walk_never_adds_staged_columns_0_and_47(th):
    """NaN in the staged columns that the register windows read but that
    the kernel never writes (0 and 47) never reaches the model's output:
    the window indices o + 1 … o + 15 leave the windows' first and last
    words out.  This checks the model, a copy of blur.cuh's indexing; the
    kernel itself is checked on the card by
    ``test_flow_iter_kernel_never_adds_the_unwritten_staged_columns``."""
    R0, R1, fl = _random_round(5, 2, 45, 70, 3.0)
    out = _tile_walk(R0, R1, fl, th, plant_nan=True)
    assert torch.isfinite(out).all()
    assert torch.equal(out, tflow_iter.solve_iteration_plain(R0, R1, fl))


@pytest.mark.parametrize("h,w", [(15, 64), (64, 8)])
def test_levels_under_16_px_raise(h, w):
    R = torch.zeros((1, 5, h, w))
    with pytest.raises(ValueError, match="H, W >= 16"):
        tflow_iter.solve_iteration(R, R, torch.zeros((1, 2, h, w)))


def test_wrong_shapes_raise():
    R = torch.zeros((1, 5, 32, 32))
    with pytest.raises(ValueError, match="shapes"):
        tflow_iter.solve_iteration(R, R, torch.zeros((1, 2, 32, 31)))
    with pytest.raises(ValueError, match="shapes"):
        tflow_iter.solve_iteration(R[:, :4], R[:, :4],
                                   torch.zeros((1, 2, 32, 32)))


def _moving_pair():
    """The 160² moving pair of tests/test_pallas_flow_iter.py."""
    import cv2
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (200, 220)).astype(np.float32)
    base = cv2.GaussianBlur(base, (0, 0), 2)
    return base[:160, :160][None], base[3:163, 2:162][None]


def test_fused_farneback_matches_the_fused_avd_tpu_flow():
    prev, cur = _moving_pair()
    orig = jflow_iter.solve_iteration_prepared
    os.environ["AVD_PALLAS_ITER"] = "1"
    jflow._pallas_iter_enabled.cache_clear()
    try:
        with mock.patch.object(
                jflow_iter, "solve_iteration_prepared",
                lambda r0p, r1p, f, width, winsize=15: orig(
                    r0p, r1p, f, width=width, winsize=winsize,
                    interpret=True)):
            ref = jflow.farneback_flow(jnp.asarray(prev), jnp.asarray(cur))
    finally:
        del os.environ["AVD_PALLAS_ITER"]
        jflow._pallas_iter_enabled.cache_clear()
    m_ref, v_ref = (np.asarray(x) for x in jflow.flow_magnitude_stats(ref))
    ours = tflow.farneback_flow(torch.from_numpy(prev),
                                torch.from_numpy(cur), fused_iter=True)
    assert tuple(ours.shape) == (1, 160, 160, 2)
    m, v = (x.numpy() for x in tflow.flow_magnitude_stats(ours))
    np.testing.assert_allclose(m, m_ref, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(v, v_ref, rtol=1e-2, atol=1e-4)
    unfused = tflow.farneback_flow(torch.from_numpy(prev),
                                   torch.from_numpy(cur))
    assert torch.equal(ours, unfused)  # the same plain arithmetic


@pytest.mark.parametrize("setting,calls", [("1", 4 * 3), ("0", 0), (None, 0)])
def test_avd_pallas_iter_selects_the_fused_round(monkeypatch, setting,
                                                 calls):
    """``AVD_PALLAS_ITER=1`` reaches ``farneback_flow`` through the config:
    one ``solve_iteration`` per round and level (the 320² flow planes
    have four levels), with the features unchanged; off by default."""
    if setting is None:
        monkeypatch.delenv("AVD_PALLAS_ITER", raising=False)
    else:
        monkeypatch.setenv("AVD_PALLAS_ITER", setting)
    tconfig.reset_config()
    frames = fixtures.noise_clip(6, 64)
    seen = []
    real = tflow_iter.solve_iteration

    def spy(*args, **kw):
        seen.append(1)
        return real(*args, **kw)

    try:
        monkeypatch.setattr(tflow.flow_iter_k, "solve_iteration", spy)
        feats = tvf.compute_features(frames, device="cpu")
    finally:
        monkeypatch.undo()
        tconfig.reset_config()
    assert len(seen) == calls
    base = tvf.compute_features(frames, device="cpu")
    assert feats["flow_means"] == base["flow_means"]
    assert feats["flow_vars"] == base["flow_vars"]
