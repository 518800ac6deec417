"""The port's blur+solve (plain version on the CPU) against the TPU kernel.

``avd_tpu.ops.pallas.blur_solve.box_blur_solve`` runs in interpret mode.
Random M fields make the 2×2 solve nearly singular at scattered pixels, so
the general cases use positive-semidefinite G entries at atol 2e-4 /
rtol 1e-3, and the well-conditioned and constant cases hold 1e-6 (the
cases of tests/test_pallas_blur_solve.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avd_tpu.ops.pallas import blur_solve as pblur
from avd_tpu_torch.ops.kernels import blur_solve as tblur

torch.set_num_threads(1)


def _psd_case(seed, b, h, w):
    rng = np.random.default_rng(seed)
    r4, r5, r6, h1, h2 = (rng.normal(size=(b, h, w)).astype(np.float32)
                          for _ in range(5))
    g11 = r4 * r4 + r6 * r6
    g12 = (r4 + r5) * r6
    g22 = r5 * r5 + r6 * r6
    return np.stack([g11, g12, g22, h1, h2], axis=1)


def _both(m):
    ref = np.asarray(pblur.box_blur_solve(jnp.asarray(m), interpret=True))
    ours = tblur.box_blur_solve(torch.from_numpy(m)).numpy()
    assert ours.shape == ref.shape == (m.shape[0], 2) + m.shape[2:]
    return ours, ref


@pytest.mark.parametrize("shape", [(2, 80, 96), (1, 40, 128), (1, 120, 130)])
def test_matches_tpu_blur_solve(shape):
    ours, ref = _both(_psd_case(0, *shape))
    np.testing.assert_allclose(ours, ref, atol=2e-4, rtol=1e-3)


def test_well_conditioned():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(1, 5, 80, 96)).astype(np.float32)
    m[:, 0] = 2.0
    m[:, 1] = 0.0
    m[:, 2] = 3.0
    ours, ref = _both(m)
    np.testing.assert_allclose(ours, ref, atol=1e-6)


def test_replicate_edges():
    m = np.zeros((1, 5, 40, 136), np.float32)
    m[:, 0] = 4.0
    m[:, 2] = 4.0
    m[:, 3] = 2.0
    m[:, 4] = -2.0
    ours, ref = _both(m)
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(ours[:, 0], 2.0 * 4.0 / (16.0 + 1e-3),
                               atol=1e-6)


def test_box_mean_is_the_replicate_edge_mean():
    """The plain box mean against a float64 numpy replicate-pad mean, at a
    size smaller than the window (every tap clamps)."""
    rng = np.random.default_rng(5)
    m = rng.random((1, 5, 9, 11)).astype(np.float32)
    p = np.pad(m.astype(np.float64), ((0, 0), (0, 0), (7, 7), (7, 7)),
               mode="edge")
    ref = np.zeros_like(m, np.float64)
    for dy in range(15):
        for dx in range(15):
            ref += p[:, :, dy:dy + 9, dx:dx + 11]
    ours = tblur.box_blur_mean(torch.from_numpy(m), 15).numpy()
    np.testing.assert_allclose(ours, ref / 225.0, rtol=1e-6)


def _well_conditioned_case(seed, b, h, w):
    m = np.random.default_rng(seed).normal(size=(b, 5, h, w)).astype(
        np.float32)
    m[:, 0], m[:, 1], m[:, 2] = 2.0, 0.0, 3.0
    return m


def _constant_case(seed, b, h, w):
    m = np.zeros((b, 5, h, w), np.float32)
    m[:, 0], m[:, 2], m[:, 3], m[:, 4] = 4.0, 4.0, 2.0, -2.0
    return m


@pytest.mark.parametrize("case,shape,atol,rtol", [
    (_psd_case, (2, 80, 96), 2e-4, 1e-3),
    (_psd_case, (1, 40, 128), 2e-4, 1e-3),
    (_psd_case, (1, 120, 130), 2e-4, 1e-3),
    (_well_conditioned_case, (1, 80, 96), 1e-6, 0.0),
    (_constant_case, (1, 40, 136), 1e-6, 0.0),
])
def test_bf16_m_matches_tpu_blur_solve(case, shape, atol, rtol):
    """bf16 M (``AVD_FLOW_BF16``), the same values on both sides: the
    port's plain version widens it as the TPU kernel does, at the
    reference tests' tolerances."""
    mb = torch.from_numpy(case(0 if case is _psd_case else 1, *shape)
                          ).bfloat16()
    ref = np.asarray(pblur.box_blur_solve(
        jnp.asarray(mb.float().numpy()).astype(jnp.bfloat16),
        interpret=True))
    ours = tblur.box_blur_solve(mb)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, atol=atol, rtol=rtol)
