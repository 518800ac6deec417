"""Farnebäck flow: the port (plain kernel versions on the CPU) against
``avd_tpu.ops.flow``.

Polynomial expansion and the normal-equation update hold atol 1e-5; the
full solver is compared through the flow-magnitude stats that the
pipeline consumes (mean rtol 1e-4, variance rtol 1e-3, the bounds of
tests/test_pallas_blur_solve.py), because the near-singular 2×2 solves
amplify last-bit differences at single pixels.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avd_tpu.ops import flow as jflow
from avd_tpu_torch.ops import flow as tflow

torch.set_num_threads(1)


def _smooth_image(seed, h, w):
    """Gaussian-smoothed u8 noise as float32 (the real planes are u8)."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w)).astype(np.float64)
    return np.round(gaussian_filter(base, 2.0)).astype(np.float32)


@pytest.mark.parametrize("h,w", [(40, 40), (80, 96), (37, 53)])
def test_poly_expansion(h, w):
    img = np.stack([_smooth_image(s, h, w) for s in (0, 1)]) / 255.0
    ours = tflow.poly_expansion(torch.from_numpy(img), 5, 1.2).numpy()
    ref = np.asarray(jflow.poly_expansion(jnp.asarray(img), 5, 1.2))
    assert ours.shape == ref.shape == (2, 5, h, w)
    np.testing.assert_allclose(ours, ref, atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 4.0, 30.0])
def test_update_matrices(scale):
    rng = np.random.default_rng(3)
    h, w = 40, 56
    img0 = np.stack([_smooth_image(s, h, w) for s in (2, 3)]) / 255.0
    img1 = np.stack([_smooth_image(s, h, w) for s in (4, 5)]) / 255.0
    r0 = np.array(jflow.poly_expansion(jnp.asarray(img0), 5, 1.2))
    r1 = np.array(jflow.poly_expansion(jnp.asarray(img1), 5, 1.2))
    fl = ((rng.random((2, 2, h, w)) - 0.5) * scale).astype(np.float32)
    ref = np.asarray(jflow._update_matrices(jnp.asarray(r0), jnp.asarray(r1),
                                            jnp.asarray(fl)))
    ours = tflow._update_matrices(torch.from_numpy(r0), torch.from_numpy(r1),
                                  torch.from_numpy(fl)).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5)


def _moving_pair():
    """The 160² moving pair of tests/test_pallas_blur_solve.py."""
    rng = np.random.default_rng(2)
    base = rng.integers(0, 256, (200, 220)).astype(np.float32)
    try:
        import cv2
        base = cv2.GaussianBlur(base, (0, 0), 2)
    except ImportError:
        pass
    return base[:160, :160][None], base[3:163, 2:162][None]


def test_farneback_flow_stats():
    prev, cur = _moving_pair()
    ref = jflow.farneback_flow(jnp.asarray(prev), jnp.asarray(cur))
    m_ref, v_ref = (np.asarray(x) for x in jflow.flow_magnitude_stats(ref))
    ours = tflow.farneback_flow(torch.from_numpy(prev),
                                torch.from_numpy(cur))
    assert tuple(ours.shape) == (1, 160, 160, 2)
    m, v = (x.numpy() for x in tflow.flow_magnitude_stats(ours))
    np.testing.assert_allclose(m, m_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(v, v_ref, rtol=1e-3, atol=1e-5)
    # cur is prev moved by (-2, -3) px: the recovered flow, mid-frame
    mid = ours[0, 40:120, 40:120].numpy().reshape(-1, 2).mean(axis=0)
    np.testing.assert_allclose(mid, [-2.0, -3.0], atol=0.1)


def test_solve_flow():
    rng = np.random.default_rng(6)
    m = rng.normal(size=(2, 5, 16, 24)).astype(np.float32)
    m[:, 0] = np.abs(m[:, 0]) + 1.0
    m[:, 2] = np.abs(m[:, 2]) + 1.0
    m[:, 1] *= 0.3
    ref = np.asarray(jflow._solve_flow(jnp.asarray(m)))
    ours = tflow._solve_flow(torch.from_numpy(m)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_flow_magnitude_stats():
    rng = np.random.default_rng(4)
    fl = rng.normal(size=(3, 20, 24, 2)).astype(np.float32)
    m_ref, v_ref = jflow.flow_magnitude_stats(jnp.asarray(fl))
    m, v = tflow.flow_magnitude_stats(torch.from_numpy(fl))
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), rtol=1e-6)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=1e-5)
