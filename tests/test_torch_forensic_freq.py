"""Frequency forensics (``AVD_FREQ_FORENSICS=1``) of the port.

``dct8_matrix`` against scipy's orthonormal DCT-II (atol 1e-5); every
per-frame statistic and ``summarize`` against ``avd_tpu``'s on the same
gray frames (rtol 1e-4); ``summary["freq"]`` attached by
``analyze_batch`` only when the switch is on.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avd_tpu.ops import forensic_freq as jff
from avd_tpu_torch import config
from avd_tpu_torch.analyzers import video as tvideo
from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.ops import forensic_freq as tff
from avd_tpu_torch.ops import host_prep
from tests import fixtures

torch.set_num_threads(1)


def _gray(seed=0, n=3, h=67, w=91):
    """Blocky frames (8×8 constant blocks plus noise) and plain noise."""
    rng = np.random.default_rng(seed)
    blocks = rng.integers(0, 256, (n, h // 8 + 1, w // 8 + 1))
    blocky = np.kron(blocks, np.ones((1, 8, 8)))[:, :h, :w]
    noise = rng.normal(0.0, 6.0, (n, h, w))
    return np.clip(blocky + noise, 0, 255).astype(np.uint8)


def test_dct8_matrix_against_scipy():
    fft = pytest.importorskip("scipy.fft")
    ref = fft.dct(np.eye(8), norm="ortho", axis=0)
    np.testing.assert_allclose(tff.dct8_matrix(), ref, atol=1e-5)
    np.testing.assert_array_equal(tff.dct8_matrix(), jff.dct8_matrix())


_STATS = {
    "block_dct_stats": (jff.block_dct_stats, tff.block_dct_stats),
    "blockiness": (jff.blockiness, tff.blockiness),
    "noise_residual_stats": (jff.noise_residual_stats,
                             tff.noise_residual_stats),
}


@pytest.mark.parametrize("name", sorted(_STATS))
@pytest.mark.parametrize("shape", [(3, 67, 91), (2, 64, 64), (2, 9, 17)])
def test_each_stat_matches_jax(name, shape):
    gray = _gray(sum(shape), *shape).astype(np.float32)
    jfn, tfn = _STATS[name]
    ref = jfn(jnp.asarray(gray))
    got = tfn(torch.from_numpy(gray))
    if not isinstance(ref, dict):
        ref, got = {name: ref}, {name: got}
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_summarize_matches_jax():
    gray = np.concatenate([_gray(1, n=20, h=40, w=48),
                           fixtures.noise_clip(4, 48)[:, :40, :, 0]])
    ref = jff.summarize(gray)
    got = tff.summarize(gray, device="cpu")  # 24 frames: two passes
    assert set(got) == set(ref)
    for k in ref:
        assert isinstance(got[k], float)
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=k)


@pytest.mark.parametrize("enabled", [False, True])
def test_analyze_batch_attaches_freq_only_when_enabled(monkeypatch,
                                                       enabled):
    frames = fixtures.noise_clip(4, 64)
    fb = video_reader.FrameBatch(frames, 4, 30.0, 64, 64, 1.0)
    monkeypatch.setenv("AVD_FREQ_FORENSICS", "1" if enabled else "0")
    config.reset_config()
    try:
        out = tvideo.analyze_batch(fb, device="cpu")
    finally:
        monkeypatch.delenv("AVD_FREQ_FORENSICS")
        config.reset_config()
    assert ("freq" in out["summary"]) == enabled
    if enabled:
        ref = jff.summarize(host_prep.to_gray(frames))
        for k in ref:
            np.testing.assert_allclose(out["summary"]["freq"][k], ref[k],
                                       rtol=1e-4, err_msg=k)
