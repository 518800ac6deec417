"""Cross-request micro-batching in the port (``avd_tpu_torch.serve.
batching``) and the stacked host-prep windows behind it
(``ops/video_features.run_prep_windows``): the cases of
tests/test_batching.py on ``device="cpu"``, the stack held to the port's
per-window calls (rtol 2e-5 / atol 1e-5, tests/test_batching.py:52) and to
``avd_tpu``'s ``run_prep_window`` (Hamming exact, flow mean rtol 1e-4,
variance rtol 1e-3, tests/test_pallas_blur_solve.py:108-111), pairs formed
inside each window only, and the streaming path through the batcher."""

import concurrent.futures
import threading

import numpy as np
import pytest
import torch

from avd_tpu import config as jconfig
from avd_tpu.ops import video_features as jvf
from avd_tpu_torch import config as config_mod
from avd_tpu_torch.ops import video_features
from avd_tpu_torch.serve import batching

torch.set_num_threads(2)

CPU = torch.device("cpu")


@pytest.fixture
def batch_env(monkeypatch):
    monkeypatch.setenv("AVD_BATCH_WINDOW_MS", "150")
    config_mod.reset_config()
    batching.reset_active()
    yield monkeypatch
    batching.reset_active()
    monkeypatch.delenv("AVD_BATCH_WINDOW_MS", raising=False)
    config_mod.reset_config()


def _no_batching(monkeypatch):
    monkeypatch.setenv("AVD_BATCH_WINDOW_MS", "0")
    config_mod.reset_config()
    batching.reset_active()


def _batching(monkeypatch):
    monkeypatch.setenv("AVD_BATCH_WINDOW_MS", "150")
    config_mod.reset_config()
    batching.reset_active()
    b = batching.active_batcher()
    assert b is not None
    return b


def _prep_pairs(seed, count, n=5):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 256, (n, 320, 320), dtype=np.int64)
             .astype(np.uint8),
             rng.integers(0, 256, (n, 32, 32), dtype=np.int64)
             .astype(np.uint8)) for _ in range(count)]


def _stream(frames, batcher=None):
    return video_features.compute_features_streaming(
        (frames[i:i + 3] for i in range(0, len(frames), 3)), device="cpu",
        batcher=batcher)


def test_concurrent_requests_fuse(batch_env):
    """Concurrent full-chunk host-prep windows (the serving default) fuse
    into one stacked device call."""
    batch_env.setattr(video_features, "_DEFAULT_CHUNK", 4)  # full n = 5
    b = batching.active_batcher()
    pairs = _prep_pairs(7, 4)
    barrier = threading.Barrier(4)

    def client(i):
        barrier.wait()
        return b.submit_prep(*pairs[i], device=CPU).result(timeout=120)

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as pool:
        results = list(pool.map(client, range(4)))
    assert len(results) == 4
    assert b.fused_jobs >= 2, (b.batches_formed, b.fused_jobs)
    assert b.jobs_in == 4


def test_prep_jobs_fuse_and_match(batch_env):
    batch_env.setattr(video_features, "_DEFAULT_CHUNK", 4)  # full n = 5
    pairs = _prep_pairs(0, 3)
    _no_batching(batch_env)
    plain = [video_features.run_prep_window(x, y, CPU).numpy()
             for x, y in pairs]
    b = _batching(batch_env)
    fused = [f.result(timeout=120) for f in
             [b.submit_prep(x, y, device=CPU) for x, y in pairs]]
    for p, q in zip(plain, fused):
        np.testing.assert_allclose(p, q, rtol=2e-5, atol=1e-5)
    assert b.fused_jobs >= 2


def test_tail_windows_do_not_fuse(batch_env):
    n = 5
    assert n != video_features._DEFAULT_CHUNK + 1
    pairs = _prep_pairs(1, 3, n)
    plain = [video_features.run_prep_window(x, y, CPU).numpy()
             for x, y in pairs]
    b = batching.active_batcher()
    fused = [f.result(timeout=120) for f in
             [b.submit_prep(x, y, device=CPU) for x, y in pairs]]
    for p, q in zip(plain, fused):
        np.testing.assert_allclose(p, q, rtol=2e-5, atol=1e-5)
    assert b.fused_jobs == 0  # every tail job ran solo


def test_disabled_returns_none(monkeypatch):
    _no_batching(monkeypatch)
    assert batching.active_batcher() is None
    config_mod.reset_config()


# ---------------------------------------------------------------------------
# the stacked windows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stack():
    """m = 3 windows of n = 5 host-prep frames."""
    rng = np.random.default_rng(3)
    w320 = rng.integers(0, 256, (3, 5, 320, 320), dtype=np.int64) \
        .astype(np.uint8)
    w32 = rng.integers(0, 256, (3, 5, 32, 32), dtype=np.int64) \
        .astype(np.uint8)
    return w320, w32, video_features.run_prep_windows(w320, w32, CPU)


def test_stacked_windows_match_the_per_window_calls(stack):
    w320, w32, out = stack
    assert out.shape == (3, 12) and out.dtype == torch.float32
    for i in range(3):
        one = video_features.run_prep_window(w320[i], w32[i], CPU)
        np.testing.assert_allclose(out[i].numpy(), one.numpy(), rtol=2e-5,
                                   atol=1e-5)


def test_stacked_windows_match_avd_tpu(stack, monkeypatch):
    monkeypatch.delenv("AVD_BATCH_WINDOW_MS", raising=False)
    jconfig.reset_config()
    w320, w32, out = stack
    k = 4
    for i in range(3):
        ham, fmean, fvar = jvf.run_prep_window(w320[i], w32[i])
        np.testing.assert_array_equal(out[i, :k].numpy(), ham)
        np.testing.assert_allclose(out[i, k:2 * k].numpy(), fmean,
                                   rtol=1e-4)
        np.testing.assert_allclose(out[i, 2 * k:].numpy(), fvar, rtol=1e-3)
    jconfig.reset_config()


def test_pairs_stay_inside_each_window():
    """Two windows of static frames whose last and first frames differ
    sharply: stacked, every pair is still static (Hamming 0, flow under
    1e-3 px; 2.6e-4 measured), as per window; pairing across the windows'
    border would show the cut (Hamming 529, flow 7.5 px)."""
    rng = np.random.default_rng(4)
    planes = [np.repeat(rng.integers(0, 256, (1, 320, 320), dtype=np.int64)
                        .astype(np.uint8), 5, axis=0) for _ in range(2)]
    hashes = [np.ascontiguousarray(p[:, ::10, ::10]) for p in planes]
    w320, w32 = np.stack(planes), np.stack(hashes)
    out = video_features.run_prep_windows(w320, w32, CPU).numpy()
    for i in range(2):
        one = video_features.run_prep_window(planes[i], hashes[i],
                                             CPU).numpy()
        np.testing.assert_array_equal(out[i], one)
    np.testing.assert_array_equal(out[:, :4], 0.0)
    assert out[:, 4:8].max() < 1e-3
    cross = video_features.run_prep_window(
        np.concatenate([planes[0][-1:], planes[1][:1]]),
        np.concatenate([hashes[0][-1:], hashes[1][:1]]), CPU).numpy()
    assert cross[0] > 100 and cross[1] > 1.0  # what a wrong pairing reads


def test_streaming_through_the_batcher_matches(batch_env, monkeypatch):
    """``compute_features_streaming`` with the batcher on: the same
    features as without it; concurrent clips share stacked calls."""
    monkeypatch.setattr(video_features, "_DEFAULT_CHUNK", 4)
    rng = np.random.default_rng(5)
    clips = [rng.integers(0, 256, (10, 48, 64, 3), dtype=np.int64)
             .astype(np.uint8) for _ in range(3)]

    _no_batching(batch_env)
    plain = [_stream(c) for c in clips]
    b = _batching(batch_env)
    with concurrent.futures.ThreadPoolExecutor(max_workers=3) as pool:
        batched = list(pool.map(lambda c: _stream(c, b), clips))
    for p, q in zip(plain, batched):
        assert p.keys() == q.keys() and p["dup"] == q["dup"]
        assert p["textures"] == q["textures"]
        np.testing.assert_allclose(q["flow_means"], p["flow_means"],
                                   rtol=2e-5, atol=1e-5)
        np.testing.assert_allclose(q["flow_vars"], p["flow_vars"],
                                   rtol=2e-5, atol=1e-5)
    assert b.jobs_in == 9  # two full windows and a tail a clip
    assert b.fused_jobs >= 2


def test_jobs_are_keyed_by_their_pinned_device(batch_env):
    batch_env.setattr(video_features, "_DEFAULT_CHUNK", 4)
    b = batching.active_batcher()
    w320, w32 = _prep_pairs(9, 1)[0]
    f = b.submit_prep(w320, w32, device="cpu")
    f.result(timeout=120)
    assert list(b._threads) == [("prep", 5, CPU)]
    batch_env.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        b.submit_prep(w320, w32, device=None)
