"""The port's streaming file path (``analyzers/video._analyze_streaming``,
``ops/video_features.compute_features_streaming``) against its batch path
and against ``avd_tpu``: the cases of tests/test_streaming.py (the
TPU-tunnel encodings ``AVD_H2D_DELTA`` are not ported), at its tolerances
(tests/test_streaming.py:45-48: ``dup_density`` equal, the timeline within
atol 1e-6), and with the detector on at several ``AVD_DETECTOR_SLAB``:
``_DetAccum`` gives the batch path's detector timeline.
"""

import numpy as np
import pytest
import torch

from avd_tpu.analyzers import video as jvideo
from avd_tpu.models import scoring as jscoring
from avd_tpu_torch import config
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.ingest import probe, video_reader
from avd_tpu_torch.models import scoring
from avd_tpu_torch.ops import video_features
from tests import fixtures

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """90 frames at 30 fps → 6 sampled: spliced static/noise halves."""
    d = tmp_path_factory.mktemp("stream")
    path = fixtures.write_video(d / "sp.mp4", fixtures.spliced_clip(90, 64),
                                fps=30.0)
    return path, probe.probe_basic_meta(path)


@pytest.fixture
def env(monkeypatch):
    for name in ("AVD_STREAM", "AVD_DETECTOR", "AVD_DETECTOR_SLAB",
                 "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_BACKEND",
                 "AVD_FAST_SEEK"):
        monkeypatch.delenv(name, raising=False)
    config.reset_config()
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()
    yield monkeypatch
    config.reset_config()
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()


def test_streaming_matches_batch(tmp_path):
    path = fixtures.write_video(tmp_path / "s.mp4",
                                fixtures.noise_clip(120, 64), fps=30.0)
    meta = probe.probe_basic_meta(path)
    fb = video_reader.read_sampled(path, meta)
    batch = video_features.compute_features(fb.frames, device="cpu")
    stream = video_features.compute_features_streaming(
        (c.frames for c in video_reader.iter_sampled_chunks(path, meta,
                                                            chunk=3)),
        device="cpu")
    assert stream["total"] == batch["total"] == 8
    assert stream["dup"] == batch["dup"]
    np.testing.assert_allclose(stream["textures"], batch["textures"],
                               rtol=1e-6)
    np.testing.assert_allclose(stream["flow_means"], batch["flow_means"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stream["timeline_ai"], batch["timeline_ai"],
                               atol=1e-6)


def _stream_and_batch(env, path, meta):
    env.setenv("AVD_STREAM", "1")
    out_stream = video_an.analyze(path, meta, device="cpu")
    env.setenv("AVD_STREAM", "0")
    out_batch = video_an.analyze(path, meta, device="cpu")
    assert out_stream["summary"]["dup_density"] == \
        out_batch["summary"]["dup_density"]
    np.testing.assert_allclose(out_stream["timeline"], out_batch["timeline"],
                               atol=1e-6)
    assert out_stream["timeline"] is out_stream["timeline_ai"]
    return out_stream, out_batch


def test_streaming_analyzer_end_to_end(env, clip):
    path, meta = clip
    out_stream, _ = _stream_and_batch(env, path, meta)
    env.setenv("AVD_STREAM", "1")
    ref = jvideo.analyze(path, meta)
    assert out_stream["summary"]["dup_density"] == \
        ref["summary"]["dup_density"] == 0.4
    np.testing.assert_allclose(out_stream["timeline"], ref["timeline"],
                               atol=1e-3)


@pytest.mark.parametrize("slab", ["1", "2", "4", "256"])
def test_streaming_detector_equals_batch(env, clip, slab):
    """``_DetAccum`` scores 32-frame chunks in slabs of ``slab`` frames;
    the ViT scores each frame alone, so the timeline is the batch path's
    (one bucket) up to the bf16 products of other batch sizes."""
    path, meta = clip
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_PRESET", "small")
    env.setenv("AVD_DETECTOR_SLAB", slab)
    calls = []
    real = scoring.detector_timeline_resized

    def spy(resized, device=None):
        calls.append(resized.shape[0])
        return real(resized, device=device)

    env.setattr(scoring, "detector_timeline_resized", spy)
    out_stream, out_batch = _stream_and_batch(env, path, meta)
    # 6 sampled frames arrive as one chunk: flushed once full or at the end
    assert calls == [6]
    d, e = out_stream["detector"], out_batch["detector"]
    assert "detector_error" not in out_stream
    assert d["weights"] == e["weights"] and d["weights"].endswith(
        "detector_small+T1.00")
    assert len(d["timeline"]) == 6
    np.testing.assert_allclose(d["timeline"], e["timeline"], atol=2e-2)


@pytest.mark.parametrize("slab", [5, 16, 64])
def test_det_accum_flushes_mid_stream(env, slab):
    """Chunks of 32 frames through ``_DetAccum``: slabs flush as they
    fill, and the concatenated timeline equals scoring the whole batch."""
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_PRESET", "small")
    env.setenv("AVD_DETECTOR_SLAB", str(slab))
    frames = np.random.default_rng(2).integers(0, 256, (70, 48, 80, 3),
                                               dtype=np.uint8)
    flushed = []
    real = scoring.detector_timeline_resized

    def spy(resized, device=None):
        flushed.append(resized.shape[0])
        return real(resized, device=device)

    env.setattr(scoring, "detector_timeline_resized", spy)
    acc = video_an._DetAccum("cpu")
    for i in range(0, 70, 32):
        acc.add(frames[i:i + 32])
    got = acc.result()
    want = {5: [32, 32, 6], 16: [32, 32, 6], 64: [64, 6]}[slab]
    assert flushed == want
    env.setattr(scoring, "detector_timeline_resized", real)
    ref = scoring.detector_timeline(frames, device="cpu")
    assert got["weights"] == ref["weights"]
    np.testing.assert_allclose(got["timeline"], ref["timeline"], atol=2e-2)
    assert scoring.clip_window("cpu") is None


def test_det_accum_reports_a_detector_failure(env, clip):
    path, meta = clip
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_EXPORTED", "/nowhere/exported")  # not ported
    out = video_an.analyze(path, meta, device="cpu")
    assert out["detector_error"] == "NotImplementedError"
    assert "detector" not in out and out["timeline"] is out["timeline_ai"]


def test_a_streaming_failure_restarts_on_the_batch_path(env, clip):
    """As avd_tpu (video.py:149-156): a failure mid-stream restarts on the
    batch path, on the same device; a second failure propagates (and
    becomes hints.video_error in analyze_path)."""
    path, meta = clip
    env.setenv("AVD_STREAM", "1")
    real = video_features.compute_features_streaming
    calls = []

    def fails_once(chunks, device=None, batcher=None):
        calls.append(device)
        if len(calls) == 1:
            raise RuntimeError("kernel failed to launch")
        return real(chunks, device=device, batcher=batcher)

    env.setattr(video_features, "compute_features_streaming", fails_once)
    out = video_an.analyze(path, meta, device="cpu")
    assert calls == [torch.device("cpu")] * 2
    env.setattr(video_features, "compute_features_streaming", real)
    env.setenv("AVD_STREAM", "0")
    assert out == video_an.analyze(path, meta, device="cpu")

    def always_fails(chunks, device=None):
        raise RuntimeError("kernel failed to launch")

    env.setattr(video_features, "compute_features_streaming", always_fails)
    env.setenv("AVD_STREAM", "1")
    with pytest.raises(RuntimeError, match="failed to launch"):
        video_an.analyze(path, meta, device="cpu")


def test_fast_seek_matches_walk(tmp_path, env):
    path = fixtures.write_video(tmp_path / "f.mp4",
                                fixtures.gradient_clip(120, 64), fps=30.0)
    meta = probe.probe_basic_meta(path)
    env.setenv("AVD_NATIVE_DECODE", "0")
    walk = np.concatenate([c.frames for c in
                           video_reader.iter_sampled_chunks(path, meta)])
    env.setenv("AVD_FAST_SEEK", "1")
    seek = np.concatenate([c.frames for c in
                           video_reader.iter_sampled_chunks(path, meta)])
    np.testing.assert_array_equal(walk, seek)
    assert walk.shape[0] == 8


def test_streaming_empty_file(env):
    env.setenv("AVD_STREAM", "1")
    out = video_an.analyze("/nonexistent.mp4", {}, device="cpu")
    assert out == {"timeline": [], "summary": {}, "timeline_ai": []}
    assert out == jvideo.analyze("/nonexistent.mp4", {})
