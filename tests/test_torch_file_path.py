"""The file path: ``avd_tpu_torch.pipeline.analyze_path`` against
``avd_tpu.pipeline.analyze_path`` on the same files.

Files: the four corpus mp4s (tests/data/corpus_v1), a fixture clip, the
same clip with a muxed AAC track, and a 16 kHz WAV.  Both packages probe,
decode and analyze each on the CPU here (libav* and cv2 are installed);
the envelopes must have the same keys in the same order, the same
``meta``, ``hints`` and ``forensic``, |Δai_score| <= 1e-3 (the mean of
``timeline_binned``, tests/test_video_parity.py) and the same label.  The
audio block is held to the bound tests/test_torch_audio.py states for the
speech-like wave (timeline atol 2e-2; measured 6.3e-5 on the WAV here,
just over the 5e-5 of quantized waves, since ``write_wav`` scales by 32767).

The switches ``AVD_BACKEND=oracle``, ``AVD_AUDIO_BACKEND=host`` and
``AVD_VIDEO_CHUNK=24`` give the envelope ``avd_tpu`` gives under the same
setting; ``AVD_DETECTOR=1`` serves the shipped ``full`` checkpoint in both
(detector timeline within the bf16 2e-2).
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avd_tpu import pipeline as jpipeline
from avd_tpu.models import scoring as jscoring
from avd_tpu.native import decode as jdecode
from avd_tpu_torch import config, pipeline, schema
from avd_tpu_torch.analyzers import audio as audio_an
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.models import scoring
from avd_tpu_torch.ops import video_features
from tests import fixtures

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(REPO, "tests", "data", "corpus_v1",
                                       "*", "clip_*.mp4")))


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp("file_path")
    v = fixtures.write_video(d / "v.mp4", fixtures.spliced_clip(90, 96),
                             fps=30.0)
    av = str(d / "av.mp4")
    assert jdecode.remux_add_audio(v, av, fixtures.speechy_wav(3.0), 16000)
    wav = fixtures.write_wav(d / "a.wav", fixtures.speechy_wav(4.0))
    files = {os.path.relpath(p, REPO): p for p in CORPUS}
    files.update({"v.mp4": v, "av.mp4": av, "a.wav": wav})
    return files


@pytest.fixture
def env(monkeypatch):
    for name in ("AVD_BACKEND", "AVD_AUDIO_BACKEND", "AVD_DETECTOR",
                 "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_STREAM",
                 "AVD_PROFILE", "DEBUG"):
        monkeypatch.delenv(name, raising=False)
    config.reset_config()
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()
    yield monkeypatch
    config.reset_config()
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()


def _score(env):
    return float(np.mean(env["timeline_binned"]))


def assert_same_envelope(ours, ref):
    """The port's envelope against avd_tpu's on the same file."""
    schema.validate(ours)
    assert list(ours) == list(ref)
    assert ours["meta"] == ref["meta"]
    assert ours["hints"] == ref["hints"]
    assert ours.get("forensic") == ref.get("forensic")
    assert ours["result"]["label"] == ref["result"]["label"]
    assert abs(_score(ours) - _score(ref)) <= 1e-3
    a, b = ours["audio"], ref["audio"]
    assert list(a) == list(b) and a["scores"].keys() == b["scores"].keys()
    assert a["flags_audio"].get("error") == b["flags_audio"].get("error")
    for k in b["scores"]:
        assert a["scores"][k] == pytest.approx(b["scores"][k], abs=1e-4), k
    assert len(a["timeline"]) == len(b["timeline"])
    np.testing.assert_allclose(a["timeline"], b["timeline"], atol=2e-2)
    v, w = ours["video"], ref["video"]
    assert (v["timeline"] is v["timeline_ai"]) == \
        (w["timeline"] is w["timeline_ai"])
    assert list(v) == list(w) and v["summary"].keys() == w["summary"].keys()
    if "dup_density" in w["summary"]:
        assert v["summary"]["dup_density"] == w["summary"]["dup_density"]
        assert v["summary"]["flow_mean"] == pytest.approx(
            w["summary"]["flow_mean"], rel=1e-3, abs=1e-6)
        assert v["summary"]["texture_var"] == pytest.approx(
            w["summary"]["texture_var"], rel=1e-6)
    np.testing.assert_allclose(v["timeline"], w["timeline"], atol=1e-3)


_NAMES = [os.path.relpath(p, REPO) for p in CORPUS] + ["v.mp4", "av.mp4",
                                                       "a.wav"]


@pytest.mark.parametrize("name", _NAMES)
def test_analyze_path_matches_avd_tpu(env, media, name):
    path = media[name]
    ref = jpipeline.analyze_path(path)
    ours = pipeline.analyze_path(path, device="cpu")
    assert_same_envelope(ours, ref)
    if name == "av.mp4":  # the muxed track is analyzed, not neutral
        assert ours["meta"]["acodec"] == "aac"
        assert "error" not in ours["audio"]["flags_audio"]
    if name.endswith(".mp4"):
        assert ours["forensic"]["c2pa"] == {"present": False}
        assert "video_error" not in ours["hints"]


def test_detector_on_a_file_serves_the_shipped_full(env, media):
    env.setenv("AVD_DETECTOR", "1")
    path = media["av.mp4"]
    ref = jpipeline.analyze_path(path)
    ours = pipeline.analyze_path(path, device="cpu")
    assert_same_envelope(ours, ref)
    d, e = ours["video"]["detector"], ref["video"]["detector"]
    assert "detector_error" not in ours["video"]
    assert len(d["timeline"]) == len(e["timeline"]) == 6
    np.testing.assert_allclose(d["timeline"], e["timeline"], atol=2e-2)
    port_dir = os.path.join(REPO, "avd_tpu_torch", "models", "weights")
    jax_dir = os.path.join(REPO, "avd_tpu", "models", "weights")
    assert d["weights"] == os.path.join(port_dir, "detector_full") + "+T1.00"
    assert d["weights"].replace(port_dir, jax_dir) == e["weights"]


@pytest.mark.parametrize("name", ["v.mp4", "a.wav"])
def test_oracle_backend_matches_avd_tpu(env, media, name):
    """AVD_BACKEND=oracle: cv2's Farnebäck loop and the float64 audio
    loop on the host in both packages — the same envelope exactly."""
    env.setenv("AVD_BACKEND", "oracle")
    ref = jpipeline.analyze_path(media[name])
    ours = pipeline.analyze_path(media[name], device="cpu")
    assert ours == ref
    if name == "v.mp4":
        assert ours["video"]["summary"]["dup_density"] == 0.4


@pytest.mark.parametrize("name", ["av.mp4", "a.wav"])
def test_host_audio_backend_matches_avd_tpu(env, media, name):
    env.setenv("AVD_AUDIO_BACKEND", "host")
    ref = jpipeline.analyze_path(media[name])
    ours = pipeline.analyze_path(media[name], device="cpu")
    assert ours["audio"] == ref["audio"]
    assert_same_envelope(ours, ref)
    assert audio_an._backend() == "host"


_CHUNK_PROBE = r"""
import json, sys
sys.path.insert(0, {repo!r})
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np, torch
torch.set_num_threads(2)
from avd_tpu import pipeline as jp
from avd_tpu.ops import video_features as jvf
from avd_tpu_torch import pipeline as tp
from avd_tpu_torch.ops import video_features as tvf
path = {path!r}
print(json.dumps({{"chunks": [jvf._DEFAULT_CHUNK, tvf._DEFAULT_CHUNK],
                  "buckets": [list(jvf._window_buckets(jvf._DEFAULT_CHUNK)),
                              list(tvf._window_buckets(tvf._DEFAULT_CHUNK))],
                  "ref": jp.analyze_path(path),
                  "ours": tp.analyze_path(path, device="cpu")}}))
"""


def test_video_chunk_setting_matches_avd_tpu(tmp_path):
    """AVD_VIDEO_CHUNK=24, read at import by both packages: 60 sampled
    frames (2 fps, step 1) make two full windows of 24 and a tail."""
    rng = np.random.default_rng(4)
    frames = fixtures.gradient_clip(60, 64)
    frames[40:] = rng.integers(0, 256, frames[40:].shape, dtype=np.uint8)
    path = fixtures.write_video(tmp_path / "c.mp4", frames, fps=2.0)
    child = dict(os.environ, AVD_VIDEO_CHUNK="24", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c",
                        _CHUNK_PROBE.format(repo=REPO, path=path)],
                       capture_output=True, text=True, timeout=300, env=child)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["chunks"] == [24, 24]
    assert got["buckets"] == [[7, 13, 19, 25]] * 2
    assert_same_envelope(got["ours"], got["ref"])
    assert len(got["ours"]["video"]["timeline"]) == 30


def test_warm_device_runs_the_buckets_of_the_chunk_in_force(monkeypatch):
    seen = []
    real = video_features.run_prep_window

    def spy(w320, w32, device, cfg=None):
        seen.append((w320.shape[0], w32.shape[0], device))
        return real(w320, w32, device, cfg)

    monkeypatch.setattr(video_features, "run_prep_window", spy)
    monkeypatch.setattr(video_features, "_DEFAULT_CHUNK", 24)
    monkeypatch.setattr(video_features, "_DEVICE_WARM", False)
    cfg = config.get_config()
    assert pipeline._analyzer_timeout(cfg) == \
        cfg.request_timeout_s + cfg.cold_grace_s
    video_features.warm_device("cpu")
    assert [s[:2] for s in seen] == [(7, 7), (13, 13), (19, 19), (25, 25)]
    assert all(s[2] == torch.device("cpu") for s in seen)
    assert video_features.device_warmed()
    assert pipeline._analyzer_timeout(cfg) == cfg.request_timeout_s
    video_features.warm_device("cpu")  # warm: nothing runs
    assert len(seen) == 4


def test_analyzers_run_on_threads_with_the_resolved_device(env, media):
    seen = {}

    def spy(name, fn):
        def run(path, meta, device=None, *batcher):
            seen[name] = device
            return fn(path, meta, device, *batcher)
        return run

    env.setattr(pipeline.audio_an, "analyze", spy("audio", audio_an.analyze))
    env.setattr(pipeline.video_an, "analyze", spy("video", video_an.analyze))
    env.setenv("AVD_PROFILE", "1")
    config.reset_config()
    out = pipeline.analyze_path(media["v.mp4"], device="cpu")
    assert seen == {"audio": torch.device("cpu"),
                    "video": torch.device("cpu")}
    assert list(out["profile"]) == ["probe", "analyzers", "fusion",
                                    "forensic"]


def test_a_failing_analyzer_gives_the_neutral_block(env, media):
    def boom(path, meta, device=None, batcher=None):
        raise KeyError("x")

    env.setattr(pipeline.video_an, "analyze", boom)
    env.setenv("DEBUG", "1")
    config.reset_config()
    out = pipeline.analyze_path(media["v.mp4"], device="cpu")
    assert out["hints"]["video_error"] == "KeyError"
    assert "KeyError" in out["hints"]["video_traceback"]
    assert out["video"] == {"timeline": [0.5] * 3,
                            "summary": {"error": "KeyError"},
                            "timeline_ai": [0.5] * 3}
    schema.validate(out)
