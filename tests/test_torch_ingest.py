"""Ingest and edge semantics of the port against ``avd_tpu``: the cases of
tests/test_ingest.py, tests/test_edge_semantics.py and
tests/test_odd_inputs.py rerun on ``avd_tpu_torch`` (CPU), each result held
to the JAX package's on the same input; and the envelope both packages give
on a host with no decoder (no ffprobe, ffmpeg or exiftool, no libav*
library, no cv2), which is what the port gives on the card's machine.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

from avd_tpu import config as jconfig
from avd_tpu import pipeline as jpipeline
from avd_tpu.analyzers import fusion as jfusion
from avd_tpu.ingest import audio_reader as jaudio_reader
from avd_tpu.ingest import probe as jprobe
from avd_tpu.ingest import video_reader as jreader
from avd_tpu.native import decode as jdecode
from avd_tpu.ops import video_features as jvf
from avd_tpu.oracle import audio_ref as jaudio_ref
from avd_tpu.oracle import video_ref as jvideo_ref
from avd_tpu_torch import config, pipeline, schema
from avd_tpu_torch.analyzers import fusion
from avd_tpu_torch.ingest import audio_reader, probe, video_reader
from avd_tpu_torch.native import decode
from avd_tpu_torch.ops import video_features
from avd_tpu_torch.oracle import audio_ref, video_ref
from tests import fixtures

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ---------------------------------------------------------------------------
# tests/test_ingest.py
# ---------------------------------------------------------------------------

def test_probe_video(tmp_path):
    path = fixtures.write_video(tmp_path / "g.mp4",
                                fixtures.gradient_clip(45, 96), fps=30.0)
    meta = probe.probe_basic_meta(path)
    assert meta == jprobe.probe_basic_meta(path)
    assert meta["width"] == 96 and meta["height"] == 96
    assert meta["fps"] == pytest.approx(30.0, rel=1e-3)
    assert meta["duration"] == pytest.approx(1.5, rel=0.1)
    assert meta["bit_rate"] > 0
    assert list(meta) == ["width", "height", "fps", "duration", "bit_rate",
                          "vcodec", "acodec", "format_name"]


def test_probe_missing_file():
    meta = probe.probe_basic_meta("/nonexistent/x.mp4")
    assert meta == jprobe.probe_basic_meta("/nonexistent/x.mp4")
    assert meta["width"] == 0 and meta["duration"] == 0.0


def test_probe_wav(tmp_path):
    path = fixtures.write_wav(tmp_path / "a.wav", fixtures.sine_wav(2.0))
    meta = probe.probe_basic_meta(path)
    assert meta == jprobe.probe_basic_meta(path)
    assert meta["duration"] == pytest.approx(2.0, rel=1e-3)
    assert meta["acodec"] == "pcm_s16le"


def test_probe_cv2_route(tmp_path, monkeypatch):
    """Without the libav* probe, both packages read cv2's properties."""
    path = fixtures.write_video(tmp_path / "g.mp4",
                                fixtures.gradient_clip(45, 96), fps=30.0)
    monkeypatch.setattr(decode, "lib", lambda: None)
    monkeypatch.setattr(jdecode, "lib", lambda: None)
    meta = probe.probe_basic_meta(path)
    assert meta == jprobe.probe_basic_meta(path)
    assert meta["format_name"] == "mp4" and meta["vcodec"] == "fmp4"


@pytest.mark.parametrize("fps", [30.0, 0.0, 1.0, 5.0, 60.0, 23.976, 2.5])
def test_sampling_step_matches_reference(fps):
    want = {30.0: 15, 0.0: 15, 1.0: 1, 5.0: 2, 60.0: 30, 23.976: 12,
            2.5: 1}[fps]
    assert video_reader.sampling_step(fps) == jreader.sampling_step(fps) \
        == want


def test_read_sampled_cadence(tmp_path):
    path = fixtures.write_video(tmp_path / "g.mp4",
                                fixtures.gradient_clip(60, 96), fps=30.0)
    meta = probe.probe_basic_meta(path)
    fb = video_reader.read_sampled(path, meta)
    ref = jreader.read_sampled(path, meta)
    assert fb.sampled == ref.sampled == 4
    assert fb.frames.shape == (4, 96, 96, 3) and fb.frames.dtype == np.uint8
    np.testing.assert_array_equal(fb.frames, ref.frames)


def test_read_sampled_unopenable():
    assert video_reader.read_sampled("/nonexistent.mp4", {}) is None
    assert jreader.read_sampled("/nonexistent.mp4", {}) is None


def test_chunked_matches_full(tmp_path):
    path = fixtures.write_video(tmp_path / "n.mp4",
                                fixtures.noise_clip(90, 64), fps=30.0)
    meta = probe.probe_basic_meta(path)
    full = video_reader.read_sampled(path, meta)
    got = np.concatenate([c.frames for c in video_reader.iter_sampled_chunks(
        path, meta, chunk=2)])
    np.testing.assert_array_equal(full.frames, got)


@pytest.mark.parametrize("sr,channels", [(16000, 1), (44100, 1), (8000, 2)])
def test_audio_wav_roundtrip(tmp_path, sr, channels):
    """The C++ host runtime's WAV route, as ``avd_tpu`` takes it."""
    wav = fixtures.sine_wav(2.0, sr=sr)
    path = tmp_path / "a.wav"
    if channels == 1:
        fixtures.write_wav(path, wav, sr=sr)
    else:
        import wave
        pcm = np.clip(np.stack([wav, -wav], 1) * 32767.0, -32768,
                      32767).astype("<i2")
        with wave.open(str(path), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(sr)
            w.writeframes(pcm.tobytes())
    loaded, rate = audio_reader.load_mono_16k(str(path))
    ref, ref_rate = jaudio_reader.load_mono_16k(str(path))
    assert rate == ref_rate == 16000
    np.testing.assert_array_equal(loaded, ref)
    if sr == 16000:
        assert loaded.shape[0] == wav.shape[0]
        np.testing.assert_allclose(loaded, wav, atol=1e-3)


def test_audio_wav_without_the_host_runtime(tmp_path, monkeypatch):
    """AVD_NATIVE=0: stdlib wave + scipy resample, as ``avd_tpu`` without
    its native library."""
    path = fixtures.write_wav(tmp_path / "a.wav", fixtures.sine_wav(1.0),
                              sr=22050)
    monkeypatch.setenv("AVD_NATIVE", "0")
    config.reset_config()
    jconfig.reset_config()
    try:
        from avd_tpu import native as jnative
        monkeypatch.setattr(jnative, "lib", lambda: None)
        loaded, _ = audio_reader.load_mono_16k(str(path))
        ref, _ = jaudio_reader.load_mono_16k(str(path))
    finally:
        monkeypatch.undo()
        config.reset_config()
        jconfig.reset_config()
    np.testing.assert_array_equal(loaded, ref)


def test_audio_unextractable_raises(tmp_path):
    p = tmp_path / "v.mp4"
    p.write_bytes(b"\x00" * 64)
    if shutil.which("ffmpeg"):
        pytest.skip("ffmpeg present; garbage container fails differently")
    with pytest.raises(audio_reader.AudioExtractError,
                       match="ffmpeg_convert_failed"):
        audio_reader.load_mono_16k(str(p))
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"RIFF" + b"\x00" * 60)
    with pytest.raises(audio_reader.AudioExtractError,
                       match="soundfile_read_failed"):
        audio_reader.load_mono_16k(str(bad))
    with pytest.raises(jaudio_reader.AudioExtractError,
                       match="soundfile_read_failed"):
        jaudio_reader.load_mono_16k(str(bad))


# ---------------------------------------------------------------------------
# tests/test_edge_semantics.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("duration,want", [(0.5, 1), (1.5, 2), (2.5, 2),
                                           (3.5, 4)])
def test_duration_bankers_rounding(duration, want):
    feats = {"dup": 0, "total": 0, "flow_means": [], "flow_vars": [],
             "textures": [], "timeline_ai": []}
    ours = video_ref.summarize(dict(feats), 0, 0, 0.0, duration)
    assert ours == jvideo_ref.summarize(dict(feats), 0, 0, 0.0, duration)
    assert len(ours["timeline"]) == want


@pytest.mark.parametrize("duration", [5.0, 2.0])
def test_timeline_truncation_vs_padding(duration):
    feats = {"dup": 0, "total": 3, "flow_means": [0.1, 0.2],
             "flow_vars": [0.0, 0.0], "textures": [10.0, 20.0, 30.0],
             "timeline_ai": [0.1, 0.2, 0.3]}
    out = video_ref.summarize(dict(feats), 64, 64, 30.0, duration)
    assert out == jvideo_ref.summarize(dict(feats), 64, 64, 30.0, duration)
    assert out["timeline"] == {5.0: [0.1, 0.2, 0.3, 0.3, 0.3],
                               2.0: [0.1, 0.2]}[duration]


def test_audio_timeline_rounding():
    wav = np.zeros(int(16000 * 2.5), np.float64)  # round(2.5) = 2
    out = audio_ref.analyze_waveform(wav, 16000)
    assert out == jaudio_ref.analyze_waveform(wav, 16000)
    assert len(out["timeline"]) == 2


def test_threshold_env_overrides(monkeypatch):
    monkeypatch.setenv("THRESH_REAL_MAX", "0.6")
    monkeypatch.setenv("THRESH_AI_MIN", "0.65")
    config.reset_config()
    jconfig.reset_config()
    args = ({"timeline": [0.5] * 4, "flags_audio": {}},
            {"timeline": [0.5] * 4, "summary": {}},
            {"compression": "light", "bpp": 0.2})
    try:
        out = fusion.fuse(*args)
        assert out == jfusion.fuse(*args)
        assert out["result"]["label"] == "real"
    finally:
        monkeypatch.undo()
        config.reset_config()
        jconfig.reset_config()


def test_ai_score_two_decimal_rounding():
    args = ({"timeline": [0.11111] * 3, "flags_audio": {}},
            {"timeline": [0.11111] * 3, "summary": {}},
            {"compression": "light", "bpp": 0.2})
    out = fusion.fuse(*args)
    assert out == jfusion.fuse(*args)
    assert out["result"]["ai_score"] == round(out["result"]["ai_score"], 2)
    assert out["result"]["confidence"] == \
        round(out["result"]["confidence"], 2)


def test_tts_cap_applies():
    rng = np.random.default_rng(0)
    sr = 16000
    parts = []
    for i in range(8):
        t = np.arange(sr // 2) / sr
        freq = 300 + 700 * (i % 3)
        if i % 2:
            parts.append(0.4 * np.sin(2 * np.pi * freq * t))
        else:
            parts.append(0.3 * rng.standard_normal(sr // 2))
    wav = np.concatenate(parts)
    out = audio_ref.analyze_waveform(wav, sr)
    assert out == jaudio_ref.analyze_waveform(wav, sr)
    var_sum = (out["flags_audio"]["sc_var"] + out["flags_audio"]["roll_var"]
               + out["flags_audio"]["zcr_var"])
    assert var_sum > 0.005 and out["scores"]["tts_like"] <= 0.90


# ---------------------------------------------------------------------------
# tests/test_odd_inputs.py
# ---------------------------------------------------------------------------

def _mk(tmp_path, name, n, h, w, fps):
    rng = np.random.default_rng(sum(map(ord, name)))
    frames = rng.integers(0, 256, (n, h, w, 3), dtype=np.int64) \
        .astype(np.uint8)
    return fixtures.write_video(tmp_path / f"{name}.mp4", frames, fps=fps)


def _both(path):
    meta = probe.probe_basic_meta(path)
    fb = video_reader.read_sampled(path, meta)
    ours = video_features.analyze_frames(fb.frames, fb.width, fb.height,
                                         fb.fps, fb.duration, device="cpu")
    ref = jvf.analyze_frames(fb.frames, fb.width, fb.height, fb.fps,
                             fb.duration)
    ora = video_ref.analyze_frames(fb.frames, fb.width, fb.height, fb.fps,
                                   fb.duration)
    return fb, ours, ref, ora


@pytest.mark.parametrize("h,w,fps,n", [
    (101, 77, 30.0, 40),    # odd dimensions
    (128, 72, 24.0, 30),    # 24 fps → step 12
    (96, 160, 30.0, 45),    # landscape
    (160, 96, 30.0, 45),    # portrait
    (64, 64, 2.0, 10),      # fps=2 → step 1: every frame sampled
    (64, 64, 30.0, 1),      # tiny clips
    (64, 64, 30.0, 3),
])
def test_parity_odd_shapes(tmp_path, h, w, fps, n):
    fb, ours, ref, ora = _both(_mk(tmp_path, f"odd{h}x{w}n{n}", n, h, w,
                                   fps))
    assert fb.sampled == {30.0: (n + 14) // 15, 24.0: (n + 11) // 12,
                          2.0: n}[fps]
    assert ours["summary"]["dup_density"] == ref["summary"]["dup_density"] \
        == ora["summary"]["dup_density"]
    assert ours["summary"]["texture_var"] == pytest.approx(
        ref["summary"]["texture_var"], rel=1e-9)
    assert len(ours["timeline"]) == len(ref["timeline"])
    np.testing.assert_allclose(ours["timeline"], ref["timeline"], atol=1e-3)
    np.testing.assert_allclose(ours["timeline"], ora["timeline"], atol=0.03)


# ---------------------------------------------------------------------------
# no decoder on the host (the card's machine)
# ---------------------------------------------------------------------------

@pytest.fixture
def no_decoder(monkeypatch):
    """Both packages with their decode routes patched away: no ffprobe,
    ffmpeg or exiftool on PATH, no libav* library, no cv2."""
    which = shutil.which
    monkeypatch.setattr(shutil, "which", lambda name, *a, **k: None
                        if name in ("ffprobe", "ffmpeg", "exiftool")
                        else which(name, *a, **k))
    monkeypatch.setattr(decode, "lib", lambda: None)
    monkeypatch.setattr(jdecode, "lib", lambda: None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    yield


def _no_decoder_pair(path):
    return pipeline.analyze_path(path, device="cpu"), \
        jpipeline.analyze_path(path)


def test_no_decoder_envelope_of_an_mp4(no_decoder):
    path = os.path.join(REPO, "tests", "data", "corpus_v1", "ai",
                        "clip_00_crf23.mp4")
    ours, ref = _no_decoder_pair(path)
    assert ours == ref
    schema.validate(ours)
    assert ours["hints"]["video_error"] == "ModuleNotFoundError"
    assert ours["meta"]["width"] == 0 and ours["meta"]["duration"] == 0.0
    assert ours["video"] == {"timeline": [0.5],
                             "summary": {"error": "ModuleNotFoundError"},
                             "timeline_ai": [0.5]}
    assert ours["audio"]["flags_audio"] == {"error": "ffmpeg_convert_failed"}
    assert ours["forensic"] == {"c2pa": {"present": False},
                                "exif_quick": {}}


def test_no_decoder_envelope_of_a_wav(no_decoder, tmp_path):
    path = fixtures.write_wav(tmp_path / "a.wav", fixtures.speechy_wav(5.0))
    ours, ref = _no_decoder_pair(path)
    assert list(ours) == list(ref)
    for key in ("meta", "hints", "video", "forensic"):
        assert ours[key] == ref[key], key
    assert ours["hints"]["video_error"] == "ModuleNotFoundError"
    assert ours["video"]["timeline"] == [0.5] * 5
    assert "audio_error" not in ours["hints"]
    assert "error" not in ours["audio"]["flags_audio"]
    np.testing.assert_allclose(ours["audio"]["timeline"],
                               ref["audio"]["timeline"], atol=2e-2)
    assert ours["result"]["label"] == ref["result"]["label"]
    schema.validate(ours)
