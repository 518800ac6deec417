"""The port's libav* media feeder (``avd_tpu_torch/native/decode.py``)
against ``avd_tpu.native.decode``, on the cases of
tests/test_native_decode.py: sampled frames, their indices, the audio
extraction and the probe are bit-exact to the JAX package's, and the
frames are those of the reference's cv2 walk.
"""

import numpy as np
import pytest

from avd_tpu.ingest import video_reader as jreader
from avd_tpu.native import decode as jdecode
from avd_tpu_torch import pipeline
from avd_tpu_torch.ingest import probe, video_reader
from avd_tpu_torch.native import decode
from tests import fixtures


def _cv2_walk(path, step):
    import cv2
    cap = cv2.VideoCapture(path)
    out, idx = [], 0
    while True:
        if not cap.grab():
            break
        if idx % step == 0:
            ok, f = cap.retrieve()
            if not ok:
                break
            out.append(f)
        idx += 1
    cap.release()
    return out


def _sampled(mod, path, step, chunk=4):
    vs = mod.VideoSampler.open(path, step)
    assert vs is not None
    frames, idx = [], []
    for fr, ix in vs.chunks(chunk):
        frames.append(fr.copy())
        idx.append(ix.copy())
    info = (vs.width, vs.height, vs.fps, vs.n_frames, vs.duration)
    vs.close()
    return np.concatenate(frames), np.concatenate(idx), info


def test_the_library_builds_here():
    assert decode.lib() is not None, decode.unavailable()
    assert decode.unavailable() == ""


@pytest.mark.parametrize("n,fps", [(90, 30.0), (47, 24.0), (10, 5.0)])
def test_sampler_bit_exact(tmp_path, n, fps):
    path = fixtures.write_video(tmp_path / "c.mp4",
                                fixtures.spliced_clip(n, 96), fps=fps)
    step = video_reader.sampling_step(fps)
    got, gidx, info = _sampled(decode, path, step)
    want, widx, winfo = _sampled(jdecode, path, step)
    assert info == winfo
    np.testing.assert_array_equal(gidx, widx)
    np.testing.assert_array_equal(gidx, np.arange(0, info[3], step))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack(_cv2_walk(path, step)))


def test_read_into_single_call(tmp_path):
    path = fixtures.write_video(tmp_path / "g.mp4",
                                fixtures.gradient_clip(60, 64), fps=30.0)
    step = video_reader.sampling_step(30.0)
    vs = decode.VideoSampler.open(path, step)
    n_est = (vs.n_frames + step - 1) // step
    out = np.empty((n_est, vs.height, vs.width, 3), np.uint8)
    idx = np.empty(n_est, np.int64)
    k = vs.read_into(out, idx)
    with pytest.raises(ValueError, match="read_into"):
        vs.read_into(out[:, :, :8], idx)
    vs.close()
    ref = _cv2_walk(path, step)
    assert k == len(ref) == 4
    np.testing.assert_array_equal(out[:k], np.stack(ref))


def test_reader_integration_native_vs_cv2_and_avd_tpu(tmp_path, monkeypatch):
    """read_sampled and iter_sampled_chunks: identical with the native
    feeder on and off, and to avd_tpu's reader."""
    path = fixtures.write_video(tmp_path / "n.mp4",
                                fixtures.noise_clip(75, 64), fps=30.0)
    meta = probe.probe_basic_meta(path)

    fb_nat = video_reader.read_sampled(path, meta)
    chunks_nat = [c.frames for c in
                  video_reader.iter_sampled_chunks(path, meta, chunk=3)]
    fb_ref = jreader.read_sampled(path, meta)
    np.testing.assert_array_equal(fb_nat.frames, fb_ref.frames)
    assert (fb_nat.sampled, fb_nat.fps, fb_nat.width, fb_nat.height,
            fb_nat.duration) == (fb_ref.sampled, fb_ref.fps, fb_ref.width,
                                 fb_ref.height, fb_ref.duration)

    monkeypatch.setenv("AVD_NATIVE_DECODE", "0")
    fb_cv = video_reader.read_sampled(path, meta)
    chunks_cv = [c.frames for c in
                 video_reader.iter_sampled_chunks(path, meta, chunk=3)]
    assert fb_nat.sampled == fb_cv.sampled == 5
    assert fb_nat.fps == fb_cv.fps
    assert fb_nat.duration == pytest.approx(fb_cv.duration)
    np.testing.assert_array_equal(fb_nat.frames, fb_cv.frames)
    np.testing.assert_array_equal(np.concatenate(chunks_nat),
                                  np.concatenate(chunks_cv))


def test_chunk_views_reuse_buffer_safely(tmp_path):
    path = fixtures.write_video(tmp_path / "v.mp4",
                                fixtures.gradient_clip(90, 64), fps=30.0)
    meta = probe.probe_basic_meta(path)
    stable = [c.frames for c in
              video_reader.iter_sampled_chunks(path, meta, chunk=2)]
    ref = video_reader.read_sampled(path, meta).frames
    np.testing.assert_array_equal(np.concatenate(stable), ref)


def test_audio_roundtrip_aac(tmp_path):
    """Mux a 440 Hz tone to AAC with the port, extract it with both
    packages: the same samples, bit for bit, and the tone survives."""
    sr = 44100
    t = np.arange(int(2.0 * sr)) / sr
    tone = (0.5 * np.sin(2 * np.pi * 440.0 * t)).astype(np.float32)
    path = str(tmp_path / "tone.m4a")
    assert decode.mux_audio(path, tone, sr)

    data, rate = decode.decode_audio_mono16k(path)
    ref, ref_rate = jdecode.decode_audio_mono16k(path)
    assert rate == ref_rate == 16000
    np.testing.assert_array_equal(data, ref)
    assert 1.5 <= len(data) / rate <= 2.5
    mid = data[len(data) // 4: len(data) // 2]
    spec = np.abs(np.fft.rfft(mid * np.hanning(len(mid))))
    freq = np.fft.rfftfreq(len(mid), 1.0 / rate)[np.argmax(spec)]
    assert freq == pytest.approx(440.0, abs=5.0)
    assert float(np.sqrt(np.mean(mid ** 2))) == pytest.approx(0.354,
                                                              abs=0.08)


def test_audio_none_for_video_only(tmp_path):
    path = fixtures.write_video(tmp_path / "nov.mp4",
                                fixtures.gradient_clip(30, 64), fps=30.0)
    assert decode.decode_audio_mono16k(path) is None
    assert jdecode.decode_audio_mono16k(path) is None


@pytest.mark.parametrize("what", ["video", "av", "wav", "missing"])
def test_probe_bit_exact(tmp_path, what):
    v = fixtures.write_video(tmp_path / "v.mp4",
                             fixtures.spliced_clip(45, 96), fps=30.0)
    path = {"video": v, "av": str(tmp_path / "av.mp4"),
            "wav": fixtures.write_wav(tmp_path / "a.wav",
                                      fixtures.sine_wav(1.0)),
            "missing": str(tmp_path / "none.mp4")}[what]
    if what == "av":
        assert decode.remux_add_audio(v, path, fixtures.speechy_wav(1.5),
                                      16000)
    assert decode.probe(path) == jdecode.probe(path)
    if what == "missing":
        assert decode.probe(path) is None
    else:
        assert decode.probe(path)["format_name"]


def test_encoders_write_what_avd_tpu_writes(tmp_path):
    frames = fixtures.gradient_clip(20, 64)
    ours, ref = str(tmp_path / "a.mp4"), str(tmp_path / "b.mp4")
    assert decode.encode_video(ours, frames, fps=10.0, crf=23, gop=5)
    assert jdecode.encode_video(ref, frames, fps=10.0, crf=23, gop=5)
    a, ai, _ = _sampled(decode, ours, 1)
    b, bi, _ = _sampled(jdecode, ref, 1)
    np.testing.assert_array_equal(ai, bi)
    np.testing.assert_array_equal(a, b)


def test_full_pipeline_av_mp4(tmp_path):
    """analyze_path on an mp4 with video and audio: the audio analyzer
    gives a real result through the libav* extraction."""
    vpath = fixtures.write_video(tmp_path / "v.mp4",
                                 fixtures.spliced_clip(90, 96), fps=30.0)
    out_path = str(tmp_path / "av.mp4")
    assert decode.remux_add_audio(vpath, out_path, fixtures.speechy_wav(3.0),
                                  16000)
    res = pipeline.analyze_path(out_path, device="cpu")
    assert res["ok"] is True
    assert "audio_error" not in res["hints"]
    assert "tts_like" in res["audio"]["scores"]
    assert res["audio"]["flags_audio"].get("error") is None
    tl = res["audio"]["timeline"]
    assert len(tl) == 3 and any(abs(v - 0.5) > 1e-9 for v in tl)
    assert res["meta"]["acodec"] == "aac"


def test_sampler_bit_exact_with_threaded_decode(tmp_path, monkeypatch):
    monkeypatch.setenv("AVD_DECODE_THREADS", "4")
    path = fixtures.write_video(tmp_path / "t.mp4",
                                fixtures.spliced_clip(90, 96), fps=30.0)
    step = video_reader.sampling_step(30.0)
    got, _, _ = _sampled(decode, path, step)
    np.testing.assert_array_equal(got, np.stack(_cv2_walk(path, step)))


def test_unavailable_says_why(monkeypatch, tmp_path):
    """Where the library cannot be built, lib() is None and unavailable()
    holds g++'s complaint; the callers then take their next route."""
    monkeypatch.setattr(decode, "_LIB", None)
    monkeypatch.setattr(decode, "_TRIED", False)
    monkeypatch.setattr(decode, "_WHY", "")
    broken = tmp_path / "avd_decode.cc"
    broken.write_text("#include <no_such_libav_header.h>\n")
    monkeypatch.setattr(decode._build, "DECODE_SRC", str(broken))
    assert decode.lib() is None
    assert "no_such_libav_header" in decode.unavailable()
    assert decode.VideoSampler.open(str(broken), 1) is None
    assert decode.probe(str(broken)) is None
    monkeypatch.setattr(decode, "_TRIED", False)
    monkeypatch.setenv("AVD_NATIVE_DECODE", "0")
    assert decode.lib() is None and decode.unavailable() == \
        "AVD_NATIVE_DECODE=0"
