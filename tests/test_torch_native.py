"""The port's C++ host runtime (``avd_tpu_torch/native``).

Its library against ``avd_tpu.native`` and against the port's numpy plain
versions (``ops/host_prep.py``), bit for bit (``np.array_equal``), at
1080p, 720p, 360×640, 333×517, 33×47 and 320×640 (which the fused 320²
sweeps decline); ``host_prep`` end to end, the ≤ 320 px route included;
the WAV and resample exports against the JAX bindings on
``tests/test_native.py``'s cases; ``AVD_NATIVE=0``; and the build: a
broken source raises with g++'s message, a missing g++ raises, and
concurrent processes compile once.
"""

import os
import subprocess
import sys
import wave as wave_mod
from math import gcd

import numpy as np
import pytest

from avd_tpu import native as jnative
from avd_tpu.ops import video_features as jvf
from avd_tpu_torch import config, native
from avd_tpu_torch.native import _build
from avd_tpu_torch.ops import host_prep
from avd_tpu_torch.ops import video_features as tvf
from tests import fixtures

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHAPES = [(1080, 1920), (720, 1280), (360, 640), (333, 517), (33, 47),
           (320, 640)]


def _frames(h, w, n=2):
    rng = np.random.default_rng(h * 31 + w)
    f = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    f[0] = f[0] // 64 * 64  # a posterized frame: many equal neighbours
    return f


def _plain_planes(gray):
    return (np.array([host_prep.laplacian_var(g) for g in gray]),
            np.stack([host_prep.area32(g) for g in gray]),
            np.stack([host_prep.lin320(g) for g in gray]))


def _equal(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("h,w", _SHAPES)
def test_gray_and_laplacian_bit_exact(h, w):
    frames = _frames(h, w)
    gray = native.bgr_to_gray(frames)
    np.testing.assert_array_equal(gray, jnative.bgr_to_gray(frames))
    np.testing.assert_array_equal(gray, host_prep.to_gray(frames))
    lap = native.laplacian_var(gray)
    np.testing.assert_array_equal(lap, jnative.laplacian_var(gray))
    np.testing.assert_array_equal(lap, _plain_planes(gray)[0])


def test_gray_bit_exact():
    """The video path's gray conversion (``_to_gray_host``), native and
    numpy, against the JAX package's native one."""
    frames = fixtures.noise_clip(3, 70)
    ours = tvf._to_gray_host(frames)
    np.testing.assert_array_equal(ours, jnative.bgr_to_gray(frames))
    np.testing.assert_array_equal(tvf._to_gray_host(frames, False), ours)


@pytest.mark.parametrize("h,w", _SHAPES)
def test_fused_sweeps_bit_exact(h, w):
    frames = _frames(h, w)
    gray = host_prep.to_gray(frames)
    plain = _plain_planes(gray)
    la = native.lap_area32(gray)
    _equal(la, jnative.lap_area32(gray))
    _equal(la, plain[:2])
    declined = h <= 320 or w <= 320
    for ours, theirs, x in ((native.prep320, jnative.prep320, gray),
                            (native.prep320_bgr, jnative.prep320_bgr,
                             frames)):
        out = ours(x)
        _equal(out, theirs(x))
        assert (out is None) == declined
        if out is not None:
            _equal(out, plain)


@pytest.mark.parametrize("h,w", _SHAPES)
def test_host_prep_native_equals_plain_and_jax(h, w):
    frames = _frames(h, w, n=3)
    got = host_prep.host_prep(frames)
    _equal(got, host_prep.host_prep_plain(frames))
    _equal(got, jvf._host_prep(frames))


def test_host_prep_threads_do_not_change_the_result():
    frames = _frames(200, 360, n=5)
    _equal(host_prep.host_prep(frames, threads=1),
           host_prep.host_prep(frames, threads=4))


def test_declines_and_refusals_match_jax():
    assert native.lap_area32(np.zeros((1, 31, 64), np.uint8)) is None
    assert native.laplacian_var(np.zeros((1, 0, 5), np.uint8)) is None
    assert jnative.laplacian_var(np.zeros((1, 0, 5), np.uint8)) is None
    with pytest.raises(ValueError, match="at least"):
        host_prep.host_prep(np.zeros((1, 31, 64, 3), np.uint8))
    # the C loops read 3 bytes a pixel: any other width is refused
    with pytest.raises(ValueError, match="BGR"):
        native.bgr_to_gray(np.zeros((2, 4, 4), np.uint8))
    with pytest.raises(ValueError, match="BGR"):
        native.prep320_bgr(np.zeros((1, 400, 400, 4), np.uint8))


def _wav_header(fmt_body: bytes, declared_len: int, data: bytes = b""):
    chunks = b"fmt " + declared_len.to_bytes(4, "little") + fmt_body
    if data:
        chunks += b"data" + len(data).to_bytes(4, "little") + data
    riff = b"WAVE" + chunks
    return b"RIFF" + len(riff).to_bytes(4, "little") + riff


def _extensible(n_fmt: int, data: bytes = b"") -> bytes:
    body = bytearray(n_fmt)
    body[0:2] = (0xFFFE).to_bytes(2, "little")
    body[2:4] = (1).to_bytes(2, "little")
    body[4:8] = (16000).to_bytes(4, "little")
    body[14:16] = (16).to_bytes(2, "little")
    if n_fmt >= 40:
        body[8:12] = (32000).to_bytes(4, "little")
        body[12:14] = (2).to_bytes(2, "little")
        body[16:18] = (22).to_bytes(2, "little")
        body[18:20] = (16).to_bytes(2, "little")
        body[24:26] = (1).to_bytes(2, "little")
    return _wav_header(bytes(body), declared_len=40, data=data)


def _stereo(tmp_path) -> bytes:
    left = fixtures.sine_wav(0.5, freq=440.0)
    right = fixtures.sine_wav(0.5, freq=880.0)
    inter = np.empty(left.size * 2, np.float32)
    inter[0::2] = left
    inter[1::2] = right
    pcm = np.clip(inter * 32767, -32768, 32767).astype("<i2")
    p = tmp_path / "st.wav"
    with wave_mod.open(str(p), "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())
    return p.read_bytes()


_WAVS = {
    "s16_mono": lambda tmp: open(fixtures.write_wav(
        tmp / "a.wav", fixtures.sine_wav(1.0)), "rb").read(),
    "stereo": _stereo,
    "garbage": lambda tmp: b"not a wav file at all",
    "truncated_extensible": lambda tmp: _extensible(24),
    "extensible": lambda tmp: _extensible(40, (np.sin(np.linspace(
        0, 20, 400)) * 20000).astype("<i2").tobytes()),
}


@pytest.mark.parametrize("case", sorted(_WAVS))
def test_wav_decode_matches_jax(tmp_path, case):
    data = _WAVS[case](tmp_path)
    ours, theirs = native.wav_decode_mono(data), jnative.wav_decode_mono(data)
    if theirs is None:
        assert ours is None
        assert case in ("garbage", "truncated_extensible")
        return
    assert ours[1] == theirs[1]
    np.testing.assert_array_equal(ours[0], theirs[0])


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 16000), (44100, 16000),
                                          (8000, 16000)])
def test_resample_matches_jax(sr_in, sr_out):
    t = np.arange(int(0.25 * sr_in)) / sr_in
    tone = np.sin(2 * np.pi * 440.0 * t).astype(np.float32)
    g = gcd(sr_in, sr_out)
    ours = native.resample(tone, sr_out // g, sr_in // g)
    np.testing.assert_array_equal(
        ours, jnative.resample(tone, sr_out // g, sr_in // g))
    assert ours.dtype == np.float32
    assert ours.shape == (-(-tone.size * (sr_out // g) // (sr_in // g)),)


def test_avd_native_0_takes_the_plain_versions(monkeypatch):
    """Under AVD_NATIVE=0 the main path never reaches the library."""
    frames = fixtures.noise_clip(5, 64)
    ref = tvf.compute_features(frames, device="cpu")

    def refuse():
        raise AssertionError("the native library was reached")

    monkeypatch.setattr(native, "lib", refuse)
    monkeypatch.setenv("AVD_NATIVE", "0")
    config.reset_config()
    try:
        assert not config.get_config().native
        assert tvf.compute_features(frames, device="cpu") == ref
        np.testing.assert_array_equal(tvf._to_gray_host(frames, False),
                                      jnative.bgr_to_gray(frames))
        with pytest.raises(AssertionError, match="reached"):
            host_prep.host_prep(frames)
    finally:
        monkeypatch.delenv("AVD_NATIVE")
        config.reset_config()


def test_a_broken_source_raises_with_gxx_message(tmp_path):
    src = tmp_path / "avd_native.cc"
    text = open(_build.SRC).read()
    src.write_text(text.replace("extern \"C\" {",
                                "extern \"C\" { int broken = ;", 1))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        _build.build(str(src), str(tmp_path / "build"))
    assert "error" in str(err.value)
    assert not [p for p in os.listdir(tmp_path / "build")
                if p.endswith(".so")]


def test_a_missing_gxx_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build(_build.SRC, str(tmp_path))


def test_the_library_path_follows_source_and_flags(tmp_path, monkeypatch):
    src = tmp_path / "x.cc"
    src.write_text("int a;\n")
    first = _build.lib_path(str(src), str(tmp_path))
    assert os.path.basename(first).startswith("libx-")
    src.write_text("int b;\n")
    assert _build.lib_path(str(src), str(tmp_path)) != first
    src.write_text("int a;\n")
    assert _build.lib_path(str(src), str(tmp_path)) == first
    monkeypatch.setattr(_build, "FLAGS", _build.FLAGS + ("-g",))
    assert _build.lib_path(str(src), str(tmp_path)) != first


_RACE = r"""
import sys
sys.path.insert(0, {repo!r})
from avd_tpu_torch.native import _build
path = _build.build({src!r}, {out!r})
print("compiled" if _build.BUILD_INFO else "loaded", path)
"""


def test_concurrent_processes_compile_once(tmp_path):
    src = tmp_path / "tiny.cc"
    src.write_text('extern "C" int avd_answer() { return 42; }\n')
    code = _RACE.format(repo=REPO, src=str(src), out=str(tmp_path / "b"))
    procs = [subprocess.Popen([sys.executable, "-c", code],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0].split() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert sorted(o[0] for o in outs) == ["compiled"] + ["loaded"] * 3
    assert len({o[1] for o in outs}) == 1
    import ctypes
    assert ctypes.CDLL(outs[0][1]).avd_answer() == 42
