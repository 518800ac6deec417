"""ctypes bindings of the port's libav* media feeder (``src/avd_decode.cc``).

The counterpart of ``avd_tpu/native/decode.py``, with its classes,
functions, argument shapes and results.  The library links the system
libavformat/libavcodec/libswscale/libswresample, so it is optional as in
``avd_tpu``: where the libav* headers or g++ are missing, or
``AVD_NATIVE_DECODE=0``, ``lib()`` returns None, ``unavailable()`` says
why, and the callers take their next route (video: the cv2 walk; probe:
cv2; audio: the WAV route or the neutral-timeline contract).  That is a
host decode route, not a kernel.

* video: ``VideoSampler`` demuxes the packet index without decoding, then
  decodes only the [keyframe .. sample] prefix of the GOPs that hold
  sampled frames — the frames of the reference's decode-every-frame walk
  (reference app/analyzers/video.py:27-33), bit for bit.
* audio: ``decode_audio_mono16k`` runs the libraries the
  ``ffmpeg -ac 1 -ar 16000`` CLI wraps (reference audio.py:10-13).
* ``probe`` reads the fields ``ffprobe`` reports; ``encode_video``,
  ``mux_audio`` and ``remux_add_audio`` write test fixtures.

The library is built by ``_build`` at first use, into
``build/avd_tpu_torch_host/libavd_decode-<digest>.so``.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator, Optional, Tuple

import numpy as np

from avd_tpu_torch.native import _build

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_WHY = ""  # why the library is unavailable, once lib() has returned None


class MediaInfoStruct(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("fps", ctypes.c_double),
        ("n_frames", ctypes.c_int64),
        ("duration", ctypes.c_double),
        ("has_audio", ctypes.c_int32),
        ("reserved", ctypes.c_int32),
    ]


class ProbeInfoStruct(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32),
        ("height", ctypes.c_int32),
        ("fps", ctypes.c_double),
        ("duration", ctypes.c_double),
        ("bit_rate", ctypes.c_int64),
        ("vcodec", ctypes.c_char * 32),
        ("acodec", ctypes.c_char * 32),
        ("format_name", ctypes.c_char * 64),
    ]


def lib() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when libav* or g++ are unavailable
    (``unavailable()`` says which) or ``AVD_NATIVE_DECODE=0``."""
    global _LIB, _TRIED, _WHY
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if os.getenv("AVD_NATIVE_DECODE", "1") != "1":
            _WHY = "AVD_NATIVE_DECODE=0"
            return None
        try:
            path = _build.build(_build.DECODE_SRC, flags=_build.DECODE_FLAGS,
                                libs=_build.DECODE_LIBS)
            _LIB = _bind(ctypes.CDLL(path))
        except (RuntimeError, OSError, AttributeError) as e:
            _WHY = f"{e.__class__.__name__}: {str(e).strip()[:2000]}"
        return _LIB


def unavailable() -> str:
    """Why ``lib()`` returned None ("" while it has not, or when loaded)."""
    return _WHY


def _bind(L):
    """Every export's signature (``avd_tpu/native/decode.py``)."""
    p, i64, i32, f64, s = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                           ctypes.c_double, ctypes.c_char_p)
    sigs = {
        "avd_vdec_open": ([s, i64, ctypes.POINTER(MediaInfoStruct)], p),
        "avd_vdec_read_sampled": ([p, i64, p, p], i64),
        "avd_vdec_close": ([p], None),
        "avd_adec_open": ([s, i32, ctypes.POINTER(ctypes.c_double)], p),
        "avd_adec_read": ([p, p, i64], i64),
        "avd_adec_close": ([p], None),
        "avd_mux_audio": ([s, p, i64, i32], i32),
        "avd_remux_add_audio": ([s, s, p, i64, i32], i32),
        "avd_probe": ([s, ctypes.POINTER(ProbeInfoStruct)], i32),
        "avd_venc_write": ([s, p, i64, i32, i32, f64, s, i32, i32, s], i32),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(L, name)
        fn.argtypes = args
        fn.restype = res
    return L


class VideoSampler:
    """Sampled-frame reader over the native feeder.

    Usage:
        vs = VideoSampler.open(path, step)   # None when unusable
        for frames, indices in vs.chunks(32): ...
    """

    def __init__(self, handle, info: MediaInfoStruct, step: int):
        self._h = handle
        self.width = int(info.width)
        self.height = int(info.height)
        self.fps = float(info.fps)
        self.n_frames = int(info.n_frames)
        self.duration = float(info.duration)
        self.step = step
        self._buf = None   # persistent decode target (see read())
        self._idx = None

    @classmethod
    def open(cls, path: str, step: int) -> Optional["VideoSampler"]:
        L = lib()
        if L is None:
            return None
        info = MediaInfoStruct()
        h = L.avd_vdec_open(path.encode(), step, ctypes.byref(info))
        if not h:
            return None
        if info.width <= 0 or info.height <= 0:
            L.avd_vdec_close(h)
            return None
        return cls(h, info, step)

    def read(self, max_out: int):
        """-> ([k, H, W, 3] BGR u8, [k] int64 indices) or None on error.
        k == 0 signals EOF.

        The returned frame array is a VIEW into a buffer reused by the
        next read() call — consume (or copy) it before reading again; a
        fresh allocation per chunk would pay its page faults every time."""
        L = lib()
        if self._buf is None or self._buf.shape[0] < max_out:
            self._buf = np.empty((max_out, self.height, self.width, 3),
                                 np.uint8)
            self._idx = np.empty(max_out, np.int64)
        k = L.avd_vdec_read_sampled(self._h, max_out, self._buf.ctypes.data,
                                    self._idx.ctypes.data)
        if k < 0:
            return None
        return self._buf[:k], self._idx[:k]

    def read_into(self, out: np.ndarray, idx: np.ndarray):
        """Decode up to out.shape[0] sampled frames directly into the
        caller's [n, H, W, 3] uint8 buffer.  Returns the count or None on
        error (caller falls back to the cv2 walk)."""
        L = lib()
        if not (out.flags["C_CONTIGUOUS"] and out.dtype == np.uint8
                and out.shape[1:] == (self.height, self.width, 3)
                and idx.dtype == np.int64 and idx.shape[0] >= out.shape[0]):
            raise ValueError("read_into wants a C-contiguous uint8 "
                             f"[n, {self.height}, {self.width}, 3] buffer "
                             "and an int64 index array of n entries")
        k = L.avd_vdec_read_sampled(self._h, out.shape[0],
                                    out.ctypes.data, idx.ctypes.data)
        return None if k < 0 else int(k)

    def chunks(self, chunk: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        while True:
            got = self.read(chunk)
            if got is None:
                raise RuntimeError("native decode error")
            frames, idx = got
            if frames.shape[0] == 0:
                return
            yield frames, idx

    def close(self) -> None:
        L = lib()
        if self._h and L is not None:
            L.avd_vdec_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover - GC safety net
        try:
            self.close()
        except Exception:
            pass


def decode_audio_mono16k(path: str, rate: int = 16000):
    """First audio stream → (float32 mono [-1,1), rate) or None.

    libswresample converts to s16 with the defaults the ffmpeg CLI uses;
    the float values are s16/32768, as soundfile reads the reference's
    16-bit WAV."""
    L = lib()
    if L is None:
        return None
    dur = ctypes.c_double(0.0)
    h = L.avd_adec_open(path.encode(), rate, ctypes.byref(dur))
    if not h:
        return None
    try:
        chunks = []
        buf = np.empty(rate * 60, np.float32)  # 60 s per native call
        while True:
            k = L.avd_adec_read(h, buf.ctypes.data, buf.size)
            if k < 0:
                return None
            if k == 0:
                break
            chunks.append(buf[:k].copy())
    finally:
        L.avd_adec_close(h)
    if not chunks:
        return None
    return np.concatenate(chunks), rate


def mux_audio(path: str, samples: np.ndarray, rate: int) -> bool:
    """Write an AAC audio file (test fixture helper; no ffmpeg binary)."""
    L = lib()
    if L is None:
        return False
    samples = np.ascontiguousarray(samples, np.float32)
    rc = L.avd_mux_audio(path.encode(), samples.ctypes.data,
                         samples.size, rate)
    return rc == 0


def encode_video(path: str, frames_bgr: np.ndarray, fps: float = 30.0,
                 codec: str = "libx264", crf: int = -1, gop: int = 0,
                 preset: str = "veryfast") -> bool:
    """Encode [T, H, W, 3] BGR u8 frames to a real video file with
    libavcodec's libx264/libx265/mpeg4 encoders.  crf >= 0 selects
    constant-rate-factor mode (mapped to qscale for mpeg4); gop > 0 pins
    the keyframe interval.  Dimensions must be even (yuv420p)."""
    L = lib()
    if L is None:
        return False
    frames_bgr = np.ascontiguousarray(frames_bgr, np.uint8)
    if frames_bgr.ndim != 4 or frames_bgr.shape[-1] != 3:
        raise ValueError(f"want [T, H, W, 3] BGR frames, got "
                         f"{frames_bgr.shape}")
    t, h, w = frames_bgr.shape[:3]
    rc = L.avd_venc_write(path.encode(), frames_bgr.ctypes.data, t, w, h,
                          float(fps), codec.encode(), int(crf), int(gop),
                          preset.encode())
    return rc == 0


def probe(path: str):
    """Container metadata via libavformat (ffprobe-field-compatible) or
    None when the library/file is unusable."""
    L = lib()
    if L is None:
        return None
    info = ProbeInfoStruct()
    if L.avd_probe(path.encode(), ctypes.byref(info)) != 0:
        return None
    return {
        "width": int(info.width),
        "height": int(info.height),
        "fps": float(info.fps),
        "duration": float(info.duration),
        "bit_rate": int(info.bit_rate),
        "vcodec": info.vcodec.decode() or None,
        "acodec": info.acodec.decode() or None,
        "format_name": info.format_name.decode() or None,
    }


def remux_add_audio(video_path: str, out_path: str, samples: np.ndarray,
                    rate: int) -> bool:
    """Stream-copy the video of `video_path` into `out_path` and add an
    AAC track with the given mono f32 samples (A/V test fixtures)."""
    L = lib()
    if L is None:
        return False
    samples = np.ascontiguousarray(samples, np.float32)
    rc = L.avd_remux_add_audio(video_path.encode(), out_path.encode(),
                               samples.ctypes.data, samples.size, rate)
    return rc == 0
