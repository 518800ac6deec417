"""ctypes bindings of the port's C++ host runtime (``src/avd_native.cc``).

The counterpart of ``avd_tpu/native``, with its functions, argument
shapes and dtypes.  One difference: a missing g++ or a failed build
raises; no function returns ``None`` for want of the library.  ``None``
stays only where the JAX function declines an input (``prep320*`` unless
both sides exceed 320, ``lap_area32`` under 32 px, ``laplacian_var`` on an
empty frame, a malformed WAV), since that is part of the contract.

``AVD_NATIVE=0`` (``config.native``) is read by the callers: they then
take the numpy plain versions in ``ops/host_prep.py`` and never call
these.  The library is built by ``_build`` at first use.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from avd_tpu_torch.native import _build

_LOCK = threading.Lock()
_LIB = None


def lib() -> ctypes.CDLL:
    """The loaded library (built on first use); raises when it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(_build.build()))
        return _LIB


def _bind(L):
    """Every export's signature (``avd_tpu/native/__init__.py``)."""
    p, i64, i32, c_int = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
                          ctypes.c_int)
    sigs = {
        "avd_bgr_to_gray_u8": ([p, p, i64, c_int], None),
        "avd_wav_info": ([p, i64, p], c_int),
        "avd_wav_decode_mono": ([p, i64, p], c_int),
        "avd_resample": ([p, i64, i32, i32, p, i64], None),
        "avd_laplacian_var": ([p, i64, i64, i64, p, c_int], None),
        "avd_lap_area32_batch": ([p, i64, i64, i64, p, p, c_int], None),
        "avd_prep320_batch": ([p, i64, i64, i64, p, p, p, c_int], None),
        "avd_prep320_bgr_batch": ([p, i64, i64, i64, p, p, p, c_int], None),
    }
    for name, (args, res) in sigs.items():
        fn = getattr(L, name)
        fn.argtypes = args
        fn.restype = res
    return L


class WavInfoStruct(ctypes.Structure):
    _fields_ = [
        ("sample_rate", ctypes.c_int32),
        ("channels", ctypes.c_int32),
        ("bits", ctypes.c_int32),
        ("format", ctypes.c_int32),
        ("n_frames", ctypes.c_int64),
        ("data_offset", ctypes.c_int64),
    ]


def _threads(threads) -> int:
    return threads or min(os.cpu_count() or 1, 16)


def _bgr(frames) -> np.ndarray:
    """Contiguous uint8 with a last axis of 3: the C loops read 3 bytes a
    pixel and would run past a buffer of any other width."""
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    if frames.ndim < 1 or frames.shape[-1] != 3:
        raise ValueError(f"want [..., 3] BGR frames, got {frames.shape}")
    return frames


def bgr_to_gray(frames, threads=None) -> np.ndarray:
    """[..., 3] uint8 BGR → [...] uint8 gray (cv2 fixed point), threaded."""
    L = lib()
    frames = _bgr(frames)
    out = np.empty(frames.shape[:-1], np.uint8)
    L.avd_bgr_to_gray_u8(frames.ctypes.data, out.ctypes.data, out.size,
                         _threads(threads))
    return out


def wav_decode_mono(data: bytes):
    """WAV bytes → (float32 mono array, sample_rate), or None for bytes
    that are not a WAV the parser accepts."""
    L = lib()
    buf = np.frombuffer(data, np.uint8)
    info = WavInfoStruct()
    rc = L.avd_wav_info(buf.ctypes.data, len(data), ctypes.byref(info))
    if rc != 0 or info.n_frames <= 0:
        return None
    out = np.empty(info.n_frames, np.float32)
    rc = L.avd_wav_decode_mono(buf.ctypes.data, len(data), out.ctypes.data)
    if rc != 0:
        return None
    return out, int(info.sample_rate)


def lap_area32(gray, threads=None):
    """[N, H, W] uint8 → (lap_var [N] f64, area32 [N,32,32] u8) in one
    fused sweep per frame; None under 32 px on a side (the area bins
    assume a downscale)."""
    L = lib()
    gray = np.ascontiguousarray(gray, np.uint8)
    n, h, w = gray.shape
    if h < 32 or w < 32:
        return None
    lap = np.empty(n, np.float64)
    area = np.empty((n, 32, 32), np.uint8)
    L.avd_lap_area32_batch(gray.ctypes.data, n, h, w, lap.ctypes.data,
                           area.ctypes.data, _threads(threads))
    return lap, area


def prep320(gray, threads=None):
    """[N, H, W] uint8 → (lap_var [N] f64, area32 [N,32,32] u8,
    lin320 [N,320,320] u8) in one fused sweep per frame.  Downscale only:
    None unless H, W > 320."""
    L = lib()
    gray = np.ascontiguousarray(gray, np.uint8)
    n, h, w = gray.shape
    if h <= 320 or w <= 320:
        return None
    lap = np.empty(n, np.float64)
    area = np.empty((n, 32, 32), np.uint8)
    lin = np.empty((n, 320, 320), np.uint8)
    L.avd_prep320_batch(gray.ctypes.data, n, h, w, lap.ctypes.data,
                        area.ctypes.data, lin.ctypes.data, _threads(threads))
    return lap, area, lin


def prep320_bgr(frames_bgr, threads=None):
    """[N, H, W, 3] BGR uint8 → (lap_var [N] f64, area32 [N,32,32] u8,
    lin320 [N,320,320] u8) in one fused sweep; the gray rows live in a
    3-row ring.  Downscale only: None unless H, W > 320."""
    L = lib()
    frames_bgr = _bgr(frames_bgr)
    n, h, w, _ = frames_bgr.shape
    if h <= 320 or w <= 320:
        return None
    lap = np.empty(n, np.float64)
    area = np.empty((n, 32, 32), np.uint8)
    lin = np.empty((n, 320, 320), np.uint8)
    L.avd_prep320_bgr_batch(frames_bgr.ctypes.data, n, h, w,
                            lap.ctypes.data, area.ctypes.data,
                            lin.ctypes.data, _threads(threads))
    return lap, area, lin


def laplacian_var(gray, threads=None):
    """[N, H, W] uint8 → [N] float64 Laplacian variances (cv2 CV_64F
    semantics), threaded across frames; None for frames with no pixels."""
    L = lib()
    gray = np.ascontiguousarray(gray, np.uint8)
    n, h, w = gray.shape
    if h < 1 or w < 1:
        return None
    out = np.empty(n, np.float64)
    L.avd_laplacian_var(gray.ctypes.data, n, h, w, out.ctypes.data,
                        _threads(threads))
    return out


def resample(x, up: int, down: int) -> np.ndarray:
    """float32 [n] → float32 [ceil(n*up/down)] windowed-sinc resample."""
    L = lib()
    x = np.ascontiguousarray(x, np.float32)
    n_out = -(-x.shape[0] * up // down)
    out = np.empty(n_out, np.float32)
    L.avd_resample(x.ctypes.data, x.shape[0], up, down, out.ctypes.data,
                   n_out)
    return out
