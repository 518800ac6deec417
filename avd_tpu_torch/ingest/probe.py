"""Container metadata probe.

The port's copy of ``avd_tpu/ingest/probe.py``.  Contract from the
reference's api.py:46-89 (``_run_ffprobe`` / ``_probe_basic_meta``): a
dict with width/height/fps/duration/bit_rate/vcodec/acodec/format_name,
zeros/None on failure, never raising.

Backends, tried in ``avd_tpu``'s order (``probe_basic_meta``):
1. ``ffprobe`` subprocess with the reference's exact field selection and
   30 s timeout (api.py:46-56) when the binary exists.
2. WAV header parsing for ``.wav`` paths.
3. libavformat through the port's decoder (``native/decode.py``) when it
   builds and the stream has video or audio.
4. OpenCV ``VideoCapture`` properties + file size for bit_rate (cv2
   imported at use; a host without it gets the empty meta).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import wave
from typing import Any, Dict

_FFPROBE_TIMEOUT_S = 30


def _empty_meta() -> Dict[str, Any]:
    return {
        "width": 0, "height": 0, "fps": 0.0, "duration": 0.0,
        "bit_rate": 0, "vcodec": None, "acodec": None, "format_name": None,
    }


def run_ffprobe(path: str) -> Dict[str, Any]:
    """ffprobe JSON dump, {} on any failure (api.py:46-56)."""
    try:
        cmd = [
            "ffprobe", "-v", "error", "-show_entries",
            "format=bit_rate,duration,format_name:"
            "stream=codec_name,codec_type,width,height,r_frame_rate",
            "-of", "json", path,
        ]
        out = subprocess.check_output(
            cmd, text=True, stderr=subprocess.DEVNULL,
            timeout=_FFPROBE_TIMEOUT_S)
        return json.loads(out)
    except Exception:
        return {}


def _meta_from_ffprobe(info: Dict[str, Any]) -> Dict[str, Any]:
    """Field extraction mirroring api.py:58-89."""
    meta = _empty_meta()
    for s in info.get("streams") or []:
        if s.get("codec_type") == "video" and not meta["width"]:
            meta["width"] = int(float(s.get("width") or 0))
            meta["height"] = int(float(s.get("height") or 0))
            r = s.get("r_frame_rate") or "0/1"
            try:
                num, den = r.split("/")
                meta["fps"] = float(num) / max(1.0, float(den))
            except Exception:
                meta["fps"] = 0.0
            meta["vcodec"] = s.get("codec_name")
        elif s.get("codec_type") == "audio" and not meta["acodec"]:
            meta["acodec"] = s.get("codec_name")
    fmt = info.get("format")
    if fmt:
        meta["bit_rate"] = int(float(fmt.get("bit_rate") or 0))
        meta["format_name"] = fmt.get("format_name")
        try:
            meta["duration"] = float(fmt.get("duration") or 0.0)
        except Exception:
            meta["duration"] = 0.0
    return meta


def _fourcc_name(code: float) -> str | None:
    code = int(code)
    if code <= 0:
        return None
    chars = [chr((code >> (8 * i)) & 0xFF) for i in range(4)]
    name = "".join(c for c in chars if c.isprintable()).strip().lower()
    return name or None


def _probe_wav(path: str) -> Dict[str, Any]:
    meta = _empty_meta()
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n = w.getnframes()
            meta["duration"] = n / sr if sr else 0.0
            meta["acodec"] = "pcm_s16le" if w.getsampwidth() == 2 else "pcm"
            meta["format_name"] = "wav"
            if meta["duration"] > 0:
                meta["bit_rate"] = int(
                    os.path.getsize(path) * 8 / meta["duration"])
    except Exception:
        pass
    return meta


def _probe_cv2(path: str) -> Dict[str, Any]:
    meta = _empty_meta()
    try:
        import cv2
        cap = cv2.VideoCapture(path)
        if not cap.isOpened():
            return meta
        try:
            meta["width"] = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
            meta["height"] = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
            meta["fps"] = float(cap.get(cv2.CAP_PROP_FPS) or 0.0)
            frames = float(cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0.0)
            if meta["fps"] > 0 and frames > 0:
                meta["duration"] = frames / meta["fps"]
            meta["vcodec"] = _fourcc_name(cap.get(cv2.CAP_PROP_FOURCC))
            ext = os.path.splitext(path)[1].lstrip(".").lower()
            meta["format_name"] = ext or None
            if meta["duration"] > 0:
                meta["bit_rate"] = int(
                    os.path.getsize(path) * 8 / meta["duration"])
        finally:
            cap.release()
    except Exception:
        pass
    return meta


def _probe_native(path: str) -> Dict[str, Any] | None:
    """libavformat probe (``native/src/avd_decode.cc``) — the same fields
    ffprobe reports, read through the library the CLI wraps; None when the
    native feeder is unavailable."""
    try:
        from avd_tpu_torch.native import decode
        info = decode.probe(path)
    except Exception:
        return None
    if info is None:
        return None
    meta = _empty_meta()
    meta.update(info)
    return meta


def probe_basic_meta(path: str) -> Dict[str, Any]:
    """Best-effort container metadata; mirrors _probe_basic_meta output
    (api.py:58-89) across backends."""
    if shutil.which("ffprobe"):
        info = run_ffprobe(path)
        if info:
            return _meta_from_ffprobe(info)
    if path.lower().endswith(".wav"):
        return _probe_wav(path)
    native = _probe_native(path)
    if native is not None and (native["width"] or native["acodec"]):
        return native
    return _probe_cv2(path)
