"""Request orchestration: probe → hints → audio ∥ video → fusion → forensic.

Port of ``avd_tpu/pipeline.py``.  ``analyze_path`` follows the reference's
``_analyze_path`` sequence and its error-isolation contract (reference
api.py:118-170):

* each analyzer runs on its own daemon thread under a shared deadline; any
  failure substitutes the neutral result (0.5 timeline of
  ``round(duration)`` entries) and records ``hints.audio_error`` /
  ``hints.video_error`` with the exception class name (+ traceback when
  DEBUG);
* forensic failure silently drops the ``forensic`` key (api.py:167-169);
* the response dict keeps the reference's key order byte for byte.

Both analyzer threads get the device resolved in the caller's thread,
index included.  ``analyze_decoded`` is the same envelope for media that
is already decoded (frames and a mono waveform).
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time
import traceback
from typing import Any, Dict, Optional

import numpy as np

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.analyzers import audio as audio_an
from avd_tpu_torch.analyzers import fusion as fusion_an
from avd_tpu_torch.analyzers import heuristics_v2 as hx
from avd_tpu_torch.analyzers import meta as meta_an
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.config import get_config
from avd_tpu_torch.ingest import probe, video_reader
from avd_tpu_torch.ops import audio_features, video_features
from avd_tpu_torch.utils.metrics import COUNTERS, SPANS, in_span, span


class _DaemonTask:
    """Run a callable on a daemon thread with a result()/timeout API.

    Daemon threads mean a timed-out analyzer (e.g. a long first build)
    cannot keep the process alive after the response was already produced
    with the neutral fallback.
    """

    def __init__(self, fn, *args):
        self._done = threading.Event()
        self._result = None
        self._exc: BaseException | None = None

        def runner():
            try:
                self._result = fn(*args)
            except BaseException as e:  # re-raised in result()
                self._exc = e
            finally:
                self._done.set()

        self._thread = threading.Thread(target=runner, daemon=True,
                                        name="avd-analyzer")
        self._thread.start()

    def result(self, timeout: float | None = None):
        if not self._done.wait(timeout):
            raise concurrent.futures.TimeoutError()
        if self._exc is not None:
            raise self._exc
        return self._result


def _neutral_timeline_len(meta: dict) -> int:
    return int(max(1, round(meta.get("duration") or 0.0)))


def _neutral_audio(meta: dict, exc: BaseException) -> Dict[str, Any]:
    tlen = _neutral_timeline_len(meta)
    return {"scores": {}, "flags_audio": {"error": str(exc.__class__.__name__)},
            "timeline": [0.5] * tlen}


def _neutral_video(meta: dict, exc: BaseException) -> Dict[str, Any]:
    tlen = _neutral_timeline_len(meta)
    return {"timeline": [0.5] * tlen,
            "summary": {"error": str(exc.__class__.__name__)},
            "timeline_ai": [0.5] * tlen}


def _spawn_safe(fn, *args):
    """Start an analyzer on its own daemon thread.  Spawn failure (thread
    exhaustion under load) is part of the error-isolation contract — it
    must produce the neutral fallback, not fail the request — so it is
    returned as a value for _finish_safe to translate."""
    try:
        return _DaemonTask(fn, *args)
    except Exception as e:  # e.g. RuntimeError("can't start new thread")
        return e


def _finish_safe(task, meta: dict, neutral, err_key: str,
                 tb_key: str, deadline: float):
    """Collect an analyzer result with timeout + neutral fallback
    (api.py:118-140).  ``deadline`` is shared by both analyzers: they
    start together, so each still gets the full per-analyzer window the
    reference grants its sequential awaits."""
    cfg = get_config()
    hints_extra: Dict[str, Any] = {}
    try:
        if isinstance(task, BaseException):
            raise task
        return task.result(
            timeout=max(0.0, deadline - time.monotonic())), hints_extra
    except Exception as e:
        hints_extra[err_key] = f"{e.__class__.__name__}"
        if cfg.debug:
            hints_extra[tb_key] = traceback.format_exc()
        return neutral(meta, e), hints_extra


def _analyzer_timeout(cfg) -> float:
    """Per-analyzer timeout: the reference's 180 s, plus a cold-start
    grace while no device window has completed in this process (the first
    one builds the kernels).  The CLI and serving warm up first, so their
    requests keep the reference behavior."""
    base = float(cfg.request_timeout_s)
    if os.getenv("AVD_BACKEND", "jax") == "oracle":
        return base  # no device windows → nothing to build
    if not video_features.device_warmed():
        return base + float(cfg.cold_grace_s)
    return base


def analyze_path(path: str, source_url: Optional[str] = None,
                 resolved_url: Optional[str] = None,
                 device=None, batcher=None) -> Dict[str, Any]:
    """Full analysis of a media file on ``device`` (default CUDA) →
    response dict (api.py:142-170).  ``batcher``: serving's cross-request
    window batcher (``serve/batching.py``), or None to run in-process."""
    dev = device_mod.pinned(device)
    cfg = get_config()
    COUNTERS.inc("requests")
    with span("analyze") as root:
        with span("probe"):
            meta = probe.probe_basic_meta(path)
            hints = hx.compute_hints(meta, path)

        with span("analyzers"):
            deadline = time.monotonic() + _analyzer_timeout(cfg)
            audio_t = _spawn_safe(in_span("audio", audio_an.analyze),
                                  path, meta, dev)
            video_t = _spawn_safe(in_span("video", video_an.analyze),
                                  path, meta, dev, batcher)
            audio, a_hint = _finish_safe(audio_t, meta, _neutral_audio,
                                         "audio_error", "audio_traceback",
                                         deadline)
            video, v_hint = _finish_safe(video_t, meta, _neutral_video,
                                         "video_error", "video_traceback",
                                         deadline)
        hints.update(a_hint)
        hints.update(v_hint)
        COUNTERS.inc("frames_analyzed",
                     len(video.get("timeline_ai") or []))

        with span("fusion"):
            out = envelope(meta, hints, video, audio, source_url,
                           resolved_url)
        try:
            with span("forensic"):
                forensic = meta_an.forensic_summary(path)
            if forensic:
                out["forensic"] = forensic
        except Exception:
            if cfg.debug:
                out["forensic_error"] = traceback.format_exc()
        if cfg.profile:
            out["profile"] = SPANS.stage_ms(root)
    return out


def envelope(meta: Dict[str, Any], hints: Dict[str, Any], video: Dict,
             audio: Dict, source_url: Optional[str] = None,
             resolved_url: Optional[str] = None) -> Dict[str, Any]:
    """Fuse and assemble the response dict (pipeline.py:172-182 order)."""
    fused = fusion_an.fuse(audio, video, hints)
    return {
        "ok": True,
        "meta": {**meta, "source_url": source_url,
                 "resolved_url": resolved_url},
        "hints": hints,
        "video": video,
        "audio": audio,
        "result": fused["result"],
        "timeline_binned": fused["timeline_binned"],
        "peaks": fused["peaks"],
    }


def analyze_decoded(fb: video_reader.FrameBatch, wav: np.ndarray, sr: int,
                    meta: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Analyze decoded media on ``device`` (default CUDA) → envelope.

    ``meta`` carries the probed fields (width, height, fps, duration,
    bit_rate, vcodec, acodec, format_name)."""
    dev = device_mod.resolve(device)
    with span("analyze"):
        with span("hints"):
            hints = hx.compute_hints(meta, "")
        with span("video"):
            video = video_an.analyze_batch(fb, device=dev)
        with span("audio"):
            audio = audio_features.analyze_waveform(wav, sr, device=dev)
        with span("fusion"):
            return envelope(meta, hints, video, audio)
