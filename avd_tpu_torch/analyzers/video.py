"""Video analyzer — public entry point.

Port of ``avd_tpu/analyzers/video.py``.  Contract from the reference's
app/analyzers/video.py: ``analyze(path, meta)`` returns
``{"timeline": [...], "summary": {...}, "timeline_ai": [...]}`` with
``timeline`` and ``timeline_ai`` the same list object (video.py:83 —
observable because fusion pads in place), and the empty result
``{"timeline": [], "summary": {}, "timeline_ai": []}`` when the container
cannot be opened (video.py:12-13).

The host decodes the sampled frames (``ingest/video_reader.py``); the
per-frame features run window by window on ``device``
(``ops/video_features.py``); the summary and the timeline padding run on
the host in float64.  By default a file streams in chunks of 32 sampled
frames (``_analyze_streaming``, ``AVD_STREAM=1``); ``AVD_STREAM=0``,
``AVD_FREQ_FORENSICS=1`` and ``AVD_CHANGE_GATE=1`` decode the whole batch
first (``analyze_batch``).

With ``AVD_DETECTOR=1`` the ViT detector scores every sampled frame
(``models/scoring.py``): its timeline is attached as ``out["detector"]``
and, with ``AVD_DETECTOR_BLEND``, blended into the heuristic timeline; the
streaming path resizes each chunk as it passes and scores in slabs of
``AVD_DETECTOR_SLAB`` frames (``_DetAccum``).  With
``AVD_FREQ_FORENSICS=1`` the block-DCT, blockiness and noise-residual
statistics (``ops/forensic_freq.py``) of the native gray frames are
attached as ``summary["freq"]``.

Backends (env ``AVD_BACKEND``, ``avd_tpu``'s names):
    ``jax``     the batched device path (default), here PyTorch on ``device``
    ``oracle``  the reference-faithful numpy/cv2 loop (``oracle/video_ref``),
                on the host
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np

from avd_tpu_torch import config as config_mod
from avd_tpu_torch import device as device_mod
from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.models import scoring
from avd_tpu_torch.ops import forensic_freq, video_features
from avd_tpu_torch.oracle import video_ref
from avd_tpu_torch.utils.metrics import span


def _empty_result() -> Dict[str, Any]:
    return {"timeline": [], "summary": {}, "timeline_ai": []}


def _backend() -> str:
    return os.getenv("AVD_BACKEND", "jax")


def analyze(path: str, meta: dict, device=None,
            batcher=None) -> Dict[str, Any]:
    """Analyze the video of ``path`` on ``device`` (default CUDA).
    ``batcher`` (serving's cross-request ``WindowBatcher``, or None) runs
    the streaming path's windows; the batch path runs its windows
    in-process."""
    dev = device_mod.resolve(device)
    # features needing the full decoded batch (freq forensics, change
    # gating) use the batch path; plain analysis — the detector included —
    # streams with bounded memory
    cfg = config_mod.get_config()
    whole_batch_features = cfg.freq_forensics or cfg.change_gate
    if _backend() != "oracle" and os.getenv("AVD_STREAM", "1") == "1" \
            and not whole_batch_features:
        return _analyze_streaming(path, meta, dev, batcher)
    fb = video_reader.read_sampled(path, meta)
    if fb is None:
        return _empty_result()
    return analyze_batch(fb, device=dev)


class _DetAccum:
    """Bounded-memory detector scoring for the streaming path: resized
    chunks accumulate up to one slab (``AVD_DETECTOR_SLAB`` frames,
    default 256 — about 38 MB u8 at 224 px), which is scored while the
    stream keeps draining.  The ViT scores each frame on its own, so the
    timeline does not depend on the grouping; the clip-based temporal
    family scores in fixed windows, and only whole windows flush
    mid-stream (``scoring.clip_window``), so its streaming timeline is the
    batch path's.  So does the TimeSformer, whose last window overlaps the
    one before it (``scoring.window_overlap``): a last flush shorter than a
    window is scored after the frames that complete it, which the
    previous flush scored, and their scores are dropped."""

    def __init__(self, device):
        self.device = device
        self.slab = max(1, int(os.getenv("AVD_DETECTOR_SLAB", "256")))
        self.error: str | None = None
        self._parts: list = []
        self._n = 0
        self._timeline: list = []
        self._weights = None
        self._last = None  # the last window's frames of the last flush

    def add(self, frames_bgr) -> None:
        if self.error:
            return
        try:
            size = scoring.input_size(self.device)
            with span("det.resize", frames=frames_bgr.shape[0]):
                part = scoring.resize_frames(frames_bgr, size)
            self._parts.append(part)
            self._n += part.shape[0]
            if self._n >= self.slab:
                self._flush(final=False)
        except Exception as e:  # the detector is additive — never kill
            self.error = e.__class__.__name__  # the heuristic analysis
            self._parts = []

    def _flush(self, final: bool = True) -> None:
        if not self._parts:
            return
        acc = np.concatenate(self._parts)
        win = scoring.clip_window(self.device)
        if not final and win and acc.shape[0] % win:
            cut = (acc.shape[0] // win) * win
            if cut == 0:
                return
            acc, rest = acc[:cut], acc[cut:]
            self._parts, self._n = [rest], rest.shape[0]
        else:
            self._parts, self._n = [], 0
        keep = 0
        if win and scoring.window_overlap(self.device):
            if acc.shape[0] < win and self._last is not None:
                keep = win - acc.shape[0]
                acc = np.concatenate([self._last[-keep:], acc])
            self._last = acc[-win:].copy()
        det = scoring.detector_timeline_resized(acc, device=self.device)
        if det is not None:
            self._timeline.extend(det["timeline"][keep:])
            self._weights = det["weights"]

    def result(self):
        try:
            self._flush(final=True)
        except Exception as e:
            self.error = e.__class__.__name__
        if self.error or not self._timeline:
            return None
        return {"timeline": self._timeline, "weights": self._weights}


def _analyze_streaming(path: str, meta: dict, device,
                       batcher=None) -> Dict[str, Any]:
    """File analysis with chunked decode feeding the device windows as
    they fill: memory stays bounded for long or 4K clips.  With the
    detector on, each chunk is resized to the model's input size as it
    passes and scored in slabs (``_DetAccum``)."""
    holder: Dict[str, Any] = {}
    det = _DetAccum(device) if scoring.enabled() else None

    def chunks():
        for fb in video_reader.iter_sampled_chunks(path, meta, chunk=32,
                                                   copy=False):
            holder.setdefault("fb", fb)
            if det is not None and fb.frames.shape[0]:
                det.add(fb.frames)
            yield fb.frames

    try:
        feats = video_features.compute_features_streaming(
            chunks(), device=device, batcher=batcher)
    except Exception:
        # as avd_tpu (video.py:149-156): any failure mid-stream — a native
        # decode error, a kernel that fails to build or launch — restarts
        # on the batch path from scratch, on the same device; a second
        # failure propagates and becomes hints.video_error
        fb = video_reader.read_sampled(path, meta)
        if fb is None:
            return _empty_result()
        return analyze_batch(fb, device=device)
    fb = holder.get("fb")
    if fb is None:
        # no frames came out — distinguish "container can't be opened"
        # (the reference returns the EMPTY result, video.py:12-13) from
        # "opened but zero decodable frames"
        import cv2
        c = video_reader.open_capture(path)
        if c is None:
            return _empty_result()
        fps = meta.get("fps") or c.get(cv2.CAP_PROP_FPS) or 0.0
        w = meta.get("width") or int(c.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
        h = meta.get("height") or int(c.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
        duration = meta.get("duration") or (
            c.get(cv2.CAP_PROP_FRAME_COUNT) / fps if fps > 0 else 0.0)
        c.release()
        out = video_ref.summarize(feats, w, h, fps, duration)
    else:
        out = video_ref.summarize(feats, fb.width, fb.height, fb.fps,
                                  fb.duration)
    if det is not None:
        _apply_detector(out, det.result())
        if det.error:
            out["detector_error"] = det.error
    out["timeline_ai"] = out["timeline"]
    return out


def _apply_detector(out: Dict[str, Any], det) -> None:
    """Attach the detector timeline and blend it into the heuristic
    timeline.  Alignment uses the reference's last-value/truncate padding
    rule (video.py:73-81)."""
    if det is None:
        return
    out["detector"] = det
    det_t = list(det["timeline"])
    tlen = len(out["timeline"])
    if len(det_t) < tlen:
        det_t += [det_t[-1] if det_t else 0.5] * (tlen - len(det_t))
    else:
        det_t = det_t[:tlen]
    out["timeline"] = scoring.blend(out["timeline"], det_t)


def analyze_batch(fb: video_reader.FrameBatch, device=None) -> Dict[str, Any]:
    """Analyze a pre-decoded frame batch on ``device`` (default CUDA)."""
    if _backend() == "oracle":
        out = video_ref.analyze_frames(fb.frames, fb.width, fb.height,
                                       fb.fps, fb.duration)
    else:
        out = video_features.analyze_frames(
            fb.frames, fb.width, fb.height, fb.fps, fb.duration,
            device=device)

    # optional frequency-domain forensics: an additive summary key
    cfg = config_mod.get_config()
    if cfg.freq_forensics and fb.frames.size:
        gray = video_features._to_gray_host(fb.frames, cfg.native)
        out["summary"]["freq"] = forensic_freq.summarize(gray, device=device)

    # optional neural detector: additive, so a detector failure must not
    # kill the heuristic analysis; it is reported under "detector_error"
    if scoring.enabled():
        try:
            _apply_detector(out, scoring.detector_timeline(fb.frames,
                                                           device=device))
        except Exception as e:
            out["detector_error"] = e.__class__.__name__

    # timeline and timeline_ai must alias (video.py:83).
    out["timeline_ai"] = out["timeline"]
    return out
