"""Sampled-frame extraction.

The port's copy of ``avd_tpu/ingest/video_reader.py``.  The reference
decodes every frame with ``cap.grab()`` and retrieves every ``step``-th one
(step = max(1, round(fps/2)), ~2 analyzed fps — reference
app/analyzers/video.py:19,27-33).  The sampling cadence and pixel source
(BGR uint8) are kept; the sampled frames are stacked into one
``[N, H, W, 3]`` batch (``read_sampled``) or yielded in chunks
(``iter_sampled_chunks``) that the device consumes window by window.

Routes, in ``avd_tpu``'s order: the port's libav* GOP-skip feeder
(``native/decode.py``, off under ``AVD_NATIVE_DECODE=0``), then the cv2
walk (or ``AVD_FAST_SEEK=1`` seeking).  cv2 is imported at use: a host
without it and without libav* cannot decode, and the analyzer reports that
as ``video_error``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional

import numpy as np


@dataclasses.dataclass
class FrameBatch:
    """A batch of sampled frames plus decode bookkeeping."""

    frames: np.ndarray  # [N, H, W, 3] uint8, BGR (matches cv2 decode)
    sampled: int        # frames retrieved (== N)
    fps: float
    width: int
    height: int
    duration: float


def sampling_step(fps: float) -> int:
    """step = max(1, round((fps or 30)/2)) — video.py:19."""
    return max(1, int(round((fps or 30) / 2)))


def open_capture(path: str):
    import cv2
    cap = cv2.VideoCapture(path)
    return cap if cap.isOpened() else None


def _native_sampler(path: str, meta: dict):
    """Open the libav* GOP-skipping feeder (``native/src/avd_decode.cc``)
    when available and usable for this stream; None → cv2 fallback paths.

    The feeder produces bit-exact frames (same libavcodec decode + swscale
    BGR conversion as cv2's backend; held by
    tests/test_torch_native_decode.py) while decoding only the
    [keyframe .. last sample] prefix of GOPs that contain sampled frames —
    the reference's walk decodes everything (video.py:27-33)."""
    import os
    if os.getenv("AVD_NATIVE_DECODE", "1") != "1":
        return None
    try:
        from avd_tpu_torch.native import decode
    except Exception:
        return None
    fps = meta.get("fps") or 0.0
    if not fps:
        import cv2
        cap = cv2.VideoCapture(path)
        if cap.isOpened():
            fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
        cap.release()
    step = sampling_step(fps)
    vs = decode.VideoSampler.open(path, step)
    if vs is None or vs.n_frames <= 0:
        if vs is not None:
            vs.close()
        return None
    if not fps:
        fps = vs.fps
    return vs, float(fps), step


def _native_meta(vs, fps: float, meta: dict):
    w = meta.get("width") or vs.width
    h = meta.get("height") or vs.height
    # duration must follow the cv2 path's formula (frame_count / fps) so
    # round(duration) timeline padding stays identical (video.py:73)
    duration = meta.get("duration") or (
        vs.n_frames / fps if fps > 0 else 0.0)
    return int(w), int(h), float(duration)


def read_sampled(path: str, meta: dict,
                 max_frames: Optional[int] = None) -> Optional[FrameBatch]:
    """Decode and return the reference-sampled frames as one batch.

    Returns None when the container cannot be opened (the analyzer then
    emits the reference's empty result, video.py:12-13).
    """
    import cv2
    nat = _native_sampler(path, meta)
    if nat is not None:
        vs, fps, step = nat
        try:
            w, h, duration = _native_meta(vs, fps, meta)
            n_est = (vs.n_frames + step - 1) // step
            if max_frames is not None:
                n_est = min(n_est, max_frames)
            out = np.empty((n_est, vs.height, vs.width, 3), np.uint8)
            idx = np.empty(n_est, np.int64)
            L_k = vs.read_into(out, idx)
            if L_k is not None:
                return FrameBatch(frames=out[:L_k], sampled=int(L_k),
                                  fps=fps, width=w, height=h,
                                  duration=duration)
        except Exception:
            pass
        finally:
            vs.close()
        # native failure → fall through to the reference cv2 walk
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return None
    try:
        fps = meta.get("fps") or cap.get(cv2.CAP_PROP_FPS) or 0.0
        w = meta.get("width") or int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
        h = meta.get("height") or int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
        duration = meta.get("duration") or (
            cap.get(cv2.CAP_PROP_FRAME_COUNT) / fps if fps > 0 else 0.0)

        step = sampling_step(fps)
        frames: List[np.ndarray] = []
        index = 0
        while True:
            if not cap.grab():
                break
            if index % step == 0:
                ok, frame = cap.retrieve()
                if not ok:
                    break
                frames.append(frame)
                if max_frames is not None and len(frames) >= max_frames:
                    break
            index += 1
    finally:
        cap.release()

    if frames:
        stacked = np.stack(frames)
    else:
        stacked = np.zeros((0, h or 1, w or 1, 3), dtype=np.uint8)
    return FrameBatch(
        frames=stacked, sampled=len(frames), fps=float(fps),
        width=int(w), height=int(h), duration=float(duration),
    )


def iter_sampled_chunks(path: str, meta: dict, chunk: int = 64,
                        copy: bool = True) -> Iterator[FrameBatch]:
    """Yield sampled frames in fixed-size chunks (streaming decode).

    Used by the pipelined analyzer for long clips: each yielded batch can be
    uploaded to device while the next chunk decodes.  The final chunk may be
    short; metadata fields repeat on each batch.

    ``AVD_FAST_SEEK=1`` replaces the reference's grab-every-frame walk
    (video.py:27-33) with CAP_PROP_POS_FRAMES seeking to the sampled
    indices only.  Frame-exact (tested), but NOT generally faster: on
    long-GOP encodes the decoder re-decodes from the previous keyframe per
    seek (measured 40 s vs 23 s walk on a 60 s mp4v clip) — it only wins
    on all-intra/short-GOP material.  Default remains the walk.

    The libav* GOP-skip feeder (when built) replaces both: a demux-only
    index pass plus decode of only the GOP prefixes that contain sampled
    frames — bit-exact and ~1.4-3× less decode CPU on keyframed streams.
    A mid-stream native failure raises RuntimeError; the caller restarts
    on the cv2 batch path.
    """
    import os

    import cv2
    nat = _native_sampler(path, meta)
    if nat is not None:
        vs, fps, step = nat
        try:
            w, h, duration = _native_meta(vs, fps, meta)
            while True:
                got = vs.read(chunk)
                if got is None:
                    raise RuntimeError("native decode error mid-stream")
                frames, _ = got
                if frames.shape[0] == 0:
                    return
                # With copy=False, `frames` views a buffer reused by the
                # next read — the production streaming consumer digests it
                # into small prep arrays before advancing; everyone else
                # gets the safe default.
                if copy:
                    frames = frames.copy()
                yield FrameBatch(frames, frames.shape[0], fps, w, h,
                                 duration)
        finally:
            vs.close()

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return
    try:
        fps = meta.get("fps") or cap.get(cv2.CAP_PROP_FPS) or 0.0
        w = meta.get("width") or int(cap.get(cv2.CAP_PROP_FRAME_WIDTH) or 0)
        h = meta.get("height") or int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT) or 0)
        duration = meta.get("duration") or (
            cap.get(cv2.CAP_PROP_FRAME_COUNT) / fps if fps > 0 else 0.0)
        step = sampling_step(fps)
        fast_seek = os.getenv("AVD_FAST_SEEK", "0") == "1" and step > 1

        buf: List[np.ndarray] = []
        if fast_seek:
            index = 0
            while True:
                cap.set(cv2.CAP_PROP_POS_FRAMES, index)
                ok, frame = cap.read()
                if not ok:
                    break
                buf.append(frame)
                if len(buf) >= chunk:
                    yield FrameBatch(np.stack(buf), len(buf), float(fps),
                                     int(w), int(h), float(duration))
                    buf = []
                index += step
        else:
            index = 0
            while True:
                if not cap.grab():
                    break
                if index % step == 0:
                    ok, frame = cap.retrieve()
                    if not ok:
                        break
                    buf.append(frame)
                    if len(buf) >= chunk:
                        yield FrameBatch(np.stack(buf), len(buf), float(fps),
                                         int(w), int(h), float(duration))
                        buf = []
                index += 1
        if buf:
            yield FrameBatch(np.stack(buf), len(buf), float(fps),
                             int(w), int(h), float(duration))
    finally:
        cap.release()
