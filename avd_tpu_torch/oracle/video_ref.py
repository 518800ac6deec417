"""Numpy/OpenCV oracle for the video feature path, and the host summary.

The port's copy of ``avd_tpu/oracle/video_ref.py``.  Reproduces the
reference's per-frame loop (reference app/analyzers/video.py:27-58) over a
pre-decoded frame batch: 32×32 average-hash duplicate detection, cv2
Farnebäck optical flow on 320×320 grayscale, Laplacian texture variance,
per-frame AI suspicion; ``summarize`` makes the summary statistics and
the timeline padding (video.py:60-83) for every backend.  The oracle is
``AVD_BACKEND=oracle`` (``analyzers/video.py``): CPU only, cv2 imported at
use.

``flow_backend`` selects cv2's Farnebäck (reference-exact) or an injected
callable.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

FARNEBACK_PARAMS = dict(
    pyr_scale=0.5, levels=3, winsize=15, iterations=3,
    poly_n=5, poly_sigma=1.2, flags=0,
)

FlowFn = Callable[[np.ndarray, np.ndarray], np.ndarray]


def average_hash(frame_bgr: np.ndarray, size: int = 32) -> np.ndarray:
    """32×32 mean-threshold hash (video.py:4-8)."""
    import cv2
    g = cv2.cvtColor(frame_bgr, cv2.COLOR_BGR2GRAY)
    g = cv2.resize(g, (size, size), interpolation=cv2.INTER_AREA)
    return (g >= g.mean()).astype(np.uint8).flatten()


def _cv2_flow(prev_small: np.ndarray, small: np.ndarray) -> np.ndarray:
    import cv2
    p = FARNEBACK_PARAMS
    return cv2.calcOpticalFlowFarneback(
        prev_small, small, None, p["pyr_scale"], p["levels"], p["winsize"],
        p["iterations"], p["poly_n"], p["poly_sigma"], p["flags"])


def compute_features(frames: np.ndarray,
                     flow_backend: Optional[FlowFn] = None) -> Dict:
    """Per-frame features over a [N, H, W, 3] uint8 BGR batch.

    Returns the raw feature lists the reference accumulates in its loop
    (video.py:21-58): dup count, flow means/vars per consecutive pair,
    textures, timeline_ai.
    """
    import cv2
    flow_fn = flow_backend or _cv2_flow

    dup = 0
    total = 0
    prev_hash = None
    prev_small = None
    flow_means: List[float] = []
    flow_vars: List[float] = []
    textures: List[float] = []
    timeline_ai: List[float] = []

    for frame in frames:
        total += 1
        hsh = average_hash(frame, size=32)
        if prev_hash is not None and int(np.sum(hsh ^ prev_hash)) == 0:
            dup += 1
        prev_hash = hsh

        small = cv2.resize(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY),
                           (320, 320))
        if prev_small is not None:
            flow = flow_fn(prev_small, small)
            mag = np.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
            flow_means.append(float(np.mean(mag)))
            flow_vars.append(float(np.var(mag)))
        prev_small = small

        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)
        textures.append(float(cv2.Laplacian(gray, cv2.CV_64F).var()))

        tex = textures[-1]
        mot = flow_means[-1] if flow_means else 0.0
        timeline_ai.append(float(np.clip(
            1.0 - (tex / (tex + 1000.0)) * (1.0 + mot), 0.0, 1.0)))

    return {
        "dup": dup, "total": total,
        "flow_means": flow_means, "flow_vars": flow_vars,
        "textures": textures, "timeline_ai": timeline_ai,
    }


def summarize(feats: Dict, w: int, h: int, fps: float,
              duration: float) -> Dict:
    """Summary + timeline padding (video.py:60-83)."""
    flow_means = feats["flow_means"]
    flow_vars = feats["flow_vars"]
    textures = feats["textures"]
    timeline_ai = list(feats["timeline_ai"])

    dup_density = float(feats["dup"] / max(1, feats["total"] - 1))
    sc_rate = (float(np.mean(np.array(flow_vars) > 0.5))
               if flow_vars else 0.0)
    summary = {
        "dup_density": dup_density,
        "scene_change_rate": sc_rate,
        "flow_mean": float(np.mean(flow_means)) if flow_means else 0.0,
        "flow_var": float(np.var(flow_means)) if flow_means else 0.0,
        "texture_var": float(np.var(textures)) if textures else 0.0,
        "w": int(w), "h": int(h), "fps": float(fps),
    }

    tlen = int(max(1, round(duration)))
    if len(timeline_ai) < tlen:
        if timeline_ai:
            timeline_ai += [timeline_ai[-1]] * (tlen - len(timeline_ai))
        else:
            timeline_ai = [0.5] * tlen
    else:
        timeline_ai = timeline_ai[:tlen]

    return {"timeline": timeline_ai, "summary": summary,
            "timeline_ai": timeline_ai}


def analyze_frames(frames: np.ndarray, w: int, h: int, fps: float,
                   duration: float,
                   flow_backend: Optional[FlowFn] = None) -> Dict:
    """Full oracle video analysis over a decoded batch."""
    feats = compute_features(frames, flow_backend=flow_backend)
    return summarize(feats, w, h, fps, duration)
