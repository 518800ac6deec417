"""Video analyzer over decoded frames — the heuristic path.

Port of ``analyze_batch`` from ``avd_tpu/analyzers/video.py``: returns
``{"timeline": [...], "summary": {...}, "timeline_ai": [...]}`` with
``timeline`` and ``timeline_ai`` the same list object (reference
video.py:83 — observable because fusion pads in place).  The neural
detector and the frequency forensics are off on this path.
"""

from __future__ import annotations

from typing import Any, Dict

from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.ops import video_features


def analyze_batch(fb: video_reader.FrameBatch, device=None) -> Dict[str, Any]:
    """Analyze a pre-decoded frame batch on ``device`` (default CUDA)."""
    out = video_features.analyze_frames(
        fb.frames, fb.width, fb.height, fb.fps, fb.duration, device=device)
    # timeline and timeline_ai must alias (video.py:83).
    out["timeline_ai"] = out["timeline"]
    return out
