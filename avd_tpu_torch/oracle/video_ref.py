"""Host float64 summary of the video features.

A copy of ``summarize`` from ``avd_tpu/oracle/video_ref.py`` (reference
app/analyzers/video.py:60-83): summary statistics and timeline padding.  The
cv2 oracle functions stay in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


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
