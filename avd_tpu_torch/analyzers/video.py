"""Video analyzer over decoded frames: heuristics plus the detector slot.

Port of ``analyze_batch`` from ``avd_tpu/analyzers/video.py``: returns
``{"timeline": [...], "summary": {...}, "timeline_ai": [...]}`` with
``timeline`` and ``timeline_ai`` the same list object (reference
video.py:83 — observable because fusion pads in place).  With
``AVD_DETECTOR=1`` the ViT detector scores every sampled frame
(``models/scoring.py``): its timeline is attached as ``out["detector"]``
and, with ``AVD_DETECTOR_BLEND``, blended into the heuristic timeline.
With ``AVD_FREQ_FORENSICS=1`` the block-DCT, blockiness and noise-residual
statistics (``ops/forensic_freq.py``) of the native gray frames are
attached as ``summary["freq"]``.  The streaming detector accumulator
belongs to the file path, which this package does not have yet.
"""

from __future__ import annotations

from typing import Any, Dict

from avd_tpu_torch import config as config_mod
from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.models import scoring
from avd_tpu_torch.ops import forensic_freq, video_features


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
    out = video_features.analyze_frames(
        fb.frames, fb.width, fb.height, fb.fps, fb.duration, device=device)

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
