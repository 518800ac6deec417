"""Audio/video score fusion.

Reproduces the observable contract of reference app/analyzers/fusion.py
exactly — weights, penalties, bonuses, thresholds, two-decimal rounding, the
Italian label/reason strings, and even the in-place padding of the caller's
timeline lists (the reference's ``a_t += ...`` at fusion.py:20-21 mutates the
audio/video dicts that later appear verbatim in the JSON response; that
mutation is observable, so we keep it).

Fusion runs on the host in float64: the timelines are ~duration-seconds long
(tens of entries), so there is nothing for a GPU to accelerate, and float64
keeps the output bit-identical to the numpy reference.  A copy of
``avd_tpu/analyzers/fusion.py``: the port imports nothing of ``avd_tpu``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

from avd_tpu_torch.config import get_config

# Base mixture weights (fusion.py:27-29).
BASE_W_AUDIO = 0.65
BASE_W_VIDEO = 0.25
AGREEMENT_BONUS = 0.10

# Peak band: timeline entries at or beyond these bounds (fusion.py:73).
PEAK_LOW = 0.25
PEAK_HIGH = 0.75


@dataclasses.dataclass
class _Mix:
    """Resolved mixture parameters for one fuse() call."""

    w_audio: float
    w_video: float
    bonus_agree: float
    penalties: float
    real_bonus: float


def _resolve_mix(audio: dict, video: dict, hints: dict,
                 a: np.ndarray, v: np.ndarray) -> _Mix:
    """Weight/penalty/bonus resolution (fusion.py:26-66)."""
    w_audio = BASE_W_AUDIO
    w_video = BASE_W_VIDEO
    bonus_agree = (
        AGREEMENT_BONUS
        if np.sign(np.mean(a) - 0.5) == np.sign(np.mean(v) - 0.5)
        else 0.0
    )

    flags = audio.get("flags_audio", {})
    speech_ratio = float(flags.get("speech_ratio", 0.0))
    tts_like = float(flags.get("tts_like", 0.0))
    # Little speech → trust audio less (fusion.py:35-37).
    if speech_ratio < 0.25:
        w_audio *= 0.6
        w_video = max(0.2, 1.0 - w_audio - bonus_agree)

    # Quality/compression penalties (fusion.py:39-46).  Note: the dup penalty
    # is unreachable in the reference snapshot because heuristics hard-codes
    # dup_avg = 0.0; preserved as-is.
    penalties = 0.0
    if hints.get("compression", "normal") in ("heavy", "very_heavy"):
        penalties += 0.05
    if hints.get("bpp", 0.0) < 0.07:
        penalties += 0.05
    if hints.get("dup_avg", 0.0) > 0.2:
        penalties += 0.05

    # "Real footage" bonuses from video summary stats (fusion.py:48-61).
    vsum = video.get("summary", {}) or {}
    flow_mean = float(vsum.get("flow_mean", 0.0))
    texture_var = float(vsum.get("texture_var", 0.0))
    sc_rate = float(vsum.get("scene_change_rate", 0.0))
    dup_density = float(vsum.get("dup_density", 0.0))

    real_bonus = 0.0
    if flow_mean > 5.0 and texture_var > 200.0 and dup_density < 0.05:
        real_bonus -= 0.10
    if sc_rate > 0.7:
        real_bonus -= 0.05
    if sc_rate >= 0.9 and texture_var > 300.0 and dup_density < 0.02:
        real_bonus -= 0.08

    # Very TTS-like audio against strongly-real video → damp audio further
    # (fusion.py:64-66).
    if (tts_like >= 0.95 and flow_mean > 8.0 and texture_var > 300.0
            and dup_density < 0.05):
        w_audio *= 0.55
        w_video = max(0.25, 1.0 - w_audio - bonus_agree)

    return _Mix(w_audio, w_video, bonus_agree, penalties, real_bonus)


def _pad_in_place(t: List[float], target: int) -> List[float]:
    """Last-value (or 0.5) padding, mutating the list like fusion.py:20-21."""
    if len(t) < target:
        t += [t[-1] if t else 0.5] * (target - len(t))
    return t


def _label_and_reason(score: float, hints: dict, vsum: dict,
                      tts_like: float) -> tuple:
    """Threshold classification with Italian reasons (fusion.py:81-98)."""
    cfg = get_config()
    comp = hints.get("compression", "normal")
    dup_density = float((vsum or {}).get("dup_density", 0.0))

    if score <= cfg.thresh_real_max:
        reasons = []
        if dup_density > 0.25:
            reasons.append("molti frame duplicati")
        if comp in ("heavy", "very_heavy"):
            reasons.append("compressione pesante")
        if not reasons:
            reasons.append("segnali audio/video coerenti con ripresa reale")
        return "real", "; ".join(reasons)

    if score >= cfg.thresh_ai_min:
        reasons = []
        if tts_like > 0.6:
            reasons.append("audio TTS-like elevato")
        if dup_density > 0.2:
            reasons.append("molti frame duplicati")
        if hints.get("video_has_signal", True) is False:
            reasons.append("segnali video deboli")
        if not reasons:
            reasons = ["pattern e indizi coerenti con generazione AI"]
        return "ai", "; ".join(reasons)

    return "uncertain", "segnali misti o neutri"


def _bin_timeline(ts: List[float]) -> List[float]:
    """3-tap moving average with zero-padded edges (fusion.py:7-14)."""
    if not ts:
        return []
    arr = np.asarray(ts, dtype=float)
    if arr.size >= 3:
        arr = np.convolve(arr, np.ones(3) / 3.0, mode="same")
    return np.clip(arr, 0.0, 1.0).tolist()


def fuse(audio: dict, video: dict, hints: dict) -> Dict[str, Any]:
    """Fuse audio/video timelines into the final verdict (fusion.py:16-108).

    Returns ``{"result": {...}, "timeline_binned": [...], "peaks": [...]}``.
    """
    a_t = audio.get("timeline") or []
    v_t = video.get("timeline") or video.get("timeline_ai") or []
    target = max(len(a_t), len(v_t), 1)
    a_t = _pad_in_place(a_t, target)
    v_t = _pad_in_place(v_t, target)

    a = np.asarray(a_t, dtype=float)
    v = np.asarray(v_t, dtype=float)

    mix = _resolve_mix(audio, video, hints, a, v)

    fused = (
        mix.w_audio * a
        + mix.w_video * v
        + mix.bonus_agree * (a + v) / 2.0
    ) - mix.penalties + mix.real_bonus
    fused = np.clip(fused, 0.0, 1.0)

    peaks = [
        i for i, x in enumerate(fused.tolist())
        if x <= PEAK_LOW or x >= PEAK_HIGH
    ]

    score = float(np.mean(fused))
    spread = float(np.std(fused))
    disagree = float(abs(np.mean(a) - np.mean(v)))
    confidence = float(np.clip(
        0.20 + 2.2 * spread - mix.penalties
        - 0.5 * max(0.0, 0.3 - disagree),
        0.10, 0.99,
    ))

    tts_like = float(audio.get("flags_audio", {}).get("tts_like", 0.0))
    label, reason = _label_and_reason(
        score, hints, video.get("summary", {}), tts_like)

    return {
        "result": {
            "label": label,
            "ai_score": round(score, 2),
            "confidence": round(confidence, 2),
            "reason": reason,
        },
        "timeline_binned": _bin_timeline(fused.tolist()),
        "peaks": peaks,
    }
