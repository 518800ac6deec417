"""Plain numpy float64 versions of the envelope's host stages: the video
summary and timeline, the audio window features and aggregates, the
container hints and the fusion.

Frozen copies of the port's ``oracle/video_ref.summarize``,
``video_features._assemble``, ``oracle/audio_ref``,
``analyzers/heuristics_v2`` and ``analyzers/fusion`` (their default
thresholds), which reproduce the reference analyzer's contract.  Nothing
here imports the program.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

THRESH_REAL_MAX = 0.35
THRESH_AI_MIN = 0.72


# ------------------------------------------------------------------ video

def video(tex, dup: int, fmean, fvar, w: int, h: int, fps: float,
          duration: float) -> Dict:
    """The video block from per-frame textures, the count of pairs whose
    hashes agree (``dup``) and per-pair flow means and variances."""
    n = len(tex)
    timeline = []
    for i in range(n):
        mot = float(fmean[i - 1]) if i > 0 else 0.0
        t = float(tex[i])
        timeline.append(float(np.clip(
            1.0 - (t / (t + 1000.0)) * (1.0 + mot), 0.0, 1.0)))
    flow_means = [float(x) for x in fmean]
    summary = {
        "dup_density": float(int(dup) / max(1, n - 1)),
        "scene_change_rate": (float(np.mean(np.asarray(fvar) > 0.5))
                              if len(fvar) else 0.0),
        "flow_mean": float(np.mean(flow_means)) if flow_means else 0.0,
        "flow_var": float(np.var(flow_means)) if flow_means else 0.0,
        "texture_var": float(np.var(tex)) if n else 0.0,
        "w": int(w), "h": int(h), "fps": float(fps),
    }
    tlen = int(max(1, round(duration)))
    if len(timeline) < tlen:
        timeline += ([timeline[-1]] if timeline else [0.5]) * \
            (tlen - len(timeline))
    else:
        timeline = timeline[:tlen]
    return {"timeline": timeline, "summary": summary,
            "timeline_ai": timeline}


# ------------------------------------------------------------------ audio

def audio_windows(wav: np.ndarray, sr: int) -> Dict[str, np.ndarray]:
    """Per-0.5 s-window rms, zcr, flatness, rolloff and centroid, float64,
    every full window at once (the ragged tail as its own window)."""
    wav = np.asarray(wav, np.float64)
    win = max(1, int(sr * 0.5))
    out = {k: [] for k in ("rms", "zcr", "flat", "roll", "cent")}
    n_full = len(wav) // win
    segs = [wav[:n_full * win].reshape(n_full, win)] if n_full else []
    if len(wav) > n_full * win:
        segs.append(wav[n_full * win:][None])
    for seg in segs:
        n = seg.shape[1]
        out["rms"].append(np.sqrt((seg ** 2).mean(axis=1)))
        out["zcr"].append(np.mean(np.abs(np.diff(np.sign(seg), axis=1)),
                                  axis=1) / 2.0)
        mag = np.abs(np.fft.rfft(seg * np.hanning(n)[None], axis=1)) + 1e-9
        out["flat"].append(np.exp(np.mean(np.log(mag), axis=1))
                           / np.mean(mag, axis=1))
        csum = np.cumsum(mag, axis=1)
        hit = csum >= 0.85 * np.sum(mag, axis=1, keepdims=True)
        idx = np.where(hit.any(axis=1), np.argmax(hit, axis=1), 0)
        out["roll"].append(idx / max(1.0, mag.shape[1]))
        freqs = np.linspace(0.0, 1.0, mag.shape[1])
        out["cent"].append(np.sum(freqs[None] * mag, axis=1)
                           / np.sum(mag, axis=1))
    return {k: (np.concatenate(v) if v else np.zeros(0))
            for k, v in out.items()}


def _norm01(x) -> np.ndarray:
    x = np.asarray(x, dtype=float)
    if x.size == 0:
        return np.zeros(1)
    mn, mx = float(np.min(x)), float(np.max(x))
    return (x - mn) / (mx - mn + 1e-9)


def audio(feats: Dict[str, np.ndarray], dur: float) -> Dict:
    """The audio block (aggregates and timeline) from window features."""
    def arr(k):
        return feats[k] if len(feats[k]) else np.zeros(1)

    rms, zcr, flat, roll, cent = (arr(k) for k in
                                  ("rms", "zcr", "flat", "roll", "cent"))
    thr = np.percentile(rms, 60)
    speech_ratio = float(np.mean(rms >= thr))
    flat_mean = float(np.mean(flat))
    sc_var, roll_var, zcr_var = (float(np.var(x)) for x in (cent, roll, zcr))
    tts_base = (0.7 * flat_mean + 0.15 * (1.0 / (1e-6 + zcr_var))
                + 0.15 * (1.0 / (1e-6 + roll_var)))
    attenuation = 1.0 / (1.0 + 5.0 * (sc_var + roll_var + zcr_var))
    tts_like = float(np.clip(tts_base * attenuation, 0.0, 1.0))
    if (sc_var + roll_var + zcr_var) > 0.005:
        tts_like = float(min(tts_like, 0.90))
    dzcr = np.diff(np.concatenate([[zcr[0]], zcr]))
    droll = np.diff(np.concatenate([[roll[0]], roll]))
    tline = np.clip(0.5 * _norm01(flat) + 0.3 * (1.0 - _norm01(dzcr ** 2))
                    + 0.2 * (1.0 - _norm01(np.abs(droll))), 0.0, 1.0).tolist()
    tlen = int(max(1, round(dur)))
    if len(tline) < tlen:
        tline = tline + [tline[-1] if tline else 0.5] * (tlen - len(tline))
    else:
        tline = tline[:tlen]
    flags = {"speech_ratio": speech_ratio, "tts_like": tts_like,
             "rms_var": float(np.var(rms)), "zcr_var": zcr_var,
             "roll_var": roll_var, "sc_var": sc_var}
    return {"scores": {"speech_ratio": speech_ratio, "tts_like": tts_like},
            "flags_audio": flags, "timeline": tline}


# ------------------------------------------------------------ hints, fusion

def hints(meta: Dict) -> Dict:
    w, h = meta.get("width") or 0, meta.get("height") or 0
    fps, br = meta.get("fps") or 0.0, meta.get("bit_rate") or 0
    pps = (w * h * fps) if w and h and fps else 0.0
    bpp = float(br) / max(1.0, pps)
    comp = next((name for ceil, name in ((0.04, "very_heavy"),
                                         (0.08, "heavy"), (0.15, "normal"))
                 if bpp <= ceil), "light")
    return {"w": w, "h": h, "fps": fps, "br": br, "bpp": round(bpp, 5),
            "compression": comp, "video_has_signal": (w * h) > 0 and fps > 0,
            "dup_avg": 0.0}


def _pad(t: List[float], target: int) -> List[float]:
    return list(t) + [t[-1] if t else 0.5] * (target - len(t))


def fuse(audio_b: Dict, video_b: Dict, hints_b: Dict) -> Dict:
    """``result`` with the score unrounded (``score``) beside the label."""
    a_t = audio_b.get("timeline") or []
    v_t = video_b.get("timeline") or []
    target = max(len(a_t), len(v_t), 1)
    a = np.asarray(_pad(a_t, target), float)
    v = np.asarray(_pad(v_t, target), float)
    w_audio, w_video = 0.65, 0.25
    bonus = 0.10 if np.sign(np.mean(a) - 0.5) == np.sign(np.mean(v) - 0.5) \
        else 0.0
    flags = audio_b.get("flags_audio", {})
    if float(flags.get("speech_ratio", 0.0)) < 0.25:
        w_audio *= 0.6
        w_video = max(0.2, 1.0 - w_audio - bonus)
    pen = 0.0
    if hints_b.get("compression", "normal") in ("heavy", "very_heavy"):
        pen += 0.05
    if hints_b.get("bpp", 0.0) < 0.07:
        pen += 0.05
    if hints_b.get("dup_avg", 0.0) > 0.2:
        pen += 0.05
    vs = video_b.get("summary", {})
    fm, tv = float(vs.get("flow_mean", 0.0)), float(vs.get("texture_var", 0.0))
    sc, dd = float(vs.get("scene_change_rate", 0.0)), \
        float(vs.get("dup_density", 0.0))
    real = 0.0
    if fm > 5.0 and tv > 200.0 and dd < 0.05:
        real -= 0.10
    if sc > 0.7:
        real -= 0.05
    if sc >= 0.9 and tv > 300.0 and dd < 0.02:
        real -= 0.08
    tts = float(flags.get("tts_like", 0.0))
    if tts >= 0.95 and fm > 8.0 and tv > 300.0 and dd < 0.05:
        w_audio *= 0.55
        w_video = max(0.25, 1.0 - w_audio - bonus)
    fused = np.clip(w_audio * a + w_video * v + bonus * (a + v) / 2.0
                    - pen + real, 0.0, 1.0)
    score = float(np.mean(fused))
    label = ("real" if score <= THRESH_REAL_MAX
             else "ai" if score >= THRESH_AI_MIN else "uncertain")
    return {"score": score, "label": label}
