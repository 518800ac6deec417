"""Numpy oracle for the audio feature path.

Mirrors reference app/analyzers/audio.py:22-111 over a mono float32
waveform: 0.5 s windows, per-window RMS / zero-crossing rate / Hann-windowed
rFFT spectral flatness / 85 % rolloff / normalized centroid; the speech-ratio
and tts_like aggregates including the 0.90 variability cap (audio.py:82-84);
and the per-window timeline with its normalization and padding.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def norm01(x) -> np.ndarray:
    """Min-max normalization with the reference's epsilon and empty-case
    behavior (audio.py:22-27)."""
    x = np.asarray(x, dtype=float)
    if x.size == 0:
        return np.zeros(1)
    mn, mx = float(np.min(x)), float(np.max(x))
    return (x - mn) / (mx - mn + 1e-9)


def window_features(wav: np.ndarray, sr: int) -> Dict[str, List[float]]:
    """Per-window feature lists (audio.py:37-61)."""
    win = max(1, int(sr * 0.5)) if sr else 1
    rms, zcr, flat, roll, cent = [], [], [], [], []
    for i in range(0, len(wav), win):
        seg = wav[i:i + win]
        if len(seg) == 0:
            continue
        rms.append(float(np.sqrt((seg ** 2).mean())))
        zcr.append(float(np.mean(np.abs(np.diff(np.sign(seg)))) / 2.0))
        winseg = seg * np.hanning(len(seg))
        mag = np.abs(np.fft.rfft(winseg)) + 1e-9
        flat.append(float(np.exp(np.mean(np.log(mag))) / np.mean(mag)))
        # 85% spectral rolloff via the reference's linear scan semantics:
        # first k with cumsum(mag)[k] >= 0.85*sum(mag); idx stays 0 if the
        # threshold is never reached (audio.py:51-58).
        cutoff = 0.85 * np.sum(mag)
        csum = np.cumsum(mag)
        hit = np.nonzero(csum >= cutoff)[0]
        idx = int(hit[0]) if hit.size else 0
        roll.append(float(idx) / max(1.0, len(mag)))
        freqs = np.linspace(0.0, 1.0, len(mag))
        cent.append(float(np.sum(freqs * mag) / np.sum(mag)))
    return {"rms": rms, "zcr": zcr, "flat": flat, "roll": roll, "cent": cent}


def aggregate(feats: Dict[str, List[float]], dur: float) -> Dict:
    """Aggregates + timeline (audio.py:63-111)."""
    rms_arr = np.array(feats["rms"]) if feats["rms"] else np.zeros(1)
    zcr_arr = np.array(feats["zcr"]) if feats["zcr"] else np.zeros(1)
    flat_arr = np.array(feats["flat"]) if feats["flat"] else np.zeros(1)
    roll_arr = np.array(feats["roll"]) if feats["roll"] else np.zeros(1)
    sc_arr = np.array(feats["cent"]) if feats["cent"] else np.zeros(1)

    speech_thr = np.percentile(rms_arr, 60) if rms_arr.size else 0.0
    speech_ratio = (float(np.mean(rms_arr >= speech_thr))
                    if rms_arr.size else 0.0)

    flat_mean = float(np.mean(flat_arr)) if flat_arr.size else 0.0
    sc_var = float(np.var(sc_arr)) if sc_arr.size else 0.0
    roll_var = float(np.var(roll_arr)) if roll_arr.size else 0.0
    zcr_var = float(np.var(zcr_arr)) if zcr_arr.size else 0.0

    tts_base = (0.7 * flat_mean
                + 0.15 * (1.0 / (1e-6 + zcr_var))
                + 0.15 * (1.0 / (1e-6 + roll_var)))
    attenuation = 1.0 / (1.0 + 5.0 * (sc_var + roll_var + zcr_var))
    tts_like = float(np.clip(tts_base * attenuation, 0.0, 1.0))
    # Variability cap (audio.py:82-84).
    if (sc_var + roll_var + zcr_var) > 0.005:
        tts_like = float(min(tts_like, 0.90))

    dzcr = (np.diff(np.concatenate([[zcr_arr[0]], zcr_arr]))
            if zcr_arr.size else np.zeros(1))
    droll = (np.diff(np.concatenate([[roll_arr[0]], roll_arr]))
             if roll_arr.size else np.zeros(1))
    tline = (0.5 * norm01(flat_arr)
             + 0.3 * (1.0 - norm01(dzcr ** 2))
             + 0.2 * (1.0 - norm01(np.abs(droll))))
    tline = np.clip(tline, 0.0, 1.0).tolist()

    tlen = int(max(1, round(dur)))
    if len(tline) < tlen:
        tline = tline + [tline[-1] if tline else 0.5] * (tlen - len(tline))
    else:
        tline = tline[:tlen]

    return {
        "scores": {"speech_ratio": speech_ratio, "tts_like": tts_like},
        "flags_audio": {
            "speech_ratio": speech_ratio,
            "tts_like": tts_like,
            "rms_var": float(np.var(rms_arr)) if rms_arr.size else 0.0,
            "zcr_var": zcr_var,
            "roll_var": roll_var,
            "sc_var": sc_var,
        },
        "timeline": tline,
    }


def analyze_waveform(wav: np.ndarray, sr: int) -> Dict:
    """Full oracle audio analysis over a mono waveform."""
    if wav.ndim > 1:
        wav = wav[:, 0]
    dur = len(wav) / sr if sr > 0 else 0.0
    return aggregate(window_features(wav, sr), dur)
