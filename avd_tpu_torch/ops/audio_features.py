"""Batched audio spectral features on the GPU.

Port of ``avd_tpu/ops/audio_features.py``.  All full 0.5 s windows form one
``[n_windows, 8000]`` float32 matrix: RMS, zero-crossing rate, Hann rFFT
(``torch.fft.rfft``), spectral flatness, the 85 % rolloff (cumsum + first
index instead of the reference's scalar scan) and the normalized centroid
for every window at once.  The window count rounds up to a bucket so a few
shapes serve every clip length.  The ragged last window runs on the host
with the identical float64 formulas (``oracle/audio_ref``), and the
aggregation runs on the host in float64.

Flatness (exp(mean(log|FFT|)), reference audio.py:47-50) is the one
feature f32 breaks: on spectrally pure signals the true sidelobes sit below
the f32 FFT noise floor.  Such clips show a window's flatness near zero, so
when ``min(flat) < AVD_AUDIO_FLAT_FLOOR`` (default 1e-3) the flatness
column alone is recomputed on the host in float64.
"""

from __future__ import annotations

import functools
import os
from typing import Dict

import numpy as np
import torch

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.oracle import audio_ref

_WINDOW_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048)


def _bucket(n: int) -> int:
    for b in _WINDOW_BUCKETS:
        if n <= b:
            return b
    return n


@functools.lru_cache(maxsize=8)
def _constants(win: int, device: torch.device):
    hann = torch.from_numpy(np.hanning(win).astype(np.float32)).to(device)
    n_mag = win // 2 + 1
    freqs = torch.from_numpy(
        np.linspace(0.0, 1.0, n_mag).astype(np.float32)).to(device)
    return hann, freqs


def _features(seg: torch.Tensor):
    """[batch, win] f32 → (rms, zcr, flat, roll, cent), each [batch]."""
    win = seg.shape[1]
    hann, freqs = _constants(win, seg.device)
    n_mag = win // 2 + 1
    rms = torch.sqrt(torch.mean(seg ** 2, dim=1))
    sign = torch.sign(seg)
    zcr = torch.mean(torch.abs(sign[:, 1:] - sign[:, :-1]), dim=1) / 2.0
    spec = torch.fft.rfft(seg * hann[None, :], dim=1)
    mag = torch.abs(spec) + 1e-9
    flat = torch.exp(torch.mean(torch.log(mag), dim=1)) / torch.mean(mag, dim=1)
    csum = torch.cumsum(mag, dim=1)
    cutoff = 0.85 * csum[:, -1:]
    # first index reaching the cutoff; 0 when none — the reference's scan
    idx = torch.argmax((csum >= cutoff).to(torch.uint8), dim=1)
    roll = idx.to(torch.float32) / max(1.0, float(n_mag))
    cent = torch.sum(freqs[None, :] * mag, dim=1) / torch.sum(mag, dim=1)
    return rms, zcr, flat, roll, cent


def window_features(wav: np.ndarray, sr: int, device=None) -> Dict[str, list]:
    """Per-window feature lists matching ``audio_ref.window_features``, with
    all full windows computed batched on ``device`` (default CUDA)."""
    dev = device_mod.resolve(device)
    win = max(1, int(sr * 0.5)) if sr else 1
    n_full = len(wav) // win
    tail = wav[n_full * win:]

    out = {"rms": [], "zcr": [], "flat": [], "roll": [], "cent": []}
    if n_full:
        segs = wav[: n_full * win].reshape(n_full, win).astype(np.float32)
        b = _bucket(n_full)
        if b != n_full:
            segs = np.concatenate(
                [segs, np.zeros((b - n_full, win), np.float32)])
        seg_t = torch.from_numpy(segs).to(dev)
        cols = torch.stack(_features(seg_t))[:, :n_full].cpu().numpy()
        for k, col in zip(("rms", "zcr", "flat", "roll", "cent"), cols):
            out[k] = [float(x) for x in col]

        floor = float(os.getenv("AVD_AUDIO_FLAT_FLOOR", "1e-3"))
        if min(out["flat"]) < floor:
            # tonal content: redo flatness in float64 on the host, keep the
            # device values for everything else
            segs64 = (wav[: n_full * win].reshape(n_full, win)
                      .astype(np.float64))
            mag = np.abs(np.fft.rfft(segs64 * np.hanning(win)[None, :],
                                     axis=1)) + 1e-9
            flat64 = (np.exp(np.mean(np.log(mag), axis=1))
                      / np.mean(mag, axis=1))
            out["flat"] = [float(x) for x in flat64]

    if tail.size:
        t = audio_ref.window_features(tail.astype(np.float64), sr)
        for k in out:
            out[k].extend(t[k])
    return out


def analyze_waveform(wav: np.ndarray, sr: int, device=None) -> Dict:
    """Full audio analysis: device windows + host float64 aggregation."""
    if wav.ndim > 1:
        wav = wav[:, 0]
    dur = len(wav) / sr if sr > 0 else 0.0
    return audio_ref.aggregate(window_features(wav, sr, device=device), dur)
