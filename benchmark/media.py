"""Seeded inputs of the serving cells: 1080p pan frames, a speech-like
wave and the probe's fields of the mp4 they stand for.

``make_frames`` is the port's ``bench.make_frames`` pan content (a blurred
noise canvas panning (5, 3) px a frame, ``cv2.GaussianBlur`` at sigma 2),
with the generator seeded from the run's seed instead of 0.
"""

from __future__ import annotations

import numpy as np

SR = 16000  # audio rate of the serving cells (mono)


def make_frames(n: int, h: int, w: int, seed: int) -> np.ndarray:
    """[n, h, w, 3] BGR uint8: frame i is the canvas window at
    ((3·i) mod 64, (5·i) mod 64)."""
    import cv2
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 64, w + 64, 3),
                        dtype=np.int16).astype(np.uint8)
    base = cv2.GaussianBlur(base, (0, 0), 2)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        dy, dx = (i * 3) % 64, (i * 5) % 64
        frames[i] = base[dy:dy + h, dx:dx + w]
    return frames


def speech_wave(seconds: float, seed: int, sr: int = SR) -> np.ndarray:
    """Speech-like mono float32 in 0.25 s segments, each voiced (a few
    harmonics of a 90-250 Hz pitch under a syllable envelope), unvoiced
    (differenced noise, a fricative) or a pause (faint noise), drawn from
    the seed; so the per-window RMS, zero crossings, flatness and rolloff
    spread as speech does."""
    rng = np.random.default_rng(seed)
    n = int(round(seconds * sr))
    seg = sr // 4
    n_seg = -(-n // seg)
    kind = rng.choice(3, size=n_seg, p=[0.55, 0.3, 0.15])
    t = np.arange(seg) / sr
    out = np.empty(n_seg * seg, np.float64)
    for i in range(n_seg):
        noise = rng.standard_normal(seg)
        if kind[i] == 0:
            f0 = rng.uniform(90.0, 250.0)
            x = sum(np.sin(2 * np.pi * f0 * k * t + rng.uniform(0, 6.3)) / k
                    for k in range(1, 6))
            x = x * np.sin(np.pi * t / t[-1]) + 0.05 * noise
        elif kind[i] == 1:
            x = 0.5 * np.diff(noise, prepend=0.0)
        else:
            x = 0.02 * noise
        out[i * seg:(i + 1) * seg] = rng.uniform(0.3, 1.0) * x
    return (0.3 * out[:n]).astype(np.float32)


def probe_meta(n_sampled: int, h: int, w: int, fps: float,
               sample_fps: float) -> dict:
    """The probe's fields of an H.264/AAC mp4 whose sampled frames are
    ``n_sampled`` at ``sample_fps``: what ``ingest/probe`` reports."""
    duration = n_sampled / sample_fps
    return {"width": w, "height": h, "fps": float(fps),
            "duration": float(duration), "bit_rate": 8_000_000,
            "vcodec": "h264", "acodec": "aac",
            "format_name": "mov,mp4,m4a,3gp,3g2,mj2"}
