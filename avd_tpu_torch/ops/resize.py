"""Resize as matrix multiplication.

cv2's resizes (32×32 INTER_AREA for hashing, 320×320 INTER_LINEAR for
flow — reference app/analyzers/video.py:6,43) are separable linear maps:
``out = L @ img @ R.T`` with interpolation matrices built once on the host.
The numpy builders are copies of ``avd_tpu/ops/resize.py`` (the port
imports nothing of ``avd_tpu``); ``resize_matmul`` runs on tensors.

The matrices replicate cv2 semantics:
* INTER_LINEAR — half-pixel-center source mapping with edge clamp;
  coefficients quantized to 1/2048 steps like cv2's fixed-point path for
  uint8 sources (resize.cpp INTER_RESIZE_COEF_BITS=11).
* INTER_AREA — exact box averaging for integer scale ratios, fractional
  pixel-overlap weights otherwise (matches cv2's area path).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_COEF_SCALE = 2048.0  # cv2 INTER_RESIZE_COEF_SCALE (1 << 11)


@functools.lru_cache(maxsize=64)
def linear_matrix(src: int, dst: int, quantize: bool = True) -> np.ndarray:
    """[dst, src] bilinear interpolation matrix (cv2 INTER_LINEAR, one axis).

    fx = (d + 0.5) * src/dst - 0.5; sx = floor(fx); weights (1-a, a) with
    edge clamping.  With ``quantize`` the weights are rounded to 1/2048 like
    cv2's uint8 fixed-point path.
    """
    m = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    for d in range(dst):
        fx = (d + 0.5) * scale - 0.5
        sx = int(np.floor(fx))
        a = fx - sx
        if sx < 0:
            sx, a = 0, 0.0
        if sx >= src - 1:
            sx, a = src - 2, 1.0
        if src == 1:
            m[d, 0] = 1.0
            continue
        w0, w1 = 1.0 - a, a
        if quantize:
            w0 = np.round(w0 * _COEF_SCALE) / _COEF_SCALE
            w1 = np.round(w1 * _COEF_SCALE) / _COEF_SCALE
        m[d, sx] += w0
        m[d, sx + 1] += w1
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def area_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] area-average matrix (cv2 INTER_AREA, one axis, downscale).

    Each output cell averages the source span [d*scale, (d+1)*scale) with
    fractional end weights — exact box mean when src % dst == 0.
    """
    if dst >= src:
        # INTER_AREA upscale degenerates to bilinear in cv2.
        return linear_matrix(src, dst, quantize=False)
    m = np.zeros((dst, src), dtype=np.float64)
    scale = src / dst
    for d in range(dst):
        lo = d * scale
        hi = (d + 1) * scale
        s0 = int(np.floor(lo))
        s1 = int(np.ceil(hi))
        for s in range(s0, min(s1, src)):
            w = min(hi, s + 1) - max(lo, s)
            if w > 0:
                m[d, s] = w
        m[d] /= scale
    return m.astype(np.float32)


@functools.lru_cache(maxsize=256)
def device_matrix(builder, args: tuple, device: torch.device) -> torch.Tensor:
    """``builder(*args)`` as a float32 tensor on ``device``, copied once per
    (matrix, device) instead of once per call."""
    return torch.from_numpy(np.ascontiguousarray(builder(*args))).to(device)


def resize_matmul(imgs: torch.Tensor, rows_m: torch.Tensor,
                  cols_m: torch.Tensor) -> torch.Tensor:
    """Apply a separable resize to a [..., H, W] batch via two matmuls."""
    return torch.matmul(torch.matmul(rows_m, imgs), cols_m.T)
