"""Separable correlations as banded-matrix matmuls.

A 1-D correlation with any border rule is a linear map, so the [size, size]
banded matrix is built on the host and the correlation runs as a matmul —
which also lets the pyramid's gaussian-blur + bilinear-resize pair collapse
into ONE composed matrix per axis.  The numpy builders are copies of
``avd_tpu/ops/band.py``; the products are plain ``torch.matmul`` in full
fp32 (``device.resolve`` switches TF32 off), as the JAX package left them
to XLA at ``Precision.HIGHEST``.

Border semantics: "edge" (replicate) and "reflect" (mirror without edge
repeat, cv2 BORDER_REFLECT_101).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from avd_tpu_torch.ops import resize as resize_ops


def _fold_index(p: int, size: int, mode: str) -> int:
    """Map an out-of-range sample index into [0, size) per border mode."""
    if mode == "edge":
        return min(max(p, 0), size - 1)
    if mode == "reflect":  # mirror without repeating the edge sample
        if size == 1:
            return 0
        period = 2 * size - 2
        p %= period
        if p < 0:
            p += period
        return p if p < size else period - p
    raise ValueError(f"unsupported border mode: {mode}")


@functools.lru_cache(maxsize=128)
def correlate_matrix(size: int, kernel: tuple, mode: str) -> np.ndarray:
    """[size, size] matrix K with (K @ v)[i] = Σ_j kernel[j]·v[i + j - n],
    n = (len(kernel)-1)//2, borders folded per ``mode``."""
    k = np.asarray(kernel, np.float64)
    n = (len(k) - 1) // 2
    m = np.zeros((size, size), np.float64)
    for i in range(size):
        for j, kj in enumerate(k):
            m[i, _fold_index(i + j - n, size, mode)] += kj
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def blur_resize_matrix(src: int, dst: int, kernel: tuple,
                       mode: str = "reflect") -> np.ndarray:
    """[dst, src] composed operator: gaussian correlate then bilinear
    resize along one axis (float composition in f64, single f32 cast)."""
    blur = correlate_matrix(src, kernel, mode).astype(np.float64)
    rs = resize_ops.linear_matrix(src, dst, quantize=False).astype(np.float64)
    return (rs @ blur).astype(np.float32)


def apply_separable(img: torch.Tensor, rows_m: torch.Tensor,
                    cols_m: torch.Tensor) -> torch.Tensor:
    """rows_m @ img @ cols_m.T over the trailing [H, W] axes of ``img``."""
    return apply_cols(apply_rows(img, rows_m), cols_m)


def apply_rows(img: torch.Tensor, rows_m: torch.Tensor) -> torch.Tensor:
    """rows_m @ img over the trailing [H, W] axes."""
    return torch.matmul(rows_m, img)


def apply_cols(img: torch.Tensor, cols_m: torch.Tensor) -> torch.Tensor:
    """img @ cols_m.T over the trailing [H, W] axes."""
    return torch.matmul(img, cols_m.T)
