"""Laplacian texture variance on the device.

Port of ``avd_tpu/ops/laplacian.py``: ``cv2.Laplacian(gray, CV_64F).var()``
per frame (reference app/analyzers/video.py:51-52) — the ksize-1 stencil
[[0,1,0],[1,-4,1],[0,1,0]] with reflect-101 borders, population variance
over all pixels.  Float32 on the device, two passes (mean, then mean of
squared deviations), so one scalar per frame leaves the card and the
E[x²]−E[x]² cancellation does not arise.  The host path's variance is the
float64 one of ``host_prep.laplacian_var``.
"""

from __future__ import annotations

import torch


def laplacian(gray: torch.Tensor) -> torch.Tensor:
    """5-point Laplacian over [..., H, W] with reflect-101 borders."""
    g = gray
    up = torch.cat([g[..., 1:2, :], g[..., :-1, :]], dim=-2)
    down = torch.cat([g[..., 1:, :], g[..., -2:-1, :]], dim=-2)
    left = torch.cat([g[..., :, 1:2], g[..., :, :-1]], dim=-1)
    right = torch.cat([g[..., :, 1:], g[..., :, -2:-1]], dim=-1)
    return up + down + left + right - 4.0 * g


def texture_variance(gray: torch.Tensor) -> torch.Tensor:
    """Per-frame Laplacian variance: [N, H, W] f32 → [N] f32."""
    lap = laplacian(gray)
    mean = lap.mean(dim=(-2, -1), keepdim=True)
    return ((lap - mean) ** 2).mean(dim=(-2, -1))
