"""Frequency-domain forensic statistics on the device.

Port of ``avd_tpu/ops/forensic_freq.py`` (``AVD_FREQ_FORENSICS=1``): the
classic signal-level checks that separate camera footage from renders and
re-encodes, batched over [N, H, W] float32 gray frames:

* **8×8 block-DCT statistics** — codecs quantize in the 8×8 DCT domain,
  leaving energy in the low frequencies; the DCT is two products with the
  orthonormal DCT-II basis over every block of every frame.
* **blockiness** — mean absolute gradient across 8-px block boundaries
  against within blocks; compressed content scores > 1.
* **noise residual** — variance and excess kurtosis of the image minus its
  3×3 box blur (edge-replicated).

``summarize`` reduces the per-frame statistics to clip means on the host;
``analyzers/video.analyze_batch`` attaches them as ``summary["freq"]``.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from avd_tpu_torch import device as device_mod

_BLOCK = 8
_CHUNK = 16  # frames per device pass in ``summarize`` (bounds memory)


@functools.lru_cache(maxsize=1)
def dct8_matrix() -> np.ndarray:
    """Orthonormal 8-point DCT-II basis, [8, 8]."""
    k = np.arange(8)
    n = np.arange(8)
    m = np.cos(np.pi * (2 * n[None, :] + 1) * k[:, None] / 16.0)
    m[0] *= 1.0 / np.sqrt(2.0)
    return (m * 0.5).astype(np.float32)


def block_dct_stats(gray: torch.Tensor,
                    block: int = _BLOCK) -> Dict[str, torch.Tensor]:
    """[N, H, W] f32 → per-frame DCT-domain statistics, each [N]:
    ``hf_ratio`` (AC energy at u+v >= 8 over all AC energy), ``ac_energy``
    (mean AC coefficient magnitude), ``dc_var`` (variance of the blocks' DC
    coefficients)."""
    n, h, w = gray.shape
    hb, wb = h // block, w // block
    blocks = gray[:, :hb * block, :wb * block].reshape(n, hb, block, wb,
                                                       block)
    d = torch.from_numpy(dct8_matrix()).to(gray.device)
    c = torch.einsum("ij,nhjwk,lk->nhiwl", d, blocks, d)
    c = c.permute(0, 1, 3, 2, 4)  # [N, hb, wb, 8, 8]

    u = torch.arange(block, device=gray.device)
    ac_mask = torch.ones((block, block), dtype=torch.bool,
                         device=gray.device)
    ac_mask[0, 0] = False
    hf_mask = ((u[:, None] + u[None, :]) >= block) & ac_mask

    mag = c.abs()
    ac_energy = (mag * ac_mask).sum(dim=(-1, -2))  # [N, hb, wb]
    hf_energy = (mag * hf_mask).sum(dim=(-1, -2))
    dc = c[..., 0, 0]
    total_ac = ac_energy.sum(dim=(1, 2))
    dc_mean = dc.mean(dim=(1, 2), keepdim=True)
    return {
        "hf_ratio": hf_energy.sum(dim=(1, 2)) / total_ac.clamp_min(1e-6),
        "ac_energy": total_ac / (hb * wb * 63.0),
        "dc_var": ((dc - dc_mean) ** 2).mean(dim=(1, 2)),
    }


def blockiness(gray: torch.Tensor, block: int = _BLOCK) -> torch.Tensor:
    """[N, H, W] f32 → [N] ratio of 8-px-boundary gradients to interior
    gradients (> 1: visible codec block structure)."""
    n, h, w = gray.shape
    dev = gray.device
    dx = (gray[:, :, 1:] - gray[:, :, :-1]).abs()  # [N, H, W-1]
    dy = (gray[:, 1:, :] - gray[:, :-1, :]).abs()
    xb = (torch.arange(w - 1, device=dev) % block) == (block - 1)
    yb = (torch.arange(h - 1, device=dev) % block) == (block - 1)
    eps = 1e-6

    def frac(d, mask, dims):
        cnt = max(int(mask.sum()), 1)
        return (d * mask).sum(dim=dims) / cnt

    bx = frac(dx, xb[None, None, :], (1, 2))
    ix = frac(dx, (~xb)[None, None, :], (1, 2))
    by = frac(dy, yb[None, :, None], (1, 2))
    iy = frac(dy, (~yb)[None, :, None], (1, 2))
    return ((bx + by) / 2.0) / ((ix + iy) / 2.0).clamp_min(eps)


def _box3(x: torch.Tensor, dim: int) -> torch.Tensor:
    """3-tap box mean along ``dim`` with edge replication."""
    n = x.shape[dim]
    ext = torch.cat([x.narrow(dim, 0, 1), x, x.narrow(dim, n - 1, 1)], dim)
    return (ext.narrow(dim, 0, n) + ext.narrow(dim, 1, n)
            + ext.narrow(dim, 2, n)) / 3.0


def noise_residual_stats(gray: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[N, H, W] f32 → high-pass residual variance and excess kurtosis."""
    r = gray - _box3(_box3(gray, 1), 2)
    mean = r.mean(dim=(1, 2), keepdim=True)
    var = ((r - mean) ** 2).mean(dim=(1, 2))
    m4 = ((r - mean) ** 4).mean(dim=(1, 2))
    kurt = m4 / (var ** 2).clamp_min(1e-12) - 3.0
    return {"residual_var": var, "residual_kurtosis": kurt}


def frame_stats(gray: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Every per-frame statistic of [N, H, W] f32 gray, each [N]."""
    out = dict(block_dct_stats(gray))
    out["blockiness"] = blockiness(gray)
    out.update(noise_residual_stats(gray))
    return out


def summarize(gray_u8: np.ndarray, device=None) -> Dict[str, float]:
    """Per-clip summary from a [N, H, W] uint8 gray batch: the per-frame
    statistics on ``device`` (default CUDA), ``_CHUNK`` frames a pass, then
    their means on the host (numpy's float32 mean, as the JAX package)."""
    dev = device_mod.resolve(device)
    parts = []
    for i in range(0, gray_u8.shape[0], _CHUNK):
        g = torch.from_numpy(np.ascontiguousarray(gray_u8[i:i + _CHUNK]))
        parts.append(frame_stats(g.to(dev).float()))
    per_frame = {k: torch.cat([p[k] for p in parts]).cpu().numpy()
                 for k in parts[0]}
    return {k: float(np.mean(v)) for k, v in per_frame.items()}
