"""Farnebäck dense optical flow, batched, in PyTorch.

Port of ``avd_tpu/ops/flow.py``: the reference calls
``cv2.calcOpticalFlowFarneback(prev, cur, None, 0.5, 3, 15, 3, 5, 1.2, 0)``
per consecutive frame pair on 320×320 grayscale (reference
app/analyzers/video.py:43-49); this module runs every pair of a window at
once:

* pyramid = one composed gaussian-blur + bilinear-resize matrix per axis
  (``ops/band.py``), polynomial expansion = nine banded matmuls plus the
  inverse-Gram contraction;
* per level, 3 solver rounds of warp with the pointwise normal equations
  as its epilogue (``ops/kernels/warp.py:warp_update``) → blur+solve
  (``ops/kernels/blur_solve.py``), or, with ``fused_iter``, one
  ``ops/kernels/flow_iter.py`` call per round.

On CUDA the warp+update, the blur+solve and the fused round are the
hand-written kernels at every level (the JAX package's ``H % 40`` gates
came from the TPU's tiling); on the CPU their plain versions run.
Layouts stay the JAX package's: fields are channels-first [B, 5, H, W]
and ``farneback_flow`` returns [B, H, W, 2].
The numpy helpers are copies (``avd_tpu/ops/flow.py`` imports jax).
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import numpy as np
import torch

from avd_tpu_torch.ops import band
from avd_tpu_torch.ops import resize as resize_ops
from avd_tpu_torch.ops.kernels import blur_solve as blur_solve_k
from avd_tpu_torch.ops.kernels import flow_iter as flow_iter_k
from avd_tpu_torch.ops.kernels import warp as warp_k

DEFAULT_PARAMS = dict(pyr_scale=0.5, levels=3, winsize=15, iterations=3,
                      poly_n=5, poly_sigma=1.2)

# Border taper within 5 px of each edge (OpenCV FarnebackUpdateMatrices).
_BORDER = 5
_BORDER_SCALE = np.array(flow_iter_k.BORDER_SCALE, np.float32)


# ---------------------------------------------------------------------------
# host-side precomputation (copies of the avd_tpu builders)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _poly_exp_kernels(n: int, sigma: float):
    """1D Gaussian basis kernels g, x·g, x²·g and inverse-Gram scalars."""
    k = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(k ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = k * g
    xxg = (k ** 2) * g

    # 6×6 Gram of basis (1, x, y, x², y², xy) under w(x,y)=g(x)g(y).
    G = np.zeros((6, 6), np.float64)
    for y in k.astype(int):
        for x in k.astype(int):
            w = g[y + n] * g[x + n]
            G[0, 0] += w
            G[1, 1] += w * x * x
            G[2, 2] += w * y * y
            G[3, 3] += w * x * x * x * x
            G[4, 4] += w * y * y * y * y
            G[5, 5] += w * x * x * y * y
            G[0, 3] += w * x * x
            G[0, 4] += w * y * y
            G[3, 4] += w * x * x * y * y
    G[3, 0] = G[0, 3]
    G[4, 0] = G[0, 4]
    G[4, 3] = G[3, 4]
    invG = np.linalg.inv(G)
    ig11 = invG[1, 1]
    ig03 = invG[0, 3]
    ig33 = invG[3, 3]
    ig55 = invG[5, 5]
    return (g.astype(np.float32), xg.astype(np.float32),
            xxg.astype(np.float32), float(ig11), float(ig03),
            float(ig33), float(ig55))


@functools.lru_cache(maxsize=32)
def _gaussian_blur_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics, incl. the fixed small-kernel table
    used when sigma <= 0 and ksize <= 7."""
    small_tab = {
        1: [1.0],
        3: [0.25, 0.5, 0.25],
        5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
        7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    }
    if sigma <= 0 and ksize in small_tab:
        return np.asarray(small_tab[ksize], np.float32)
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    kern = np.exp(-(x ** 2) / (2.0 * s * s))
    kern /= kern.sum()
    return kern.astype(np.float32)


def _cv_round(x: float) -> int:
    """cvRound: round half to even."""
    f = math.floor(x)
    d = x - f
    if d < 0.5:
        return f
    if d > 0.5:
        return f + 1
    return f if f % 2 == 0 else f + 1


@functools.lru_cache(maxsize=32)
def _border_taper(h: int, w: int) -> np.ndarray:
    """[H, W] multiplicative taper: border[d] within 5 px of each edge."""
    sx = np.ones(w, np.float32)
    sy = np.ones(h, np.float32)
    for i in range(min(_BORDER, w)):
        sx[i] *= _BORDER_SCALE[i]
        sx[w - 1 - i] *= _BORDER_SCALE[i]
    for i in range(min(_BORDER, h)):
        sy[i] *= _BORDER_SCALE[i]
        sy[h - 1 - i] *= _BORDER_SCALE[i]
    return sy[:, None] * sx[None, :]


def _level_plan(h: int, w: int, pyr_scale: float, levels: int):
    """Per-level (scale, sigma, ksize, height, width), coarsest first,
    mirroring OpenCV's level clamp and cvRound sizing."""
    # clamp level count so the smallest image stays >= 32 px (OpenCV
    # min_size in calcOpticalFlowFarneback)
    eff = 0
    scale = 1.0
    for k in range(levels):
        scale *= pyr_scale
        if min(h, w) * scale < 32.0:
            break
        eff = k + 1
    plan = []
    for k in range(eff, -1, -1):
        scale = pyr_scale ** k
        sigma = (1.0 / scale - 1.0) * 0.5
        ksize = max(_cv_round(sigma * 5) | 1, 3)
        plan.append((scale, sigma, ksize,
                     _cv_round(h * scale), _cv_round(w * scale)))
    return plan


def _mat(builder, *args, device) -> torch.Tensor:
    return resize_ops.device_matrix(builder, args, device)


# ---------------------------------------------------------------------------
# device-side building blocks (all batched over leading axis B)
# ---------------------------------------------------------------------------

def _resize_bilinear(img: torch.Tensor, dst_h: int, dst_w: int):
    """Float bilinear resize (cv2 INTER_LINEAR float path) via matmuls."""
    src_h, src_w = img.shape[-2:]
    if (src_h, src_w) == (dst_h, dst_w):
        return img
    rm = _mat(resize_ops.linear_matrix, src_h, dst_h, False, device=img.device)
    cm = _mat(resize_ops.linear_matrix, src_w, dst_w, False, device=img.device)
    return resize_ops.resize_matmul(img, rm, cm)


def poly_expansion(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """[B, H, W] f32 → [B, 5, H, W] polynomial coefficient planes
    (b_x, b_y, c_xx, c_yy, c_xy) with replicate borders."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_kernels(n, sigma)
    h, w = img.shape[-2:]
    dev = img.device
    tg, txg, txxg = (tuple(float(v) for v in k) for k in (g, xg, xxg))
    kvg, kvx, kvxx = (_mat(band.correlate_matrix, h, t, "edge", device=dev)
                      for t in (tg, txg, txxg))
    khg, khx, khxx = (_mat(band.correlate_matrix, w, t, "edge", device=dev)
                      for t in (tg, txg, txxg))
    # the three distinct vertical passes are shared by the six products
    vg = band.apply_rows(img, kvg)
    vx = band.apply_rows(img, kvx)
    vxx = band.apply_rows(img, kvxx)
    b1 = band.apply_cols(vg, khg)       # smooth
    b2 = band.apply_cols(vg, khx)       # d/dx
    b3 = band.apply_cols(vx, khg)       # d/dy
    b4 = band.apply_cols(vg, khxx)      # x²
    b5 = band.apply_cols(vxx, khg)      # y²
    b6 = band.apply_cols(vx, khx)       # xy
    bx = b2 * ig11
    by = b3 * ig11
    cxx = b1 * ig03 + b4 * ig33
    cyy = b1 * ig03 + b5 * ig33
    cxy = b6 * ig55
    return torch.stack([bx, by, cxx, cyy, cxy], dim=1)


def _in_bounds(flow: torch.Tensor) -> torch.Tensor:
    """[B,H,W] mask of the OpenCV in-bounds rule 0 <= floor(coord) < size-1
    for the positions (x + dx, y + dy) of [B,2,H,W] flow planes."""
    H, W = flow.shape[2:4]
    xs = torch.arange(W, dtype=torch.float32, device=flow.device)[None, None]
    ys = torch.arange(H, dtype=torch.float32,
                      device=flow.device)[None, :, None]
    x1 = torch.floor(xs + flow[:, 0])
    y1 = torch.floor(ys + flow[:, 1])
    return (x1 >= 0) & (x1 <= W - 2) & (y1 >= 0) & (y1 <= H - 2)


def _warp_poly(R1: torch.Tensor, flow: torch.Tensor):
    """Bilinear warp of [B,5,H,W] coefficients by [B,2,H,W] flow planes.

    Returns (warped [B,5,H,W], in_bounds [B,H,W]); warped is 0 outside the
    in-bounds rule."""
    return warp_k.warp_bilinear(R1, flow), _in_bounds(flow)


def _update_matrices(R0: torch.Tensor, R1: torch.Tensor,
                     flow: torch.Tensor) -> torch.Tensor:
    """Pointwise normal-equation entries M=[B,5,H,W] (G11,G12,G22,h1,h2)
    from channels-first polynomial fields and flow planes: on CUDA one
    launch of the warp kernel with the update as its epilogue, on the CPU
    ``update_from_warped`` after the plain warp."""
    return warp_k.warp_update(R0, R1, flow)


def update_from_warped(R0: torch.Tensor, R1w: torch.Tensor,
                       flow: torch.Tensor) -> torch.Tensor:
    """``_update_matrices`` after the warp: R1w is R1 warped by ``flow``
    (0 outside the in-bounds rule).  bf16 fields (``flow_bf16``) are
    widened here, as in ``avd_tpu/ops/flow.py``: all arithmetic is f32.
    The plain version of the warp kernel's update epilogue
    (``csrc/update.cuh``), which keeps this order of operations."""
    H, W = R0.shape[2:4]
    inb = _in_bounds(flow)
    R0 = R0.float()
    R1w = R1w.float()

    # averaged quadratic coefficients; cross term carries an extra 1/2
    # because the stored channel is the full cross coefficient.
    r4 = torch.where(inb, (R0[:, 2] + R1w[:, 2]) * 0.5, R0[:, 2])
    r5 = torch.where(inb, (R0[:, 3] + R1w[:, 3]) * 0.5, R0[:, 3])
    r6 = torch.where(inb, (R0[:, 4] + R1w[:, 4]) * 0.25, R0[:, 4] * 0.5)

    b1w = torch.where(inb, R1w[:, 0], 0.0)
    b2w = torch.where(inb, R1w[:, 1], 0.0)
    dx = flow[:, 0]
    dy = flow[:, 1]
    r2 = (R0[:, 0] - b1w) * 0.5 + r4 * dx + r6 * dy
    r3 = (R0[:, 1] - b2w) * 0.5 + r6 * dx + r5 * dy

    taper = _mat(_border_taper, H, W, device=R0.device)[None]
    r2 = r2 * taper
    r3 = r3 * taper
    r4 = r4 * taper
    r5 = r5 * taper
    r6 = r6 * taper

    g11 = r4 * r4 + r6 * r6
    g12 = (r4 + r5) * r6
    g22 = r5 * r5 + r6 * r6
    h1 = r4 * r2 + r6 * r3
    h2 = r6 * r2 + r5 * r3
    return torch.stack([g11, g12, g22, h1, h2], dim=1)


def _solve_flow(mblur: torch.Tensor) -> torch.Tensor:
    """Regularized per-pixel 2×2 solve on [B,5,H,W] → [B,2,H,W] flow."""
    return blur_solve_k.solve_flow(mblur)


def _blur_solve(M: torch.Tensor, winsize: int) -> torch.Tensor:
    """flow = solve(box_blur(M)) on [B,5,H,W] — the fused kernel on CUDA at
    every pyramid level, its plain version on the CPU."""
    return blur_solve_k.box_blur_solve(M, winsize)


# ---------------------------------------------------------------------------
# full pipeline
# ---------------------------------------------------------------------------

def farneback_flow(prev: torch.Tensor, cur: torch.Tensor,
                   pyr_scale: float = 0.5, levels: int = 3,
                   winsize: int = 15, iterations: int = 3,
                   poly_n: int = 5, poly_sigma: float = 1.2,
                   fused_iter: bool = False,
                   flow_bf16: bool = False) -> torch.Tensor:
    """Batched Farnebäck flow: two [B, H, W] f32 stacks → [B, H, W, 2].

    Semantics match cv2.calcOpticalFlowFarneback with flags=0 (box-filter
    aggregation, no initial flow).  With ``fused_iter`` each solver round
    is one fused warp+update+blur+solve call (``AVD_PALLAS_ITER=1`` in the
    JAX package) at every level; levels under 16 px raise.  With
    ``flow_bf16`` (``AVD_FLOW_BF16=1``) R0 and R1 are stored in bfloat16
    before the rounds and M after each update; every sum stays f32.  The
    fused round ignores it, as the JAX package's does.
    """
    B, H, W = prev.shape
    dev = prev.device
    flow = None
    for scale, sigma, ksize, lh, lw in _level_plan(H, W, pyr_scale, levels):
        # per-level smooth + downscale as ONE composed matrix per axis
        gk = tuple(float(x) for x in _gaussian_blur_kernel(ksize, sigma))
        rm = _mat(band.blur_resize_matrix, H, lh, gk, device=dev)
        cm = _mat(band.blur_resize_matrix, W, lw, gk, device=dev)
        R0 = poly_expansion(band.apply_separable(prev, rm, cm),
                            poly_n, poly_sigma)
        R1 = poly_expansion(band.apply_separable(cur, rm, cm),
                            poly_n, poly_sigma)

        if flow is None:
            flow = torch.zeros((B, 2, lh, lw), dtype=torch.float32,
                               device=dev)
        else:
            up = _resize_bilinear(
                flow.reshape(B * 2, *flow.shape[2:4]), lh, lw)
            flow = up.reshape(B, 2, lh, lw) * (1.0 / pyr_scale)

        # first solve from the incoming flow's matrices, then
        # (iterations-1) refinement rounds
        if flow_bf16 and not fused_iter:
            R0 = R0.to(torch.bfloat16)
            R1 = R1.to(torch.bfloat16)
        for _ in range(iterations):
            if fused_iter:
                flow = flow_iter_k.solve_iteration(R0, R1, flow, winsize)
                continue
            M = _update_matrices(R0, R1, flow)
            if flow_bf16:
                M = M.to(torch.bfloat16)
            flow = _blur_solve(M, winsize)
    # external contract stays [B, H, W, 2]
    return flow.permute(0, 2, 3, 1)


def flow_magnitude_stats(flow: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-pair mean and population variance of |flow| — the only flow
    quantities the reference consumes (video.py:45-48)."""
    mag = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    mean = mag.mean(dim=(-2, -1))
    var = ((mag - mean[..., None, None]) ** 2).mean(dim=(-2, -1))
    return mean, var
