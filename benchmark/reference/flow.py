"""Plain PyTorch Farnebäck flow and the per-pair video features, float32.

A frozen copy of the port's plain versions (``ops/flow.py``, ``band.py``,
``resize.py``, the plain warp and blur+solve of ``ops/kernels``, and
``hashing.py``): cv2.calcOpticalFlowFarneback(prev, cur, None, 0.5, 3, 15,
3, 5, 1.2, 0) as banded matmuls, a corner gather and shifted box sums,
with no kernel of the program.  TF32 is switched off before any product.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

FLOW_SIZE = 320
WINSIZE = 15
_BORDER_SCALE = np.array((0.14, 0.14, 0.4472, 0.4472, 0.4472), np.float32)
_COEF_SCALE = 2048.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --------------------------------------------------------------- host tables

def _fold_index(p: int, size: int, mode: str) -> int:
    if mode == "edge":
        return min(max(p, 0), size - 1)
    if size == 1:
        return 0
    period = 2 * size - 2
    p %= period
    return p if p < size else period - p


@functools.lru_cache(maxsize=128)
def correlate_matrix(size: int, kernel: tuple, mode: str) -> np.ndarray:
    k = np.asarray(kernel, np.float64)
    n = (len(k) - 1) // 2
    m = np.zeros((size, size), np.float64)
    for i in range(size):
        for j, kj in enumerate(k):
            m[i, _fold_index(i + j - n, size, mode)] += kj
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def linear_matrix(src: int, dst: int, quantize: bool = True) -> np.ndarray:
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
def blur_resize_matrix(src: int, dst: int, kernel: tuple) -> np.ndarray:
    blur = correlate_matrix(src, kernel, "reflect").astype(np.float64)
    rs = linear_matrix(src, dst, quantize=False).astype(np.float64)
    return (rs @ blur).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _poly_exp_kernels(n: int, sigma: float):
    k = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(k ** 2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = k * g
    xxg = (k ** 2) * g
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
    inv = np.linalg.inv(G)
    return (g.astype(np.float32), xg.astype(np.float32),
            xxg.astype(np.float32), float(inv[1, 1]), float(inv[0, 3]),
            float(inv[3, 3]), float(inv[5, 5]))


def _gaussian_blur_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel, with its fixed table for sigma <= 0."""
    small_tab = {1: [1.0], 3: [0.25, 0.5, 0.25],
                 5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
                 7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875,
                     0.109375, 0.03125]}
    if sigma <= 0 and ksize in small_tab:
        return np.asarray(small_tab[ksize], np.float32)
    s = sigma if sigma > 0 else 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    kern = np.exp(-(x ** 2) / (2.0 * s * s))
    kern /= kern.sum()
    return kern.astype(np.float32)


def _cv_round(x: float) -> int:
    f = math.floor(x)
    d = x - f
    if d < 0.5:
        return f
    if d > 0.5:
        return f + 1
    return f if f % 2 == 0 else f + 1


@functools.lru_cache(maxsize=32)
def _border_taper(h: int, w: int) -> np.ndarray:
    sx = np.ones(w, np.float32)
    sy = np.ones(h, np.float32)
    for i in range(min(5, w)):
        sx[i] *= _BORDER_SCALE[i]
        sx[w - 1 - i] *= _BORDER_SCALE[i]
    for i in range(min(5, h)):
        sy[i] *= _BORDER_SCALE[i]
        sy[h - 1 - i] *= _BORDER_SCALE[i]
    return sy[:, None] * sx[None, :]


def _level_plan(h: int, w: int, pyr_scale: float = 0.5, levels: int = 3):
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
        plan.append((sigma, ksize, _cv_round(h * scale), _cv_round(w * scale)))
    return plan


class _Mats:
    """The host tables as float32 tensors on one device, made once."""

    def __init__(self, device):
        self.device = device
        self._cache = {}

    def get(self, builder, *args) -> torch.Tensor:
        key = (builder.__name__,) + args
        t = self._cache.get(key)
        if t is None:
            t = torch.from_numpy(np.ascontiguousarray(builder(*args))).to(
                self.device)
            self._cache[key] = t
        return t


# ------------------------------------------------------------ device pieces

def _poly_expansion(img: torch.Tensor, mats: _Mats) -> torch.Tensor:
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_kernels(5, 1.2)
    h, w = img.shape[-2:]
    tg, txg, txxg = (tuple(float(v) for v in k) for k in (g, xg, xxg))
    kvg, kvx, kvxx = (mats.get(correlate_matrix, h, t, "edge")
                      for t in (tg, txg, txxg))
    khg, khx, khxx = (mats.get(correlate_matrix, w, t, "edge")
                      for t in (tg, txg, txxg))
    vg = torch.matmul(kvg, img)
    vx = torch.matmul(kvx, img)
    vxx = torch.matmul(kvxx, img)
    b1 = torch.matmul(vg, khg.T)
    b2 = torch.matmul(vg, khx.T)
    b3 = torch.matmul(vx, khg.T)
    b4 = torch.matmul(vg, khxx.T)
    b5 = torch.matmul(vxx, khg.T)
    b6 = torch.matmul(vx, khx.T)
    return torch.stack([b2 * ig11, b3 * ig11, b1 * ig03 + b4 * ig33,
                        b1 * ig03 + b5 * ig33, b6 * ig55], dim=1)


def _in_bounds(flow: torch.Tensor) -> torch.Tensor:
    H, W = flow.shape[2:4]
    xs = torch.arange(W, dtype=torch.float32, device=flow.device)[None, None]
    ys = torch.arange(H, dtype=torch.float32,
                      device=flow.device)[None, :, None]
    x1 = torch.floor(xs + flow[:, 0])
    y1 = torch.floor(ys + flow[:, 1])
    return (x1 >= 0) & (x1 <= W - 2) & (y1 >= 0) & (y1 <= H - 2)


def warp(src: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Bilinear warp of [B,5,H,W] by [B,2,H,W]; 0 outside the OpenCV
    in-bounds rule."""
    B, C, H, W = src.shape
    xs = torch.arange(W, dtype=torch.float32, device=src.device)[None, None]
    ys = torch.arange(H, dtype=torch.float32, device=src.device)[None, :, None]
    fx = xs + flow[:, 0]
    fy = ys + flow[:, 1]
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    inb = (x1 >= 0) & (x1 <= W - 2) & (y1 >= 0) & (y1 <= H - 2)
    a = fx - x1
    b = fy - y1
    base = torch.where(inb, y1 * W + x1, 0.0).to(torch.int64)
    flat = src.float().reshape(B, C, H * W)

    def corner(off: int) -> torch.Tensor:
        idx = (base + off).reshape(B, 1, H * W).expand(B, C, H * W)
        return torch.gather(flat, 2, idx).reshape(B, C, H, W)

    out = (((1 - b) * (1 - a))[:, None] * corner(0)
           + ((1 - b) * a)[:, None] * corner(1)
           + (b * (1 - a))[:, None] * corner(W)
           + (b * a)[:, None] * corner(W + 1))
    return torch.where(inb[:, None], out, 0.0)


def _update(R0, R1w, flow, mats: _Mats) -> torch.Tensor:
    H, W = R0.shape[2:4]
    inb = _in_bounds(flow)
    r4 = torch.where(inb, (R0[:, 2] + R1w[:, 2]) * 0.5, R0[:, 2])
    r5 = torch.where(inb, (R0[:, 3] + R1w[:, 3]) * 0.5, R0[:, 3])
    r6 = torch.where(inb, (R0[:, 4] + R1w[:, 4]) * 0.25, R0[:, 4] * 0.5)
    b1w = torch.where(inb, R1w[:, 0], 0.0)
    b2w = torch.where(inb, R1w[:, 1], 0.0)
    dx = flow[:, 0]
    dy = flow[:, 1]
    r2 = (R0[:, 0] - b1w) * 0.5 + r4 * dx + r6 * dy
    r3 = (R0[:, 1] - b2w) * 0.5 + r6 * dx + r5 * dy
    taper = mats.get(_border_taper, H, W)[None]
    r2, r3, r4, r5, r6 = (r * taper for r in (r2, r3, r4, r5, r6))
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6,
                        r5 * r5 + r6 * r6, r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3], dim=1)


def blur_solve(m: torch.Tensor, winsize: int = WINSIZE) -> torch.Tensor:
    """Replicate-edge box mean of M, then the regularised 2×2 solve."""
    B, C, H, W = m.shape
    half = (winsize - 1) // 2
    p = F.pad(m.reshape(B * C, 1, H, W), (half, half, half, half),
              mode="replicate").reshape(B, C, H + 2 * half, W + 2 * half)
    hs = p[..., 0:W]
    for k in range(1, winsize):
        hs = hs + p[..., k:k + W]
    vs = hs[..., 0:H, :]
    for j in range(1, winsize):
        vs = vs + hs[..., j:j + H, :]
    g11, g12, g22, h1, h2 = (vs * (1.0 / (winsize * winsize))).unbind(1)
    idet = 1.0 / (g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g22 * h1 - g12 * h2) * idet,
                        (g11 * h2 - g12 * h1) * idet], dim=1)


def farneback(prev: torch.Tensor, cur: torch.Tensor, mats: _Mats,
              dtype=torch.float32) -> torch.Tensor:
    """[B,H,W] f32 pairs → [B,2,H,W] flow.  ``dtype`` is where the fields
    are stored between steps (float32; bfloat16 for the control)."""
    B, H, W = prev.shape
    flow = None
    for sigma, ksize, lh, lw in _level_plan(H, W):
        gk = tuple(float(x) for x in _gaussian_blur_kernel(ksize, sigma))
        rm = mats.get(blur_resize_matrix, H, lh, gk)
        cm = mats.get(blur_resize_matrix, W, lw, gk)
        R0 = _poly_expansion(torch.matmul(torch.matmul(rm, prev), cm.T), mats)
        R1 = _poly_expansion(torch.matmul(torch.matmul(rm, cur), cm.T), mats)
        if flow is None:
            flow = torch.zeros((B, 2, lh, lw), dtype=torch.float32,
                               device=prev.device)
        else:
            sh, sw = flow.shape[2:4]
            up = torch.matmul(torch.matmul(
                mats.get(linear_matrix, sh, lh, False),
                flow.reshape(B * 2, sh, sw)),
                mats.get(linear_matrix, sw, lw, False).T)
            flow = up.reshape(B, 2, lh, lw) * 2.0
        R0 = R0.to(dtype).float()
        R1 = R1.to(dtype).float()
        for _ in range(3):
            M = _update(R0, warp(R1, flow), flow, mats)
            flow = blur_solve(M.to(dtype).float())
    return flow


def magnitude_stats(flow: torch.Tensor):
    """Per-pair mean and population variance of |flow| ([B,2,H,W])."""
    mag = torch.sqrt(flow[:, 0] ** 2 + flow[:, 1] ** 2)
    mean = mag.mean(dim=(-2, -1))
    var = ((mag - mean[:, None, None]) ** 2).mean(dim=(-2, -1))
    return mean, var


def hamming(s32: np.ndarray) -> np.ndarray:
    """Hamming distances of consecutive 32×32 average hashes ([N] → [N-1]),
    float64 mean and >= as the reference analyzer."""
    g = s32.reshape(s32.shape[0], -1).astype(np.float64)
    bits = g >= g.mean(axis=1, keepdims=True)
    return (bits[1:] != bits[:-1]).sum(axis=1)


def pair_features(s320: np.ndarray, device, block: int = 48,
                  dtype=torch.float32):
    """(fmean, fvar) float64 arrays of the N-1 consecutive pairs of the
    [N, 320, 320] u8 planes, computed in blocks of ``block`` pairs."""
    no_tf32()
    mats = _Mats(device)
    means, vars_ = [], []
    n = s320.shape[0]
    for s in range(0, n - 1, block):
        e = min(n - 1, s + block)
        f = torch.from_numpy(s320[s:e + 1]).to(device).float()
        m, v = magnitude_stats(farneback(f[:-1], f[1:], mats, dtype))
        means.append(m.double().cpu().numpy())
        vars_.append(v.double().cpu().numpy())
    return np.concatenate(means), np.concatenate(vars_)
