"""Plain numpy host preprocessing of BGR uint8 frames, integer-exact.

A frozen copy of the port's plain version (``ops/host_prep.py`` as of the
benchmark's first commit): cv2's fixed-point grayscale, the full-size
Laplacian variance from exact int64 sums, the 32×32 ``Area32`` bins, the
320×320 INTER_LINEAR u8 plane, and INTER_AREA to the detector's input.
It imports nothing of the program, so a later change to the program's
host prep is judged against this.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os

import numpy as np

FLOW_SIZE = 320
HASH_SIZE = 32
_COEF = 2048


def to_gray(frame_bgr: np.ndarray) -> np.ndarray:
    f = frame_bgr.astype(np.int32)
    acc = f[..., 2] * 9798 + f[..., 1] * 19235 + f[..., 0] * 3735 + (1 << 14)
    return (acc >> 15).astype(np.uint8)


def laplacian_var(gray: np.ndarray) -> float:
    h, w = gray.shape
    p = np.pad(gray.astype(np.int32), 1, mode="reflect")  # reflect-101
    lap = (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:]
           - 4 * p[1:-1, 1:-1])
    s = int(lap.sum(dtype=np.int64))
    s2 = int(np.square(lap).sum(dtype=np.int64))
    n = float(h) * w
    mean = float(s) / n
    return float(s2) / n - mean * mean


@functools.lru_cache(maxsize=16)
def _area_plan(h: int, w: int):
    k = HASH_SIZE
    sy = h / k
    sx = w / k
    px0 = np.empty(k, np.int64)
    px1 = np.empty(k, np.int64)
    w0 = np.empty(k, np.float64)
    w1 = np.empty(k, np.float64)
    for ox in range(k):
        lo = ox * sx
        hi = (ox + 1) * sx
        p0 = int(np.floor(lo))
        p1 = min(int(np.ceil(hi)) - 1, w - 1)
        if p1 == p0:
            px0[ox], px1[ox], w0[ox], w1[ox] = p0, p1, hi - lo, 0.0
        else:
            px0[ox], px1[ox] = p0, p1
            w0[ox] = (p0 + 1) - lo
            w1[ox] = hi - p1
    rows = []
    for y in range(h):
        oy = min(int(y / sy), k - 1)
        rsplit = (oy + 1) * sy
        if float(y + 1) <= rsplit or oy == k - 1:
            rows.append((y, oy, None))
        else:
            rows.append((y, oy, rsplit - y))
    single = px1 == px0
    integer_ratio = (h % k == 0) and (w % k == 0)
    return px0, px1, w0, w1, single, rows, 1.0 / (sy * sx), integer_ratio


def area32(gray: np.ndarray) -> np.ndarray:
    h, w = gray.shape
    px0, px1, w0, w1, single, rows, inv_area, integer_ratio = \
        _area_plan(h, w)
    g = gray.astype(np.int64)
    cs = np.zeros((h, w + 1), np.int64)
    np.cumsum(g, axis=1, out=cs[:, 1:])
    run = (cs[:, np.maximum(px1, px0 + 1)] - cs[:, px0 + 1]).astype(np.float64)
    g0 = g[:, px0].astype(np.float64)
    g1 = g[:, px1].astype(np.float64)
    col = np.where(single, g0 * w0, (run + g0 * w0) + g1 * w1)
    band = np.zeros((HASH_SIZE, HASH_SIZE), np.float64)
    for y, oy, top in rows:
        if top is None:
            band[oy] += col[y]
        else:
            band[oy] += col[y] * top
            if oy + 1 < HASH_SIZE:
                band[oy + 1] += col[y] * (1.0 - top)
    v = band * inv_area
    r = np.floor(v + 0.5) if integer_ratio else np.rint(v)
    return np.clip(r, 0, 255).astype(np.uint8)


@functools.lru_cache(maxsize=32)
def linear_coeffs(src: int, dst: int, area_mode: bool = False):
    d = np.arange(dst)
    if area_mode:
        x = np.floor(d * (src / dst)).astype(np.int64)
        f = ((d + 1) - (x + 1) * (dst / src)).astype(np.float32)
        frac = np.where(f <= 0, np.float32(0), f - np.floor(f))
        frac = np.where(x >= src - 1, np.float32(0), frac).astype(np.float32)
    else:
        fx = ((d + 0.5) * (src / dst) - 0.5).astype(np.float32)
        x = np.floor(fx)
        frac = (fx - x).astype(np.float32)
        x = x.astype(np.int64)
    a1 = np.rint(frac * np.float32(_COEF)).astype(np.int32)
    return (np.clip(x, 0, src - 1), np.clip(x + 1, 0, src - 1),
            _COEF - a1, a1)


def _linear_u8(img: np.ndarray, ycoef, xcoef) -> np.ndarray:
    cx0, cx1, ax0, ax1 = xcoef
    cy0, cy1, by0, by1 = ycoef
    tail = (1,) * (img.ndim - 2)
    ax0, ax1 = ax0.reshape(-1, *tail), ax1.reshape(-1, *tail)
    by0, by1 = by0.reshape(-1, 1, *tail), by1.reshape(-1, 1, *tail)
    r0 = img[cy0].astype(np.int32)
    r1 = img[cy1].astype(np.int32)
    s0 = ax0 * r0[:, cx0] + ax1 * r0[:, cx1]
    s1 = ax0 * r1[:, cx0] + ax1 * r1[:, cx1]
    v = ((by0 * (s0 >> 4)) >> 16) + ((by1 * (s1 >> 4)) >> 16)
    return np.clip((v + 2) >> 2, 0, 255).astype(np.uint8)


def lin320(gray: np.ndarray) -> np.ndarray:
    h, w = gray.shape
    return _linear_u8(gray, linear_coeffs(h, FLOW_SIZE),
                      linear_coeffs(w, FLOW_SIZE))


def _area_taps(src: int, dst: int):
    scale = src / dst
    rows = []
    for d in range(dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, src - f1)
        s1 = int(np.ceil(f1))
        s2 = min(int(np.floor(f2)), src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps.extend((s, 1.0 / cell) for s in range(s1, s2))
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((dst, k), np.int64)
    wgt = np.zeros((dst, k), np.float32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j] = s
            wgt[d, j] = np.float32(a)
    return idx, wgt


def _area_down(img: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    if h % dst_h == 0 and w % dst_w == 0:
        sy, sx = h // dst_h, w // dst_w
        sums = img.reshape(dst_h, sy, dst_w, sx, -1).sum(axis=(1, 3),
                                                         dtype=np.int32)
        if sy == 2 and sx == 2:
            return ((sums + 2) >> 2).astype(np.uint8)
        scale = np.float32(1.0) / np.float32(sy * sx)
        return np.clip(np.rint(sums.astype(np.float32) * scale), 0,
                       255).astype(np.uint8)
    xi, xw = _area_taps(w, dst_w)
    yi, yw = _area_taps(h, dst_h)

    def xtap(j):
        t = np.take(img, xi[:, j], axis=1).astype(np.float32)
        return np.multiply(t, xw[:, j, None], out=t)

    buf = xtap(0)
    for j in range(1, xi.shape[1]):
        buf += xtap(j)
    out = buf[yi[:, 0]] * yw[:, 0, None, None]
    for j in range(1, yi.shape[1]):
        out += buf[yi[:, j]] * yw[:, j, None, None]
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def resize_area_frame(img: np.ndarray, dst_h: int, dst_w: int) -> np.ndarray:
    h, w = img.shape[:2]
    if (h, w) == (dst_h, dst_w):
        return img.copy()
    if h >= dst_h and w >= dst_w:
        return _area_down(img, dst_h, dst_w)
    return _linear_u8(img, linear_coeffs(h, dst_h, True),
                      linear_coeffs(w, dst_w, True))


def map_frames(work, n: int) -> list:
    """``[work(i) for i in range(n)]`` over the host's cores."""
    workers = max(1, min(os.cpu_count() or 1, n))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(work, range(n)))


def prep(frames_bgr: np.ndarray):
    """[N, H, W, 3] → (flow planes [N,320,320] u8, hash planes [N,32,32]
    u8, textures [N] float64)."""
    def work(i):
        g = to_gray(frames_bgr[i])
        return lin320(g), area32(g), laplacian_var(g)

    out = map_frames(work, frames_bgr.shape[0])
    return (np.stack([o[0] for o in out]), np.stack([o[1] for o in out]),
            np.array([o[2] for o in out], np.float64))


def resize_area(frames_bgr: np.ndarray, size: int) -> np.ndarray:
    """[N, H, W, 3] → [N, size, size, 3] uint8, cv2 INTER_AREA."""
    out = map_frames(lambda i: resize_area_frame(frames_bgr[i], size, size),
                     frames_bgr.shape[0])
    return np.stack(out)
