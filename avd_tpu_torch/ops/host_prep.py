"""Host preprocessing of BGR frames: integer-exact.

The counterpart of ``avd_tpu/ops/video_features._host_prep``.
``host_prep`` runs the port's C++ host runtime (``avd_tpu_torch/native``):
one fused ``prep320_bgr`` sweep when both sides exceed 320, else native
gray and ``lap_area32`` plus the numpy ``lin320`` below (the C++ sweep
declines upscale).  ``host_prep_plain`` is the same function in numpy
alone, the plain version the tests hold the library against; it runs on
the main path only under ``AVD_NATIVE=0``.  Per frame both produce:

* the full-resolution Laplacian variance (cv2.Laplacian(CV_64F).var():
  ksize-1 stencil, reflect-101 borders, exact int64 sums);
* the 32×32 INTER_AREA bins (``Area32``: integer-ratio round-half-up,
  fractional-ratio ``nearbyint``, float64 in the C++ operation order);
* the 320×320 INTER_LINEAR plane (cv2's u8 fixed-point pipeline).

Grayscale is cv2's fixed point ``(R·9798 + G·19235 + B·3735 + 2¹⁴) >> 15``.

The bilinear coefficients clamp the source index but keep the fraction
(a source row −1 reads row 0 with its own weight).  That is cv2's rule: on
downscale no index is ever clamped, and on upscale it reproduces cv2 5.0
bit for bit, where clamping the fraction as well (the C++ path, which
declines upscale) is off by one gray level on the first and last rows.

``resize_area`` is cv2's ``resize(..., INTER_AREA)`` for 3-channel u8
frames and any target size (the detector's input prep,
``models/scoring.resize_frames``): the float32 tap tables of cv2's area
resize on a fractional downscale, its integer block sums on an integer
one, and cv2's
"area-mode" bilinear through the same u8 fixed-point pipeline as the 320²
plane when either axis grows.  The 32×32 ``area32`` above keeps the
float64 semantics of the C++ host runtime and is not replaced by it.

Frames are processed in parallel threads (numpy releases the GIL in its
array loops); every output is a pure function of its frame.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os

import numpy as np

FLOW_SIZE = 320  # reference flow resolution (video.py:43)
HASH_SIZE = 32   # reference hash resolution (video.py:4)
_COEF = 2048     # cv2 INTER_RESIZE_COEF_SCALE


def to_gray(frame_bgr: np.ndarray) -> np.ndarray:
    """[H, W, 3] BGR uint8 → [H, W] uint8, cv2 fixed point."""
    f = frame_bgr.astype(np.int32)
    acc = f[..., 2] * 9798 + f[..., 1] * 19235 + f[..., 0] * 3735 + (1 << 14)
    return (acc >> 15).astype(np.uint8)


def laplacian_var(gray: np.ndarray) -> float:
    """cv2.Laplacian(gray, CV_64F).var() from exact int64 sums."""
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
    """Column spans and the per-row distribution of ``Area32``
    (avd_native.cc ``Area32::init``/``add_row``)."""
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
        p1 = int(np.ceil(hi)) - 1
        if p1 >= w:
            p1 = w - 1
        if p1 == p0:
            px0[ox], px1[ox], w0[ox], w1[ox] = p0, p1, hi - lo, 0.0
        else:
            px0[ox], px1[ox] = p0, p1
            w0[ox] = (p0 + 1) - lo
            w1[ox] = hi - p1
    rows = []  # (y, oy, top or None)
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
    """[H, W] uint8 (H, W >= 32) → [32, 32] uint8, ``Area32`` exact."""
    h, w = gray.shape
    px0, px1, w0, w1, single, rows, inv_area, integer_ratio = \
        _area_plan(h, w)
    g = gray.astype(np.int64)
    cs = np.zeros((h, w + 1), np.int64)
    np.cumsum(g, axis=1, out=cs[:, 1:])
    # run = Σ row[p0+1 .. p1-1]; col = (run + row[p0]·w0) + row[p1]·w1
    run = (cs[:, np.maximum(px1, px0 + 1)] - cs[:, px0 + 1]).astype(np.float64)
    g0 = g[:, px0].astype(np.float64)
    g1 = g[:, px1].astype(np.float64)
    col = np.where(single, g0 * w0, (run + g0 * w0) + g1 * w1)
    band = np.zeros((HASH_SIZE, HASH_SIZE), np.float64)
    for y, oy, top in rows:  # sequential float64 sums, C++ order
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
    """cv2 INTER_LINEAR u8 coefficients for ``src`` → ``dst``: source
    indices (clamped) of the two taps and their 11-bit weights.
    ``area_mode`` takes the tap positions cv2 uses when INTER_AREA is asked
    to enlarge (left-aligned cells instead of pixel centres)."""
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
    """[H, W] or [H, W, C] uint8 through cv2's u8 bilinear pipeline:
    horizontal taps in int32, then
    ((b0·(S0>>4))>>16) + ((b1·(S1>>4))>>16), then (v + 2) >> 2."""
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
    """[H, W] uint8 → [320, 320] uint8, cv2 INTER_LINEAR bit-exact."""
    h, w = gray.shape
    return _linear_u8(gray, linear_coeffs(h, FLOW_SIZE),
                      linear_coeffs(w, FLOW_SIZE))


@functools.lru_cache(maxsize=32)
def _area_taps(src: int, dst: int):
    """cv2's area-resize table for one axis (``computeResizeAreaTab``) as
    dense [dst, K] arrays: source index and float32 weight of each tap in
    source order, zero-weight padding at the end of the shorter rows."""
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
    """[H, W, C] uint8 → [dst_h, dst_w, C] uint8, neither axis growing.

    Integer ratios on both axes take cv2's ``resizeAreaFast_``: exact
    integer block sums times float32 1/area, round-half-even (2×2 blocks:
    (a+b+c+d+2)>>2).  Otherwise ``resizeArea_`` in its float32 order: per
    source row the horizontal taps summed left to right, then the rows top
    to bottom, then round-half-even."""
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
    """One [H, W, C] uint8 frame → [dst_h, dst_w, C] uint8 as
    ``cv2.resize(img, (dst_w, dst_h), interpolation=cv2.INTER_AREA)``."""
    h, w = img.shape[:2]
    if (h, w) == (dst_h, dst_w):
        return img.copy()
    if h >= dst_h and w >= dst_w:
        return _area_down(img, dst_h, dst_w)
    return _linear_u8(img, linear_coeffs(h, dst_h, True),
                      linear_coeffs(w, dst_w, True))


def resize_area(frames: np.ndarray, dst_h: int, dst_w: int,
                threads: int | None = None) -> np.ndarray:
    """[N, H, W, C] uint8 → [N, dst_h, dst_w, C] uint8, cv2 INTER_AREA."""
    n = frames.shape[0]
    out = np.empty((n, dst_h, dst_w) + frames.shape[3:], np.uint8)

    def work(i):
        out[i] = resize_area_frame(frames[i], dst_h, dst_w)

    _map_frames(work, n, threads)
    return out


def _map_frames(work, n: int, threads: int | None) -> None:
    """Run ``work(i)`` for every frame, in threads when there are several."""
    workers = min(threads or os.cpu_count() or 1, n)
    if workers > 1:
        with concurrent.futures.ThreadPoolExecutor(workers) as pool:
            list(pool.map(work, range(n)))
    else:
        for i in range(n):
            work(i)


def prep_frame(frame_bgr: np.ndarray):
    """One BGR frame → (320² u8, 32² u8, Laplacian variance)."""
    gray = to_gray(frame_bgr)
    return lin320(gray), area32(gray), laplacian_var(gray)


def _check_size(frames_bgr: np.ndarray) -> None:
    h, w = frames_bgr.shape[1:3]
    if h < HASH_SIZE or w < HASH_SIZE:
        raise ValueError(f"host prep needs frames of at least "
                         f"{HASH_SIZE}×{HASH_SIZE}, got {h}×{w}")


def host_prep(frames_bgr: np.ndarray, threads: int | None = None,
              native: bool = True):
    """[N, H, W, 3] BGR uint8 → (flow_input [N,320,320] u8,
    hash_input [N,32,32] u8, tex [N] f64); H, W >= 32.  ``native=False``
    (``AVD_NATIVE=0``) runs ``host_prep_plain``."""
    if not native:
        return host_prep_plain(frames_bgr, threads)
    from avd_tpu_torch import native as native_mod
    _check_size(frames_bgr)
    fused = native_mod.prep320_bgr(frames_bgr, threads)
    if fused is not None:
        tex, s32, s320 = fused
        return s320, s32, tex
    gray = native_mod.bgr_to_gray(frames_bgr, threads)
    tex, s32 = native_mod.lap_area32(gray, threads)
    s320 = np.empty((gray.shape[0], FLOW_SIZE, FLOW_SIZE), np.uint8)

    def work(i):
        s320[i] = lin320(gray[i])

    _map_frames(work, gray.shape[0], threads)
    return s320, s32, tex


def host_prep_plain(frames_bgr: np.ndarray, threads: int | None = None):
    """``host_prep`` in numpy alone, frame by frame in threads."""
    _check_size(frames_bgr)
    n = frames_bgr.shape[0]
    s320 = np.empty((n, FLOW_SIZE, FLOW_SIZE), np.uint8)
    s32 = np.empty((n, HASH_SIZE, HASH_SIZE), np.uint8)
    tex = np.empty(n, np.float64)

    def work(i):
        s320[i], s32[i], tex[i] = prep_frame(frames_bgr[i])

    _map_frames(work, n, threads)
    return s320, s32, tex
