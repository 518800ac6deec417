"""Batched per-frame video features on the GPU.

Port of ``avd_tpu/ops/video_features.py``.  Per window of sampled frames
the pipeline produces only per-frame scalars:

    texture[k]     Laplacian variance at full resolution
    hamming[k]     Hamming distance between consecutive 32×32 avg-hashes
    flow_mean[k]   mean |Farnebäck flow| on 320×320 gray, pair (k, k+1)
    flow_var[k]    population variance of |flow| per pair

Two preprocessing placements (``AVD_PREP``, ``config.prep_mode``):

``host`` (default)
    The host makes the 320² flow planes, the 32² hash planes and the
    texture (``ops/host_prep.py``: the C++ host runtime unless
    ``AVD_NATIVE=0``); the device runs hashing and the batched Farnebäck
    flow over every pair of a window (``_prep_body``).  Each window ships
    as ONE u8 vector through pinned host memory (``non_blocking``).
``device``
    Full-resolution gray (native on the host) ships to the device; the
    resizes are fp32 matmuls and the Laplacian a stencil there
    (``_feature_body``).  About 2 MB a frame at 1080p.

Clips longer than the chunk stream through windows with a one-frame
lead-in; tails round up to quarter-chunk buckets.  Window results stay on
the device and all of them come back in one device→host fetch at the end,
so host work on window k+1 overlaps the device work of window k.  In
host-prep mode each window's copy and launches run on the dispatch
thread (``_dispatch_pool``), so decode and host prep of the next chunk
also overlap the enqueue of this one.  A
caller that passes a batcher to ``compute_features_streaming`` (serving
with ``AVD_BATCH_WINDOW_MS > 0``, ``serve/batching.py``) has every window
run there instead: the batcher stacks the full host-prep windows of
concurrent requests into one ``run_prep_windows`` call.

``AVD_CHANGE_GATE=1`` (``compute_features`` only) hashes on the host and
runs the flow only for the pairs whose 320² planes changed
(``_compute_features_gated``).  In a rank group, ``compute_features``
with host prep shards the clip's pairs over the ranks' time axis with a
one-frame halo (``cp_pairs``, ``parallel/halo.py``); the
streaming path keeps one device, as in ``avd_tpu``.  Aggregation runs on
the host in float64 (``oracle/video_ref.summarize``).
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
from typing import Dict

import numpy as np
import torch

from avd_tpu_torch import config as config_mod
from avd_tpu_torch import device as device_mod
from avd_tpu_torch import native
from avd_tpu_torch.oracle import video_ref
from avd_tpu_torch.ops import flow, hashing, laplacian, resize
from avd_tpu_torch.ops import host_prep as host_prep_mod

# Frames per device chunk (excluding the 1-frame lead-in): AVD_VIDEO_CHUNK,
# read once at import as avd_tpu reads it (avd_tpu/ops/video_features.py:45).
_DEFAULT_CHUNK = int(os.getenv("AVD_VIDEO_CHUNK", "48"))

_FLOW_SIZE = host_prep_mod.FLOW_SIZE
_HASH_SIZE = host_prep_mod.HASH_SIZE

# True once a device window has completed in this process.  The first one
# pays the kernels' build and the libraries' start-up, so the pipeline's
# analyzer timeout grants a cold-start grace until this flips
# (pipeline._analyzer_timeout); the CLI and serving warm up first.
_DEVICE_WARM = False


def device_warmed() -> bool:
    return _DEVICE_WARM


def mark_device_warm() -> None:
    global _DEVICE_WARM
    _DEVICE_WARM = True


def warm_device(device=None, log=None) -> None:
    """Build every kernel (on CUDA) and run every window bucket of the
    chunk in force (``AVD_VIDEO_CHUNK``) once on zero planes on ``device``
    (default CUDA), waiting for it, so the kernels' build and first
    launches happen here instead of inside a timed analyzer call.

    No-op when already warm, and under ``AVD_PREP=device``, whose window
    shapes hold the clip's resolution; there the first request runs under
    the cold-start grace and flips the flag when its windows complete."""
    dev = device_mod.resolve(device)
    if _DEVICE_WARM or config_mod.get_config().prep_mode != "host":
        return
    if dev.type == "cuda":  # one nvcc per source, all at once
        from avd_tpu_torch.ops.kernels import _build
        _build.build_all()
    outs = []
    for n in _window_buckets(_DEFAULT_CHUNK):
        if log is not None:
            log(f"warming {n}-frame device window...")
        outs.append(run_prep_window(
            np.zeros((n, _FLOW_SIZE, _FLOW_SIZE), np.uint8),
            np.zeros((n, _HASH_SIZE, _HASH_SIZE), np.uint8), dev))
    torch.cat(outs).cpu()  # one fetch: waits for every window
    mark_device_warm()


def _window_buckets(chunk: int):
    """Window lengths (incl. the 1-frame lead-in) the tail may round up to:
    quarter-chunk buckets cap the padding at chunk/4−1 frames per clip."""
    q = max(1, chunk // 4)
    return tuple(sorted({q + 1, 2 * q + 1, 3 * q + 1, chunk + 1}))


def _bucket_len(n_window: int, chunk: int) -> int:
    """Smallest bucketed window length >= n_window."""
    for b in _window_buckets(chunk):
        if n_window <= b:
            return b
    return chunk + 1


def _flow_stats(prev: torch.Tensor, cur: torch.Tensor, cfg):
    """Farnebäck flow over [B, 320, 320] f32 pairs → (fmean, fvar)."""
    fl = flow.farneback_flow(prev, cur, fused_iter=cfg.fused_flow_iter,
                             flow_bf16=cfg.flow_bf16)
    return flow.flow_magnitude_stats(fl)


def _prep_body(flow_u8: torch.Tensor, hash_u8: torch.Tensor, cfg):
    """Host-prep variant: pair features from pre-resized windows
    ([..., N, 320, 320] and [..., N, 32, 32] uint8, any leading stack of
    windows) → (ham [..., N-1] i32, fmean [..., N-1], fvar [..., N-1]).

    Pairs are formed inside each window (``prev = f[..., :-1]``, ``cur =
    f[..., 1:]``, then flattened): the last frame of one window is never
    paired with the first of the next.  The flow runs once over every
    pair of the stack."""
    lead, n = flow_u8.shape[:-3], flow_u8.shape[-3]
    bits = hashing.average_hash_bits(
        hash_u8.reshape(-1, _HASH_SIZE, _HASH_SIZE).float())
    ham = hashing.consecutive_hamming(bits.view(*lead, n, -1))
    fs = flow_u8.float()
    prev = fs[..., :-1, :, :].reshape(-1, _FLOW_SIZE, _FLOW_SIZE)
    cur = fs[..., 1:, :, :].reshape(-1, _FLOW_SIZE, _FLOW_SIZE)
    fmean, fvar = _flow_stats(prev, cur, cfg)
    return ham, fmean.view(*lead, n - 1), fvar.view(*lead, n - 1)


def _feature_body(gray_u8: torch.Tensor, cfg):
    """Device-prep variant: the full feature set of a [N, H, W] uint8 gray
    window → (tex [N], ham [N-1] i32, fmean [N-1], fvar [N-1]).  The
    resizes are fp32 products with ``ops/resize.py``'s matrices (TF32 is
    off: ``device.resolve``)."""
    _, h, w = gray_u8.shape
    dev = gray_u8.device
    area_r = resize.device_matrix(resize.area_matrix, (h, _HASH_SIZE), dev)
    area_c = resize.device_matrix(resize.area_matrix, (w, _HASH_SIZE), dev)
    lin_r = resize.device_matrix(resize.linear_matrix,
                                 (h, _FLOW_SIZE, True), dev)
    lin_c = resize.device_matrix(resize.linear_matrix,
                                 (w, _FLOW_SIZE, True), dev)
    gray = gray_u8.float()
    tex = laplacian.texture_variance(gray)
    small = torch.round(resize.resize_matmul(gray, area_r, area_c))
    ham = hashing.consecutive_hamming(hashing.average_hash_bits(small))
    fsmall = torch.clamp(torch.round(resize.resize_matmul(gray, lin_r,
                                                          lin_c)), 0.0, 255.0)
    fmean, fvar = _flow_stats(fsmall[:-1], fsmall[1:], cfg)
    return tex, ham, fmean, fvar


def _put(host: np.ndarray, device: torch.device) -> torch.Tensor:
    """One host→device copy of a u8 array (pinned, non-blocking on CUDA)."""
    t = torch.from_numpy(np.ascontiguousarray(host))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


def run_prep_windows(w320s: np.ndarray, w32s: np.ndarray,
                     device: torch.device, cfg=None) -> torch.Tensor:
    """Enqueue m host-prep windows of n frames at once ([m, n, 320, 320]
    and [m, n, 32, 32] uint8): one u8 host→device copy, then one
    ``_prep_body`` whose flow runs over all m·(n−1) pairs, so each kernel
    launch serves every window.  Returns [m, 3·(n−1)] float32 on the
    device, row i = ham ‖ fmean ‖ fvar of window i; nothing is fetched.
    The counterpart of ``_compiled_prep_stacked_packed``."""
    device = device_mod.resolve(device)
    cfg = cfg or config_mod.get_config()
    m, n = w320s.shape[:2]
    packed = _put(np.concatenate([w320s.reshape(-1), w32s.reshape(-1)]),
                  device)
    n_flow = m * n * _FLOW_SIZE * _FLOW_SIZE
    f = packed[:n_flow].view(m, n, _FLOW_SIZE, _FLOW_SIZE)
    h8 = packed[n_flow:].view(m, n, _HASH_SIZE, _HASH_SIZE)
    ham, fmean, fvar = _prep_body(f, h8, cfg)
    return torch.cat([ham.float(), fmean, fvar], dim=1)


def run_prep_window(w320: np.ndarray, w32: np.ndarray,
                    device: torch.device, cfg=None) -> torch.Tensor:
    """Enqueue one host-prep window ([n, 320, 320] and [n, 32, 32] uint8):
    ``run_prep_windows`` with m = 1.  Returns ham ‖ fmean ‖ fvar as one
    float32 device vector; nothing is fetched."""
    return run_prep_windows(w320[None], w32[None], device, cfg)[0]


@functools.lru_cache(maxsize=1)
def _dispatch_pool():
    """The dispatch stage: one thread per process, named ``avd-dispatch``
    and made at first use (never at import).  It enqueues each host-prep
    window (the pinned host→device copy and the window's launches) while
    the streaming thread decodes and preps the next chunk; the C++ host
    prep runs through ctypes and releases the interpreter lock meanwhile.

    One thread, where ``avd_tpu``'s pool has ``AVD_DISPATCH_WORKERS``
    (there, several host→device puts at once): a window's enqueue is
    about 933 torch calls, each of which drops and takes back the
    interpreter lock, so enqueuers running at once hand it to each other
    on every call and each window's enqueue stretches several-fold on the
    H100 (PERF.md §6).  The port reads no such setting."""
    return concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="avd-dispatch")


def _enqueue_prep_window(w320: np.ndarray, w32: np.ndarray,
                         device: torch.device, cfg, stream) -> torch.Tensor:
    """``run_prep_window`` on the dispatch thread.  CUDA's current device
    and stream belong to each host thread, so the window is enqueued on
    the caller's (``stream``; None on the CPU)."""
    if stream is None:
        return run_prep_window(w320, w32, device, cfg)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        return run_prep_window(w320, w32, device, cfg)


def run_window(window_gray_u8: np.ndarray, device: torch.device, cfg=None):
    """Enqueue one device-prep window ([N, H, W] uint8 gray): one u8 copy,
    then ``_feature_body``.  Returns (tex, ham, fmean, fvar) on the
    device; nothing is fetched."""
    cfg = cfg or config_mod.get_config()
    return _feature_body(_put(window_gray_u8, device), cfg)


def _chunk_size(h: int, w: int) -> int:
    """Device-prep window length: shrunk for frames above 1080p to bound
    device memory."""
    if h * w > 1920 * 1080:
        return max(8, _DEFAULT_CHUNK // 4)
    return _DEFAULT_CHUNK


def _to_gray_host(frames: np.ndarray, use_native: bool = True) -> np.ndarray:
    """[N, H, W, 3] BGR uint8 → [N, H, W] uint8, cv2 fixed point: the host
    runtime's threaded converter, or the numpy plain version under
    ``AVD_NATIVE=0``."""
    if use_native:
        return native.bgr_to_gray(frames)
    return host_prep_mod.to_gray(frames)


def _assemble(feats: Dict, tex_all, ham_all, fmean_all, fvar_all) -> Dict:
    n = feats["total"]
    feats["textures"] = [float(t) for t in tex_all]
    feats["flow_means"] = [float(x) for x in fmean_all]
    feats["flow_vars"] = [float(x) for x in fvar_all]
    feats["dup"] = int(sum(1 for hm in ham_all if hm == 0))
    timeline = []
    for i in range(n):
        tex = feats["textures"][i]
        mot = feats["flow_means"][i - 1] if i > 0 else 0.0
        timeline.append(float(np.clip(
            1.0 - (tex / (tex + 1000.0)) * (1.0 + mot), 0.0, 1.0)))
    feats["timeline_ai"] = timeline
    return feats


def _window_slices(start: int, valid: int, tex, ham, fmean, fvar,
                   sinks) -> None:
    """Distribute one window's outputs into the global feature lists.

    Window index 0 is the lead-in; pair i is (window[i], window[i+1]).
    For the first window the lead-in duplicates frame 0, so pair 0 is the
    (f0, f0) artifact and is dropped.  ``tex`` (device prep only) has one
    entry per window frame."""
    tex_all, ham_all, fmean_all, fvar_all = sinks
    if tex is not None:
        tex_all.extend(np.asarray(tex)[1:1 + valid].tolist())
    lo = 1 if start == 0 else 0
    ham_all.extend(np.asarray(ham)[lo:valid].tolist())
    fmean_all.extend(np.asarray(fmean)[lo:valid].tolist())
    fvar_all.extend(np.asarray(fvar)[lo:valid].tolist())


def _pad_window(window: np.ndarray, target: int) -> np.ndarray:
    if window.shape[0] < target:
        pad = np.repeat(window[-1:], target - window.shape[0], axis=0)
        window = np.concatenate([window, pad])
    return window


def _fetch_windows(pend, with_tex: bool, sinks) -> None:
    """The one device→host fetch: every window's result vector at once,
    then split into the feature lists.  ``pend`` holds (vector, kind,
    valid, is_first, window length); a vector is [tex ‖] ham ‖ fmean ‖
    fvar, and its kind says where it is: ``"device"`` a device tensor,
    ``"pool"`` a dispatch future of one (resolved first, so its window
    comes back in the one copy too), ``"host"`` a future of a host array
    from the cross-request batcher (resolved after the fetch)."""
    on_device = [vec.result() if kind == "pool" else vec
                 for vec, kind, *_ in pend if kind != "host"]
    fetched = iter(torch.cat(on_device).cpu().split(
        [v.numel() for v in on_device]) if on_device else ())
    for vec, kind, valid, is_first, target in pend:
        vec = vec.result() if kind == "host" else next(fetched).numpy()
        k = target - 1
        tex = None
        if with_tex:
            tex, vec = vec[:target], vec[target:]
        _window_slices(0 if is_first else 1, valid, tex, vec[:k],
                       vec[k:2 * k], vec[2 * k:], sinks)


def _device_window_vector(outs) -> torch.Tensor:
    tex, ham, fmean, fvar = outs
    return torch.cat([tex, ham.float(), fmean, fvar])


# ---------------------------------------------------------------------------
# change gate (AVD_CHANGE_GATE)
# ---------------------------------------------------------------------------

# the window path's flow batch shapes, so a gated clip reuses their plans
_PAIR_BUCKETS = (12, 24, 36, 48)


def flow_pairs(prev320: np.ndarray, cur320: np.ndarray, device, cfg=None):
    """Farnebäck over b explicit (prev, cur) [b, 320, 320] uint8 pairs:
    one packed u8 copy, the flow and its magnitude stats.  Returns
    fmean ‖ fvar as one [2b] float32 device vector; nothing is fetched.
    The counterpart of ``_compiled_flow_pairs``."""
    cfg = cfg or config_mod.get_config()
    b = prev320.shape[0]
    packed = _put(np.concatenate([prev320.reshape(-1), cur320.reshape(-1)]),
                  device)
    pairs = packed.view(2, b, _FLOW_SIZE, _FLOW_SIZE).float()
    fmean, fvar = _flow_stats(pairs[0], pairs[1], cfg)
    return torch.cat([fmean, fvar])


def _compute_features_gated(feats: Dict, s320: np.ndarray, s32: np.ndarray,
                            tex, device, cfg) -> Dict:
    """Change-gated features: hash and duplicates on the host (float64
    mean and >= as the reference and ``hashing.py``), the per-pair mean
    |Δ| gate on the host, Farnebäck only for the pairs that moved, in
    ``_PAIR_BUCKETS`` groups padded with the group's first pair."""
    n = s320.shape[0]
    m32 = s32.reshape(n, -1).astype(np.float64).mean(axis=1)
    bits = s32.astype(np.float64) >= m32[:, None, None]
    ham = (bits[1:] ^ bits[:-1]).sum(axis=(1, 2)) if n > 1 else \
        np.zeros((0,), np.int64)

    if n > 1:
        deltas = np.abs(s320[1:].astype(np.int16)
                        - s320[:-1].astype(np.int16)).mean(axis=(1, 2))
        dynamic = np.nonzero(deltas >= cfg.change_gate_thr)[0]
    else:
        dynamic = np.zeros((0,), np.int64)

    fmean = np.zeros(max(0, n - 1), np.float64)
    fvar = np.zeros(max(0, n - 1), np.float64)
    groups = []  # (pair indices, bucket, device vector)
    start = 0
    while start < dynamic.size:
        take = dynamic[start:start + _PAIR_BUCKETS[-1]]
        b = next(x for x in _PAIR_BUCKETS if x >= take.size)
        idx = np.concatenate([take, np.repeat(take[:1], b - take.size)])
        groups.append((take, b, flow_pairs(s320[idx], s320[idx + 1], device,
                                           cfg)))
        start += take.size
    if groups:  # one device→host fetch for every group
        fetched = torch.cat([g[2] for g in groups]).cpu().numpy()
        off = 0
        for take, b, _ in groups:
            fmean[take] = fetched[off:off + take.size]
            fvar[take] = fetched[off + b:off + b + take.size]
            off += 2 * b

    feats["skipped_pairs"] = int((n - 1) - dynamic.size) if n > 1 else 0
    return _assemble(feats, list(tex), ham.tolist(), fmean.tolist(),
                     fvar.tolist())


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def compute_features_streaming(chunk_iter, device=None,
                               batcher=None) -> Dict:
    """Consume an iterator of [k, H, W, 3] BGR chunks.

    Windows are enqueued on the device as they fill, so host work on the
    next chunk overlaps device compute.  Results are identical to
    ``compute_features`` on the concatenated frames in host-prep mode (the
    windows do not depend on how the frames were chunked); in device-prep
    mode the tail window takes a bucket here and the full chunk there.
    ``batcher`` (a ``serve.batching.WindowBatcher`` or None) runs every
    window instead of this thread: host-prep windows through
    ``submit_prep``, device-prep ones through ``submit``.  Without one,
    host-prep windows are enqueued by ``_dispatch_pool``'s thread on
    this thread's device and stream; device-prep ones on this thread.
    An exception on a dispatch thread is raised here, once every window
    of the call has finished.
    """
    dev = device_mod.pinned(device)
    cfg = config_mod.get_config()
    host_mode = cfg.prep_mode == "host"
    chunk = _DEFAULT_CHUNK if host_mode else None
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    pend: list = []      # (vector, kind, valid, is_first, target):
    #                       _fetch_windows' kinds
    tex_parts: list = []
    held = None          # host planes or gray not yet dispatched
    prev_last = None     # lead-in frames of the next window
    n_total = 0

    def dispatch(parts):
        nonlocal prev_last
        valid = parts[0].shape[0]
        target = _bucket_len(valid + 1, chunk)
        leads = prev_last if prev_last is not None else \
            tuple(p[0] for p in parts)
        windows = [_pad_window(np.concatenate([ld[None], p]), target)
                   for ld, p in zip(leads, parts)]
        if batcher is not None:
            # a future of the host vector: full host-prep windows of
            # concurrent requests share one stacked flow
            vec, kind = (batcher.submit_prep(*windows, device=dev)
                         if host_mode else batcher.submit(windows[0], dev)
                         ), "host"
        elif host_mode:
            vec, kind = _dispatch_pool().submit(
                _enqueue_prep_window, *windows, dev, cfg, stream), "pool"
        else:
            vec, kind = _device_window_vector(
                run_window(windows[0], dev, cfg)), "device"
        pend.append((vec, kind, valid, prev_last is None, target))
        prev_last = tuple(p[-1] for p in parts)

    try:
        for frames in chunk_iter:
            if frames.shape[0] == 0:
                continue
            if host_mode:
                s320, s32, tex = host_prep_mod.host_prep(frames,
                                                         native=cfg.native)
                tex_parts.append(tex)
                parts = (s320, s32)
            else:
                gray = _to_gray_host(frames, cfg.native)
                if chunk is None:
                    chunk = _chunk_size(*gray.shape[1:3])
                parts = (gray,)
            if held is not None:
                parts = tuple(np.concatenate([h_, p])
                              for h_, p in zip(held, parts))
                held = None
            while parts[0].shape[0] >= chunk:
                dispatch(tuple(p[:chunk] for p in parts))
                n_total += chunk
                parts = tuple(p[chunk:] for p in parts)
            held = parts if parts[0].shape[0] else None
        if held is not None and held[0].shape[0]:
            n_total += held[0].shape[0]
            dispatch(held)

        feats = {"dup": 0, "total": n_total, "flow_means": [],
                 "flow_vars": [], "textures": [], "timeline_ai": []}
        if n_total == 0:
            return feats
        sinks = ([], [], [], [])
        _fetch_windows(pend, not host_mode, sinks)
    finally:
        # no window of this call outlives it, a failed call's included
        concurrent.futures.wait([p[0] for p in pend if p[1] == "pool"])
    mark_device_warm()
    if host_mode:
        sinks = (np.concatenate(tex_parts).tolist(),) + sinks[1:]
    return _assemble(feats, *sinks)


# ---------------------------------------------------------------------------
# context parallelism over a rank group (parallel/halo.py)
# ---------------------------------------------------------------------------

def _cp_len(n: int, d: int) -> int:
    """Frames a clip of ``n`` is padded to over a time axis of ``d`` ranks:
    a power-of-two multiple of ``d``, so clip lengths map to a handful of
    shapes (``avd_tpu/ops/video_features.py:671-676``)."""
    per = -(-n // d)
    bucket = 1
    while bucket < per:
        bucket *= 2
    return bucket * d


def cp_pair_features(s320: np.ndarray, s32: np.ndarray, mesh, device=None,
                     cfg=None):
    """(ham, fmean, fvar) of the ``n-1`` consecutive pairs of the host-prep
    planes ([n, 320, 320] and [n, 32, 32] uint8), time-sharded over
    ``mesh``'s ``time`` axis with a one-frame halo
    (``halo.cp_video_pair_features``).  The clip is padded with its last
    frame to ``_cp_len``; the padded rows are self-pairs and are cut.
    Every rank gets the same arrays, fetched in one copy."""
    from avd_tpu_torch.parallel import collectives, halo
    dev = device_mod.resolve(device)
    n = s320.shape[0]
    n_pad = _cp_len(n, collectives.axis_size(mesh, "time"))
    if n_pad != n:
        s320 = np.concatenate([s320, np.repeat(s320[-1:], n_pad - n, 0)])
        s32 = np.concatenate([s32, np.repeat(s32[-1:], n_pad - n, 0)])
    fn = halo.cp_video_pair_features(mesh, device=dev, cfg=cfg)
    ham, fmean, fvar, _ = fn(torch.from_numpy(np.ascontiguousarray(s320)),
                             torch.from_numpy(np.ascontiguousarray(s32)))
    k = n - 1  # the real consecutive pairs
    out = torch.stack([ham[:k], fmean[:k], fvar[:k]]).cpu().numpy()
    mark_device_warm()
    return out[0], out[1], out[2]


def cp_features_prepped(s320: np.ndarray, s32: np.ndarray, tex, mesh,
                        device=None, cfg=None) -> Dict:
    """``compute_features``' result from host-prep planes and textures,
    the pairs time-sharded over ``mesh`` (``cp_pair_features``)."""
    return _pairs_result(tex, *cp_pair_features(s320, s32, mesh, device,
                                                cfg))


def _pairs_result(tex, ham, fmean, fvar) -> Dict:
    """``compute_features``' result from the textures and the pairs'
    features."""
    feats = {"dup": 0, "total": len(tex), "flow_means": [], "flow_vars": [],
             "textures": [], "timeline_ai": []}
    return _assemble(feats, list(tex), ham.tolist(), fmean.tolist(),
                     fvar.tolist())


def cp_pairs(s320: np.ndarray, s32: np.ndarray, device=None):
    """``cp_pair_features`` over the group's time mesh
    (``distributed.cp_mesh``): the video path's call on every rank of a
    served group."""
    from avd_tpu_torch.parallel import distributed
    return cp_pair_features(s320, s32, distributed.cp_mesh(), device)


def compute_features(frames: np.ndarray, device=None) -> Dict:
    """Per-frame feature lists for a [N, H, W, 3] uint8 BGR batch.

    Host prep runs the streaming path over chunk-sized slices (identical
    results), or the change gate under ``AVD_CHANGE_GATE=1``; device prep
    pads every window, the tail too, to the full chunk, as the JAX
    package's ``compute_features`` does.  In a rank group
    (``parallel/distributed.py``) host prep with the gate off takes the
    context-parallel path instead, for clips of at least two frames a
    rank (``AVD_CP=0`` turns it off): every rank is called with the same
    frames and returns the same features, or, in a served group, its
    leader enters the pairs on every rank with the host-prep planes
    (``cp_pairs`` through ``distributed.run_on_group``)."""
    n = frames.shape[0]
    cfg = config_mod.get_config()
    if cfg.prep_mode == "host" and not cfg.change_gate:
        from avd_tpu_torch.parallel import distributed
        if distributed.cp_enabled() and n >= 2 * distributed.world_size():
            s320, s32, tex = host_prep_mod.host_prep(frames,
                                                     native=cfg.native)
            return _pairs_result(tex, *distributed.run_on_group(
                cp_pairs, s320, s32, device=device))
        return compute_features_streaming(
            (frames[i:i + _DEFAULT_CHUNK]
             for i in range(0, n, _DEFAULT_CHUNK)), device=device)
    dev = device_mod.resolve(device)
    feats = {"dup": 0, "total": n, "flow_means": [], "flow_vars": [],
             "textures": [], "timeline_ai": []}
    if n == 0:
        return feats
    if cfg.prep_mode == "host":
        s320, s32, tex = host_prep_mod.host_prep(frames, native=cfg.native)
        return _compute_features_gated(feats, s320, s32, tex, dev, cfg)
    gray = _to_gray_host(frames, cfg.native)
    chunk = _chunk_size(*gray.shape[1:3])
    pend = []
    for start in range(0, n, chunk):
        valid = min(chunk, n - start)
        lead = gray[start - 1] if start > 0 else gray[0]
        window = _pad_window(
            np.concatenate([lead[None], gray[start:start + valid]]),
            chunk + 1)
        pend.append((_device_window_vector(run_window(window, dev, cfg)),
                     "device", valid, start == 0, chunk + 1))
    sinks = ([], [], [], [])
    _fetch_windows(pend, True, sinks)
    return _assemble(feats, *sinks)


def analyze_frames(frames: np.ndarray, w: int, h: int, fps: float,
                   duration: float, device=None) -> Dict:
    """Full video analysis over a decoded batch."""
    feats = compute_features(frames, device=device)
    return video_ref.summarize(feats, w, h, fps, duration)
