"""Batched per-frame video features on the GPU (host-prep mode).

Port of ``avd_tpu/ops/video_features.py`` in its default ``AVD_PREP=host``
mode.  Per window of sampled frames the pipeline produces only per-frame
scalars:

    texture[k]     Laplacian variance at full resolution (host prep)
    hamming[k]     Hamming distance between consecutive 32×32 avg-hashes
    flow_mean[k]   mean |Farnebäck flow| on 320×320 gray, pair (k, k+1)
    flow_var[k]    population variance of |flow| per pair

The host makes the 320² flow planes, the 32² hash planes and the texture
(``ops/host_prep.py``); the device runs hashing and the batched Farnebäck
flow over every pair of a window (``_prep_body``).  Clips longer than the
chunk stream through windows with a one-frame lead-in; tails round up to
quarter-chunk buckets.  Each window ships as ONE u8 vector through pinned
host memory (``non_blocking``), its results stay on the device, and all
windows' results come back in one device→host fetch at the end, so host
prep of window k+1 overlaps the device work of window k.  Aggregation runs
on the host in float64 (``oracle/video_ref.summarize``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from avd_tpu_torch import config as config_mod
from avd_tpu_torch import device as device_mod
from avd_tpu_torch.oracle import video_ref
from avd_tpu_torch.ops import flow, hashing
from avd_tpu_torch.ops import host_prep as host_prep_mod

# Frames per device chunk (excluding the 1-frame lead-in).
_DEFAULT_CHUNK = 48

_FLOW_SIZE = host_prep_mod.FLOW_SIZE
_HASH_SIZE = host_prep_mod.HASH_SIZE


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


def _prep_body(flow_u8: torch.Tensor, hash_u8: torch.Tensor,
               fused_iter: bool = False):
    """Pair features from pre-resized windows ([N, 320, 320] and
    [N, 32, 32] uint8) → (ham [N-1] i32, fmean [N-1], fvar [N-1]).
    ``fused_iter`` runs each solver round as one fused kernel call."""
    bits = hashing.average_hash_bits(hash_u8.float())
    ham = hashing.consecutive_hamming(bits)
    fs = flow_u8.float()
    fl = flow.farneback_flow(fs[:-1], fs[1:], fused_iter=fused_iter)
    fmean, fvar = flow.flow_magnitude_stats(fl)
    return ham, fmean, fvar


def run_prep_window(w320: np.ndarray, w32: np.ndarray,
                    device: torch.device,
                    fused_iter: bool = False) -> torch.Tensor:
    """Enqueue one window: one u8 host→device copy (pinned, non-blocking
    on CUDA), then the pair features.  Returns ham ‖ fmean ‖ fvar as one
    float32 device vector; nothing is fetched."""
    n = w320.shape[0]
    packed = torch.from_numpy(np.concatenate([w320.reshape(-1),
                                              w32.reshape(-1)]))
    if device.type == "cuda":
        packed = packed.pin_memory().to(device, non_blocking=True)
    n_flow = n * _FLOW_SIZE * _FLOW_SIZE
    f = packed[:n_flow].view(n, _FLOW_SIZE, _FLOW_SIZE)
    h8 = packed[n_flow:].view(n, _HASH_SIZE, _HASH_SIZE)
    ham, fmean, fvar = _prep_body(f, h8, fused_iter)
    return torch.cat([ham.float(), fmean, fvar])


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


def _window_slices(start: int, valid: int, ham, fmean, fvar, sinks) -> None:
    """Distribute one window's outputs into the global feature lists.

    Window index 0 is the lead-in; pair i is (window[i], window[i+1]).
    For the first window the lead-in duplicates frame 0, so pair 0 is the
    (f0, f0) artifact and is dropped."""
    ham_all, fmean_all, fvar_all = sinks
    lo = 1 if start == 0 else 0
    ham_all.extend(np.asarray(ham)[lo:valid].tolist())
    fmean_all.extend(np.asarray(fmean)[lo:valid].tolist())
    fvar_all.extend(np.asarray(fvar)[lo:valid].tolist())


def _pad_window(window: np.ndarray, target: int) -> np.ndarray:
    if window.shape[0] < target:
        pad = np.repeat(window[-1:], target - window.shape[0], axis=0)
        window = np.concatenate([window, pad])
    return window


def compute_features_streaming(chunk_iter, device=None) -> Dict:
    """Consume an iterator of [k, H, W, 3] BGR chunks.

    Windows are enqueued on the device as they fill, so host prep of the
    next chunk overlaps device compute.  Results are identical to
    ``compute_features`` on the concatenated frames: the windows do not
    depend on how the frames were chunked.
    """
    dev = device_mod.resolve(device)
    fused_iter = config_mod.get_config().fused_flow_iter  # AVD_PALLAS_ITER
    chunk = _DEFAULT_CHUNK
    pend: list = []      # (device result vector, valid, is_first, target)
    tex_parts: list = []
    held = None          # (s320, s32) not yet dispatched
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
        pend.append((run_prep_window(*windows, device=dev,
                                     fused_iter=fused_iter), valid,
                     prev_last is None, target))
        prev_last = tuple(p[-1] for p in parts)

    for frames in chunk_iter:
        if frames.shape[0] == 0:
            continue
        s320, s32, tex = host_prep_mod.host_prep(frames)
        tex_parts.append(tex)
        parts = (s320, s32)
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

    feats = {"dup": 0, "total": n_total, "flow_means": [], "flow_vars": [],
             "textures": [], "timeline_ai": []}
    if n_total == 0:
        return feats

    # the one device→host fetch: every window's results at once
    fetched = torch.cat([p[0] for p in pend]).cpu().numpy()
    sinks = ([], [], [])
    off = 0
    for _, valid, is_first, target in pend:
        k = target - 1
        vec = fetched[off:off + 3 * k]
        off += 3 * k
        _window_slices(0 if is_first else 1, valid, vec[:k], vec[k:2 * k],
                       vec[2 * k:], sinks)
    return _assemble(feats, np.concatenate(tex_parts).tolist(), *sinks)


def compute_features(frames: np.ndarray, device=None) -> Dict:
    """Per-frame feature lists for a [N, H, W, 3] uint8 BGR batch (the
    streaming path over chunk-sized slices; identical results)."""
    n = frames.shape[0]
    return compute_features_streaming(
        (frames[i:i + _DEFAULT_CHUNK] for i in range(0, n, _DEFAULT_CHUNK)),
        device=device)


def analyze_frames(frames: np.ndarray, w: int, h: int, fps: float,
                   duration: float, device=None) -> Dict:
    """Full video analysis over a decoded batch."""
    feats = compute_features(frames, device=device)
    return video_ref.summarize(feats, w, h, fps, duration)
