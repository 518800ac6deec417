"""Context parallelism over the time axis with a one-frame halo.

Port of ``avd_tpu/parallel/halo.py``.  The video path's only inter-frame
dependencies look back one sampled frame (duplicate hashing and optical
flow compare each frame with the previous one), so the time axis shards
with a halo of ONE frame: each rank computes its frames' pairs plus the
pair that straddles its right boundary, after receiving its successor's
first frame (``ppermute``).

``avd_tpu`` hands a ``shard_map`` the global clip and gets global arrays
back.  Here every rank is called with the whole clip (the same on every
rank), takes its contiguous block along ``time``, computes its pairs on
its own device, and the rows are gathered so every rank returns the
whole result.  The clip's length must divide by the time axis.
"""

from __future__ import annotations

from typing import Callable

import torch

from avd_tpu_torch import config as config_mod
from avd_tpu_torch.ops import flow as flow_ops
from avd_tpu_torch.ops import hashing
from avd_tpu_torch.parallel import collectives as col
from avd_tpu_torch.parallel import mesh as mesh_mod


def with_next_halo(local: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """[n_local, ...] → [n_local+1, ...] appending the next shard's first
    frame (the last shard gets its own last frame repeated: one self-pair,
    which ``pair_valid_mask`` marks)."""
    n = col.axis_size(mesh, axis)
    perm = [(i, (i - 1) % n) for i in range(n)]
    recv = col.ppermute(local[:1], mesh, axis, perm)
    tail = local[-1:] if col.axis_index(mesh, axis) == n - 1 else recv
    return torch.cat([local, tail], dim=0)


def pair_valid_mask(n_local: int, mesh, axis: str,
                    device=None) -> torch.Tensor:
    """[n_local] bool: which boundary-inclusive pairs are real (the last
    shard's final pair is the self-pair artifact)."""
    mask = torch.ones(n_local, dtype=torch.bool, device=device)
    if col.axis_index(mesh, axis) == col.axis_size(mesh, axis) - 1:
        mask[-1] = False
    return mask


def cp_consecutive_pairs(mesh, fn: Callable, axis: str = "time"):
    """Lift a pairwise feature fn into a time-sharded computation.

    ``fn(prev_frames, cur_frames) -> [k, ...]`` maps k frame pairs to k
    feature rows.  Returns ``frames [N, ...] → (features [N, ...], valid
    [N])`` where row i is the feature of pair (i, i+1) and the last row is
    padding (``valid[i]`` False).  Each rank runs ``fn`` on its block, on
    the frames' device."""
    def run(frames: torch.Tensor):
        local = mesh_mod.batch_slice(mesh, frames, axis)
        ext = with_next_halo(local, mesh, axis)
        feats = fn(ext[:-1], ext[1:])
        valid = pair_valid_mask(local.shape[0], mesh, axis, local.device)
        return (col.all_gather(feats, mesh, axis),
                col.all_gather(valid.to(torch.uint8), mesh, axis).bool())

    return run


def cp_frame_deltas(mesh, axis: str = "time"):
    """Time-sharded mean |frame difference|: the cheap neighbour feature of
    the tests."""
    def pair_fn(prev, cur):
        d = torch.abs(cur.float() - prev.float())
        return d.mean(dim=tuple(range(1, d.dim())))
    return cp_consecutive_pairs(mesh, pair_fn, axis)


def cp_video_pair_features(mesh, axis: str = "time", device=None, cfg=None):
    """Time-sharded pair-feature program of the video path: consecutive
    average-hash Hamming on the [N, 32, 32] hash planes and Farnebäck flow
    magnitude stats on the [N, 320, 320] flow planes (``farneback_flow``:
    the warp and blur+solve kernels on a CUDA rank, or the fused round
    under ``AVD_PALLAS_ITER=1``), each rank on its pairs after the
    one-frame halo.

    Returns ``(flow_u8 [N,320,320], hash_u8 [N,32,32]) → (ham [N], fmean
    [N], fvar [N], valid [N])``, f32 but ``valid``, row i the feature of
    pair (i, i+1), on the rank's device (``device``, default the rank's);
    N must divide by the time axis.  The rows come back in one
    ``all_gather``."""
    from avd_tpu_torch.parallel import distributed

    dev = device if device is not None else distributed.rank_device()
    cfg = cfg or config_mod.get_config()

    def run(flow_u8: torch.Tensor, hash_u8: torch.Tensor):
        f_loc = mesh_mod.batch_slice(mesh, flow_u8, axis).to(dev)
        h_loc = mesh_mod.batch_slice(mesh, hash_u8, axis).to(dev)
        f = with_next_halo(f_loc, mesh, axis).float()
        h8 = with_next_halo(h_loc, mesh, axis).float()
        ham = hashing.consecutive_hamming(hashing.average_hash_bits(h8))
        fl = flow_ops.farneback_flow(f[:-1], f[1:],
                                     fused_iter=cfg.fused_flow_iter,
                                     flow_bf16=cfg.flow_bf16)
        fmean, fvar = flow_ops.flow_magnitude_stats(fl)
        valid = pair_valid_mask(f_loc.shape[0], mesh, axis, dev)
        rows = torch.stack([ham.float(), fmean.float(), fvar.float(),
                            valid.float()], dim=1)
        out = col.all_gather(rows, mesh, axis)
        return out[:, 0], out[:, 1], out[:, 2], out[:, 3] > 0.5

    return run
