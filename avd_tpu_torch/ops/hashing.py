"""Average-hash duplicate detection.

Reference: per frame, 32×32 INTER_AREA grayscale, threshold at the mean,
Hamming distance to the previous frame's hash, exact-zero distance counts a
duplicate (reference app/analyzers/video.py:4-8,36-41).  Hashes for all
frames come from one [N, 32, 32] stack; consecutive distances are one
comparison between ``bits[:-1]`` and ``bits[1:]``.

Bit-exact with ``avd_tpu/ops/hashing.py``: the planes hold integers, so the
float32 mean of 1024 of them (sum < 2^24, divisor a power of two) is exact
in any summation order.
"""

from __future__ import annotations

import torch


def average_hash_bits(small_gray: torch.Tensor) -> torch.Tensor:
    """[N, S, S] f32 → [N, S*S] bool: pixel >= frame mean."""
    n = small_gray.shape[0]
    mean = small_gray.mean(dim=(-2, -1), keepdim=True)
    return (small_gray >= mean).reshape(n, -1)


def consecutive_hamming(bits: torch.Tensor) -> torch.Tensor:
    """[..., N, K] bool → [..., N-1] int32 Hamming distances between
    neighbors along N: a stack of windows pairs frames only inside each
    window."""
    return (bits[..., 1:, :] != bits[..., :-1, :]).sum(dim=-1) \
        .to(torch.int32)


def duplicate_count(bits: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """Number of consecutive pairs with Hamming distance 0 (reference
    video.py:37-40).  ``valid``: optional [N] bool mask for padded batches —
    a pair counts only when both frames are valid."""
    dup = consecutive_hamming(bits) == 0
    if valid is not None:
        dup = dup & valid[1:] & valid[:-1]
    return dup.sum().to(torch.int32)
