"""Exact softmax attention of the temporal detector, on one device.

Port of ``avd_tpu/parallel/attention.py::full_attention``: f32
softmax(Q·Kᵀ/√d)·V in the [B, H, T, D] layout, in plain torch ops.  In
``avd_tpu`` it is XLA glue, not a Pallas kernel, so it is not routed to
``csrc/attention.cu``.  The sequence-parallel forms of that module (ring
attention, Ulysses) belong to the parallelism slice and extend this one.
"""

from __future__ import annotations

import math

import torch


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Single-device softmax(QKᵀ/√d)V on [B, H, T, D]; f32 scores,
    softmax and products, the result in ``q``'s dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)
