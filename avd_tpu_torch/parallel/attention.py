"""Exact softmax attention: on one device, and over a sharded token axis.

Port of ``avd_tpu/parallel/attention.py``.  ``full_attention`` is the f32
softmax(Q·Kᵀ/√d)·V in the [B, H, T, D] layout, in plain torch ops (XLA
glue in ``avd_tpu``, no Pallas kernel behind it, so not routed to
``csrc/attention.cu``).  The two sequence-parallel forms compute the same
exact attention with the token axis sharded over a mesh dim, each rank
holding its [B, H, T/S, D] blocks of q, k and v:

* **ring attention** — queries stay put; K/V blocks rotate around the
  ring (``ppermute``) while an f32 online softmax (running max,
  normalizer, accumulator) folds each block in: ``n_shards-1``
  fold-and-rotate steps, then a last fold without rotating;
* **Ulysses** — one ``all_to_all`` re-shards from token-parallel to
  head-parallel ([B, H, T/S, D] → [B, H/S, T, D]), full attention runs
  on the local heads, and a second ``all_to_all`` restores the token
  sharding.  The heads must divide by the axis.
"""

from __future__ import annotations

import math

import torch

from avd_tpu_torch.parallel import collectives as col


def full_attention(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    """Single-device softmax(QKᵀ/√d)V on [B, H, T, D]; f32 scores,
    softmax and products, the result in ``q``'s dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str, n_shards: int) -> torch.Tensor:
    """Exact attention with the token axis sharded over ``axis``.

    ``q``/``k``/``v`` are this rank's blocks [B, H, T/S, D].  K/V rotate
    over the ring; the online softmax keeps a running (max, normalizer,
    accumulator) in f32, so the result equals the unsharded softmax up to
    fp rounding whatever the block order."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf = q.float()
    perm = [(i, (i + 1) % n_shards) for i in range(n_shards)]
    m = torch.full(q.shape[:-1], -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)

    def fold(kb, vb, m, l, acc):
        s = torch.einsum("bhtd,bhsd->bhts", qf, kb.float()) * scale
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + \
            torch.einsum("bhts,bhsd->bhtd", p, vb.float())
        return m_new, l, acc

    kb, vb = k, v
    # n_shards-1 fold+rotate steps, then the final block folds WITHOUT
    # rotating: its hop would carry a whole K+V into a discarded carry
    for _ in range(n_shards - 1):
        m, l, acc = fold(kb, vb, m, l, acc)
        kb = col.ppermute(kb, mesh, axis, perm)
        vb = col.ppermute(vb, mesh, axis, perm)
    _, l, acc = fold(kb, vb, m, l, acc)
    return (acc / l[..., None]).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, axis: str) -> torch.Tensor:
    """Exact attention by head redistribution (DeepSpeed-Ulysses): from
    token-sharded [B, H, T/S, D] blocks with ``H % S == 0``, all_to_all to
    head-sharded [B, H/S, T, D], full attention locally, all_to_all
    back."""
    def to_heads(x):
        return col.all_to_all(x, mesh, axis, split_axis=1, concat_axis=2)

    oh = full_attention(to_heads(q), to_heads(k), to_heads(v))
    return col.all_to_all(oh, mesh, axis, split_axis=2, concat_axis=1)
