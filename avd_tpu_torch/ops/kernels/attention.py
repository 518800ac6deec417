"""Multi-head self-attention of the ViT detector: CUDA kernel + plain version.

Port of ``avd_tpu/ops/pallas/attention.py``: ``mha`` computes
``softmax(Q·Kᵀ·D^-½)·V`` per (batch, head) on [B, H, T, D] bf16 with f32
scores, an exact f32 row softmax, P rounded to bf16 before P·V, f32
accumulation and a bf16 result; ``attention`` is the detector block's form,
[B, T, H, D] q/k/v → [B, T, H·D].  ``csrc/attention.cu`` holds two kernels:
the tensor-core one (``mma.sync`` products, the score row in registers) for
up to ``MMA_MAX_TOKENS`` tokens, and the general one on the float32 cores
for longer sequences; ``variant`` picks by shape alone.  Both read q, k, v
and write o through element strides, so ``attention`` hands them the
block's strided views of the qkv tensor and ``mha`` its head-major tensors,
with no copy in either.  ``mha_plain`` / ``attention_plain`` are
the same function in plain PyTorch (f32 matmuls of the bf16 values, the
softmax written out), with no fused-attention library call.
"""

from __future__ import annotations

import ctypes
import math

import torch

from avd_tpu_torch.ops.kernels import _build, _launches

LAUNCHES = 0  # kernel launches; raised only where a kernel is launched
VARIANT_LAUNCHES = {"mma": 0, "general": 0}  # the same, by kernel

MAX_HEAD_DIM = 128
MMA_MAX_TOKENS = 208  # 16 · the largest key-tile count attention.cu builds
_SMEM_LIMIT = 232448  # dynamic shared memory one block may use on sm_90


def mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Plain PyTorch attention on [B, H, T, D] bf16 (any device)."""
    scale = float(1.0 / math.sqrt(q.shape[-1]))
    s = (q.float() @ k.float().mT) * scale       # exact products, f32 sums
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    o = p.bfloat16().float() @ v.float()
    return o.bfloat16()


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                    ) -> torch.Tensor:
    """Plain PyTorch form of ``attention``: [B, T, H, D] → [B, T, H·D]."""
    b, t, h, d = q.shape
    o = mha_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    return o.transpose(1, 2).reshape(b, t, h * d)


def variant(T: int, D: int) -> str:
    """Which kernel a [.., T, .., D] call launches: ``"mma"`` (tensor
    cores; every D the wrapper takes, T up to ``MMA_MAX_TOKENS``) or
    ``"general"`` (float32 cores).  A pure function of the shape: no build
    or launch result changes the choice."""
    if D % 8 or not 8 <= D <= MAX_HEAD_DIM:
        raise ValueError(f"the attention kernel takes a head dim that is a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}, got {D}")
    return "mma" if T <= MMA_MAX_TOKENS else "general"


_fns: dict = {}


def _bind():
    lib = _build.load("attention")
    strides = ctypes.POINTER(ctypes.c_int64)
    fns = {"mma": lib.avd_mha_mma, "general": lib.avd_mha_general}
    for fn in fns.values():
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [strides] * 4 + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    fns["smem"] = lib.avd_mha_smem_bytes
    fns["smem"].argtypes = [ctypes.c_int, ctypes.c_int]
    fns["smem"].restype = ctypes.c_int64
    if lib.avd_mha_mma_max_tokens() != MMA_MAX_TOKENS:
        raise RuntimeError("attention.cu and MMA_MAX_TOKENS disagree")
    return fns


def _lib():
    """{"mma": fn, "general": fn, "smem": fn} of the built library."""
    return _launches.symbol(_fns, "attention", _bind)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            token_axis: int, head_axis: int) -> torch.Tensor:
    """Check q, k, v (4-D, batch first, head dim last, tokens and heads on
    the named axes), launch the kernel and return o in the same layout."""
    for name, x in zip("qkv", (q, k, v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} must lie on a CUDA device, not "
                             f"{x.device}")
        if x.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, not {x.dtype}")
        if x.device != q.device:
            raise ValueError("q, k and v lie on different devices")
    if not q.shape == k.shape == v.shape or q.dim() != 4:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)}; want three equal 4-D shapes")
    B, T, H, D = q.shape[0], q.shape[token_axis], q.shape[head_axis], \
        q.shape[3]
    which = variant(T, D)
    fns = _lib()
    if which == "general":
        need = fns["smem"](T, D)
        if need > _SMEM_LIMIT:
            raise ValueError(f"T={T}, D={D} needs {need} bytes of shared "
                             f"memory per block; the card has {_SMEM_LIMIT}")
    o = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
    tensors = [_dense_rows(x) for x in (q, k, v)] + [o]
    strides = [(ctypes.c_int64 * 3)(x.stride(0), x.stride(token_axis),
                                    x.stride(head_axis)) for x in tensors]
    with torch.cuda.device(q.device):
        err = fns[which](*(x.data_ptr() for x in tensors), B, H, T, D,
                         *strides, 1.0 / math.sqrt(D),
                         torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention kernel ({which}) launch failed: "
                           f"cudaError {err}")
    _launches.count(globals(), "VARIANT_LAUNCHES", which)
    return o


def _dense_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernel can address it in place (dense last
    axis, 16-byte aligned rows), else a contiguous copy."""
    ok = x.stride(-1) == 1 and not any(s % 8 for s in x.stride()[:-1]) \
        and x.data_ptr() % 16 == 0
    return x if ok else x.contiguous()


def _on_cpu(q, k, v) -> bool:
    return q.device.type == "cpu" and k.device.type == "cpu" \
        and v.device.type == "cpu"


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[B, H, T, D] bf16 q, k, v → [B, H, T, D] bf16.

    CPU tensors take ``mha_plain``; CUDA tensors launch the kernel that
    ``variant`` names or raise."""
    if _on_cpu(q, k, v):
        return mha_plain(q, k, v)
    return _launch(q, k, v, token_axis=2, head_axis=1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
              ) -> torch.Tensor:
    """Drop-in for the detector block's einsum pair: [B, T, H, D] bf16 q,
    k, v (strided views are read in place) → [B, T, H·D] bf16.

    CPU tensors take ``attention_plain``; CUDA tensors launch the kernel
    that ``variant`` names or raise."""
    if _on_cpu(q, k, v):
        return attention_plain(q, k, v)
    o = _launch(q, k, v, token_axis=1, head_axis=2)
    return o.view(o.shape[0], o.shape[1], -1)
