"""Per-frame AI-content detector — a compact ViT, inference only.

Port of the serving half of ``avd_tpu/models/detector.py``: the config and
presets, a seeded initialiser, and the forward pass as plain functions over
a parameter dict with the JAX package's keys and ``[in, out]`` weight
layout (``x @ w``), so a converted checkpoint drops in unchanged
(``models/convert.py``).

Numerics follow the JAX forward step by step: the residual stream and
every matmul operand are bf16; each product is rounded to bf16 and its
bias is added afterwards, in bf16; LayerNorm runs in f32 on the upcast
stream (eps 1e-6, biased variance) and is cast back; GELU is the tanh
approximation on bf16; the final LayerNorm and the head are f32.  With
``cfg.fused_attn`` the attention core is ``ops/kernels/attention.py`` (the
hand-written kernel on CUDA tensors, its plain version on CPU tensors);
without it, the einsum pair of the JAX block with f32 scores.

Dense MLP only: mixture-of-experts configs, training, tensor/pipeline
parallelism and checkpoint I/O in the orbax format are later slices
(``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.ops.kernels import attention as attention_k


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch: int = 16
    width: int = 384
    depth: int = 6
    heads: int = 6
    mlp_ratio: int = 4
    n_classes: int = 1          # binary: AI-generated?
    # Hand-written attention kernel (ops/kernels/attention.py): the
    # [B, H, T, T] scores never reach device memory.  Serving opts in via
    # AVD_ATTN_FUSED=1 (models/scoring.py).
    fused_attn: bool = False
    # Mixture-of-experts MLP (0 = dense); not ported yet.
    n_experts: int = 0

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1  # +cls

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def mlp_width(self) -> int:
        return self.width * self.mlp_ratio


PRESETS = {
    "small": dict(image_size=64, patch=16, width=256, depth=4, heads=4),
    "full": {},  # the dataclass defaults: 224px, width 384, depth 6
    # Switch-MoE variant of 'small'; building it raises until MoE is ported
    "moe_small": dict(image_size=64, patch=16, width=256, depth=4,
                      heads=4, n_experts=4),
}

# bf16 operands of the forward pass; LayerNorms and the head stay f32
_BF16 = ("patch_w", "patch_b", "pos_emb", "cls_tok", "qkv_w", "qkv_b",
         "proj_w", "proj_b", "mlp_in_w", "mlp_in_b", "mlp_out_w",
         "mlp_out_b")


def _require_dense(cfg: ViTConfig) -> None:
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts detector configs (n_experts > 0, preset "
            "'moe_small') are not ported yet (see ROADMAP.md)")


def make_config(preset: str = "full", **over) -> ViTConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown ViT preset {preset!r}; "
                         f"choose from {sorted(PRESETS)}")
    kw = dict(PRESETS[preset])
    kw.update(over)
    cfg = ViTConfig(**kw)
    _require_dense(cfg)
    return cfg


def param_shapes(cfg: ViTConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the tree's layout."""
    _require_dense(cfg)
    d, m = cfg.width, cfg.mlp_width
    layer = {"ln1_scale": (d,), "ln1_bias": (d,),
             "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
             "proj_w": (d, d), "proj_b": (d,),
             "ln2_scale": (d,), "ln2_bias": (d,),
             "mlp_in_w": (d, m), "mlp_in_b": (m,),
             "mlp_out_w": (m, d), "mlp_out_b": (d,)}
    return {"patch_w": (cfg.patch * cfg.patch * 3, d), "patch_b": (d,),
            "pos_emb": (cfg.tokens, d), "cls_tok": (d,),
            "layers": [dict(layer) for _ in range(cfg.depth)],
            "ln_f_scale": (d,), "ln_f_bias": (d,),
            "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,)}


def init_params(seed: int, cfg: ViTConfig) -> Dict[str, Any]:
    """Seeded f32 parameter tree on the CPU: weights N(0, 1/fan_in),
    embeddings N(0, 0.02²), LayerNorm scales 1, every bias 0.  The same
    distributions as the JAX initialiser, not its random stream."""
    gen = torch.Generator().manual_seed(seed)
    ones = ("ln1_scale", "ln2_scale", "ln_f_scale")
    small = ("pos_emb", "cls_tok")

    def make(name, shape):
        if name in ones:
            return torch.ones(shape)
        if name in small:
            return torch.randn(shape, generator=gen) * 0.02
        if name.endswith("_w"):
            return torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        return torch.zeros(shape)

    return _map_tree(make, param_shapes(cfg))


def _map_tree(fn, tree: Dict[str, Any]) -> Dict[str, Any]:
    """``fn(name, leaf)`` over a parameter tree, layers included."""
    return {k: [_map_tree(fn, lp) for lp in v] if k == "layers"
            else fn(k, v) for k, v in tree.items()}


def cast_for_inference(params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The tree on ``device`` (default CUDA) with the matmul operands
    already rounded to bf16, so a forward pass casts nothing.  Rounding is
    the cast that ``forward`` would do at each use: results are equal."""
    dev = device_mod.resolve(device)
    return _map_tree(
        lambda name, x: x.to(dev, torch.bfloat16 if name in _BF16
                             else torch.float32), params)


def _ln(x: torch.Tensor, scale, bias, eps: float = 1e-6) -> torch.Tensor:
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return ((x - m) * torch.rsqrt(v + eps)) * scale + bias


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def patchify(frames: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, 3] → [B, T, patch*patch*3], a patch laid out as
    (row, column, channel)."""
    b, h, w, c = frames.shape
    x = frames.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, (h // patch) * (w // patch), patch * patch * c)


def embed(params: Dict[str, Any], frames: torch.Tensor,
          cfg: ViTConfig) -> torch.Tensor:
    """[B, H, W, 3] → [B, T, width] bf16 token stream (patchify + cls +
    positional)."""
    x = patchify(_bf16(frames), cfg.patch)
    x = x @ _bf16(params["patch_w"]) + _bf16(params["patch_b"])
    cls = _bf16(params["cls_tok"]).expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1)
    return x + _bf16(params["pos_emb"])[None]


def block_forward(x: torch.Tensor, lp: Dict[str, Any],
                  cfg: ViTConfig) -> torch.Tensor:
    """One transformer block on the bf16 residual stream [B, T, width]."""
    h = _bf16(_ln(x.float(), lp["ln1_scale"], lp["ln1_bias"]))
    qkv = h @ _bf16(lp["qkv_w"]) + _bf16(lp["qkv_b"])
    b, t, _ = qkv.shape
    qkv = qkv.reshape(b, t, 3, cfg.heads, cfg.head_dim)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    if cfg.fused_attn:
        o = attention_k.attention(q, k, v)          # [b, t, width] bf16
    else:
        # f32 scores from the bf16 values (their products are exact in
        # f32), f32 softmax, P rounded to bf16, f32 accumulation
        att = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        att = torch.softmax(att / np.sqrt(cfg.head_dim), dim=-1)
        o = torch.einsum("bhts,bshd->bthd", _bf16(att).float(), v.float())
        o = _bf16(o.reshape(b, t, cfg.width))
    o = o @ _bf16(lp["proj_w"]) + _bf16(lp["proj_b"])
    x = x + o

    h = _bf16(_ln(x.float(), lp["ln2_scale"], lp["ln2_bias"]))
    h = h @ _bf16(lp["mlp_in_w"]) + _bf16(lp["mlp_in_b"])
    h = F.gelu(h, approximate="tanh")
    h = h @ _bf16(lp["mlp_out_w"]) + _bf16(lp["mlp_out_b"])
    return x + h


def head(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Final LN on the cls token → f32 logits."""
    x = _ln(x.float(), params["ln_f_scale"].float(),
            params["ln_f_bias"].float())
    return x[:, 0] @ params["head_w"].float() + params["head_b"].float()


def forward(params: Dict[str, Any], frames: torch.Tensor,
            cfg: ViTConfig) -> torch.Tensor:
    """ViT forward: [B, H, W, 3] float in [0,1] → [B, n_classes] f32
    logits, on the device the frames and parameters lie on."""
    _require_dense(cfg)
    x = embed(params, frames, cfg)
    for lp in params["layers"]:
        x = block_forward(x, lp, cfg)
    return head(params, x)
