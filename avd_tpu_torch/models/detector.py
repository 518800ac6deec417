"""Per-frame AI-content detector — a compact ViT.

Port of ``avd_tpu/models/detector.py`` on one device: the config and
presets, a seeded initialiser, and the forward pass as plain functions over
a parameter dict with the JAX package's keys and ``[in, out]`` weight
layout (``x @ w``), so a converted checkpoint drops in unchanged
(``models/convert.py``); then the training half: the loss (sigmoid BCE,
the MoE load-balancing term, the logit-scale regulariser), the train step
over autograd, the optimizer (``models/optim.py``), per-block
rematerialisation (``cfg.remat``) and the resolution transfer of the
positional embedding.

Numerics follow the JAX forward step by step: the residual stream and
every matmul operand are bf16; each product is rounded to bf16 and its
bias is added afterwards, in bf16; LayerNorm runs in f32 on the upcast
stream (eps 1e-6, biased variance) and is cast back; GELU is the tanh
approximation on bf16; the final LayerNorm and the head are f32.  With
``cfg.fused_attn`` the attention core is ``ops/kernels/attention.py`` (the
hand-written kernel on CUDA tensors, its plain version on CPU tensors);
without it, the einsum pair of the JAX block with f32 scores.

With ``cfg.n_experts`` the MLP is the Switch mixture of experts of
``avd_tpu`` (top-1 routing per example with capacity drops, ``_moe_mlp``),
routed on f32 features that recompute the embedding end to end
(``_router_features``) with snapped logits, so every token picks the same
expert on the card, on the CPU and in ``avd_tpu``.  Checkpoints are the
port's ``params.npz`` (``convert.save_checkpoint``); tensor, pipeline and
expert parallelism are a later slice (``ROADMAP.md``).  ``avd_tpu``'s
``scan`` option rolls the layers into one ``lax.scan`` to shrink XLA's
program and computes what the loop computes: the port has no counterpart.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.models import optim
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
    # Switch mixture-of-experts MLP (0 = dense): top-1 routing over
    # per-example token groups, capacity_factor · tokens / n_experts
    # tokens per expert, the rest dropped onto the residual.
    n_experts: int = 0
    capacity_factor: float = 1.25
    # Recompute each block's forward in the backward pass
    # (torch.utils.checkpoint, non-reentrant): activation memory O(1) in
    # depth for the cost of one more forward.
    remat: bool = False

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch) ** 2 + 1  # +cls

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def expert_capacity(self) -> int:
        """Per-example token capacity of one expert (Switch C)."""
        return max(1, math.ceil(self.tokens / self.n_experts
                                * self.capacity_factor))

    @property
    def mlp_width(self) -> int:
        return self.width * self.mlp_ratio


Config = ViTConfig  # the family API (models/__init__.py::family)

PRESETS = {
    "small": dict(image_size=64, patch=16, width=256, depth=4, heads=4),
    "full": {},  # the dataclass defaults: 224px, width 384, depth 6
    # Switch-MoE variant of 'small' (4 experts, top-1); ships trained
    "moe_small": dict(image_size=64, patch=16, width=256, depth=4,
                      heads=4, n_experts=4),
}

# bf16 operands of the forward pass; LayerNorms, the router and the head
# stay f32
_BF16 = ("patch_w", "patch_b", "pos_emb", "cls_tok", "qkv_w", "qkv_b",
         "proj_w", "proj_b", "mlp_in_w", "mlp_in_b", "mlp_out_w",
         "mlp_out_b", "moe_in_w", "moe_in_b", "moe_out_w", "moe_out_b")
# the embedding leaves the MoE router reads in f32 (_router_features)
_EMBED = ("patch_w", "patch_b", "cls_tok", "pos_emb")
# Snap-to-grid routing granularity: logits are rounded to bins of
# 1/_ROUTER_GRID before the top-1 argmax (avd_tpu/models/detector.py:240)
_ROUTER_GRID = 4.0


def stored_bf16(cfg: ViTConfig):
    """The leaves every served mode reads in bf16, which a checkpoint may
    store as bf16: none for a dense config (the int8 forward quantizes
    every weight from f32 and reads the biases and embeddings in f32),
    the attention and expert operands for an MoE one (its router reads
    the embedding leaves in f32; the int8 forward rejects MoE)."""
    if not cfg.n_experts:
        return ()
    return tuple(k for k in _BF16 if k not in _EMBED
                 and not k.startswith("mlp_"))


def make_config(preset: str = "full", **over) -> ViTConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown ViT preset {preset!r}; "
                         f"choose from {sorted(PRESETS)}")
    kw = dict(PRESETS[preset])
    kw.update(over)
    return ViTConfig(**kw)


def param_shapes(cfg: ViTConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the tree's layout."""
    d, m, e = cfg.width, cfg.mlp_width, cfg.n_experts
    layer = {"ln1_scale": (d,), "ln1_bias": (d,),
             "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
             "proj_w": (d, d), "proj_b": (d,),
             "ln2_scale": (d,), "ln2_bias": (d,)}
    if e:
        layer.update({"router_w": (d, e),
                      "moe_in_w": (e, d, m), "moe_in_b": (e, m),
                      "moe_out_w": (e, m, d), "moe_out_b": (e, d)})
    else:
        layer.update({"mlp_in_w": (d, m), "mlp_in_b": (m,),
                      "mlp_out_w": (m, d), "mlp_out_b": (d,)})
    return {"patch_w": (cfg.patch * cfg.patch * 3, d), "patch_b": (d,),
            "pos_emb": (cfg.tokens, d), "cls_tok": (d,),
            "layers": [dict(layer) for _ in range(cfg.depth)],
            "ln_f_scale": (d,), "ln_f_bias": (d,),
            "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,)}


def init_params(seed: int, cfg: ViTConfig) -> Dict[str, Any]:
    """Seeded f32 parameter tree on the CPU: weights N(0, 1/fan_in) (the
    expert weights over their input width), embeddings N(0, 0.02²),
    LayerNorm scales 1, every bias 0.  The same distributions as the JAX
    initialiser, not its random stream."""
    gen = torch.Generator().manual_seed(seed)
    ones = ("ln1_scale", "ln2_scale", "ln_f_scale")
    small = ("pos_emb", "cls_tok")

    def make(name, shape):
        if name in ones:
            return torch.ones(shape)
        if name in small:
            return torch.randn(shape, generator=gen) * 0.02
        if name.endswith("_w"):
            return torch.randn(shape, generator=gen) / math.sqrt(shape[-2])
        return torch.zeros(shape)

    return _map_tree(make, param_shapes(cfg))


def _map_tree(fn, tree: Dict[str, Any]) -> Dict[str, Any]:
    """``fn(name, leaf)`` over a parameter tree: nested dicts and lists of
    dicts are walked, anything else is a leaf."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, list):
            out[k] = [_map_tree(fn, x) for x in v]
        elif isinstance(v, dict):
            out[k] = _map_tree(fn, v)
        else:
            out[k] = fn(k, v)
    return out


def cast_for_inference(params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The tree on ``device`` (default CUDA) with the matmul operands
    already rounded to bf16, so a forward pass casts nothing.  Rounding is
    the cast that ``forward`` would do at each use: results are equal.  An
    MoE tree keeps the embedding leaves in f32: its router reads them in
    f32 (``_router_features``), and ``embed`` rounds them where it uses
    them."""
    dev = device_mod.resolve(device)
    moe = any("router_w" in lp for lp in params["layers"])
    bf16 = tuple(k for k in _BF16 if not (moe and k in _EMBED))
    return _map_tree(
        lambda name, x: x.to(dev, torch.bfloat16 if name in bf16
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


def _router_features(params: Dict[str, Any], frames: torch.Tensor,
                     cfg: ViTConfig) -> torch.Tensor:
    """The MoE routing input: the embedding recomputed in f32 end to end
    (patchify, project, cls, positions) through a parameter-free
    LayerNorm, [B, T, width] f32.  f32 sums differ between programs by
    about 1e-7, far under the routing grid, so the snapped top-1 choice is
    the same on every device (``avd_tpu/models/detector.py:245-264``)."""
    x = patchify(frames.float(), cfg.patch)
    x = x @ params["patch_w"].float() + params["patch_b"].float()
    cls = params["cls_tok"].float().expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + params["pos_emb"].float()[None]
    return _ln(x, 1.0, 0.0)


def _route(rx: torch.Tensor, router_w: torch.Tensor):
    """(f32 router logits [B, T, E], top-1 expert [B, T]): the argmax of
    the logits snapped to the grid, ties to the lowest expert index."""
    logits = rx @ router_w.float()
    return logits, torch.argmax(torch.round(logits * _ROUTER_GRID), dim=-1)


def expert_indices(params: Dict[str, Any], frames: torch.Tensor,
                   cfg: ViTConfig) -> torch.Tensor:
    """Top-1 expert of every token in every layer, [depth, B, T] int64."""
    rx = _router_features(params, frames, cfg)
    return torch.stack([_route(rx, lp["router_w"])[1]
                        for lp in params["layers"]])


def _moe_mlp(h: torch.Tensor, lp: Dict[str, Any], cfg: ViTConfig,
             router_x: Optional[torch.Tensor] = None):
    """Switch top-1 MoE MLP over per-example token groups
    (``avd_tpu/models/detector.py:267-327``) → ``(y, aux)``, ``aux`` the
    Switch load-balancing loss ``E · mean_b Σ_e frac_e · mean_gate_e``
    (about 1 when balanced).

    ``h``: [B, T, d] bf16 after the LayerNorm.  Each token goes to its
    expert's queue in token order; a token past the expert's capacity C is
    dropped (a zero delta: the residual carries it).  The 0/1 dispatch
    tensor [B, T, E, C] gathers the tokens, the experts run as bf16
    einsums, and the combine tensor (dispatch · gate value) scatters them
    back.  ``router_x`` is the f32 routing input (``_router_features``);
    without it the block routes on ``h`` itself."""
    E, C = cfg.n_experts, cfg.expert_capacity
    rx = h.float() if router_x is None else router_x
    logits, eidx = _route(rx, lp["router_w"])
    gate = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(eidx, E).float()                 # [B, T, E]
    gateval = (gate * onehot).sum(dim=-1)               # [B, T]
    pos = torch.cumsum(onehot, dim=1) * onehot          # 1-based queue slot
    keep = (pos > 0) & (pos <= C)
    slot = torch.clamp(pos - 1, 0, C - 1).long()
    slot1h = F.one_hot((slot * onehot.long()).sum(dim=-1), C).float()
    disp = (onehot * keep.float())[..., None] * slot1h[:, :, None, :]
    comb = disp * gateval[..., None, None]              # [B, T, E, C]

    xin = torch.einsum("btec,btd->becd", _bf16(disp), h)
    z = torch.einsum("becd,edh->bech", xin, _bf16(lp["moe_in_w"]))
    z = F.gelu(z + _bf16(lp["moe_in_b"])[None, :, None], approximate="tanh")
    z = torch.einsum("bech,ehd->becd", z, _bf16(lp["moe_out_w"]))
    z = z + _bf16(lp["moe_out_b"])[None, :, None]
    y = torch.einsum("btec,becd->btd", _bf16(comb), z)
    frac = onehot.mean(dim=1)                           # [B, E]
    mean_gate = gate.mean(dim=1)                        # [B, E]
    return y, E * (frac * mean_gate).sum(dim=-1).mean()


def block_forward_aux(x: torch.Tensor, lp: Dict[str, Any], cfg: ViTConfig,
                      router_x: Optional[torch.Tensor] = None):
    """One transformer block on the bf16 residual stream [B, T, width] →
    ``(x', aux)``, ``aux`` the MoE load-balancing loss (0.0 for a dense
    layer); an MoE layer routes on ``router_x`` (``_router_features``)."""
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
    if "router_w" in lp:
        y, aux = _moe_mlp(h, lp, cfg, router_x)
        return x + y, aux
    h = h @ _bf16(lp["mlp_in_w"]) + _bf16(lp["mlp_in_b"])
    h = F.gelu(h, approximate="tanh")
    h = h @ _bf16(lp["mlp_out_w"]) + _bf16(lp["mlp_out_b"])
    return x + h, 0.0


def head(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Final LN on the cls token → f32 logits."""
    x = _ln(x.float(), params["ln_f_scale"].float(),
            params["ln_f_bias"].float())
    return x[:, 0] @ params["head_w"].float() + params["head_b"].float()


def forward(params: Dict[str, Any], frames: torch.Tensor,
            cfg: ViTConfig, with_aux: bool = False):
    """ViT forward: [B, H, W, 3] float in [0,1] → [B, n_classes] f32
    logits, on the device the frames and parameters lie on;
    ``with_aux`` returns ``(logits, MoE load-balancing loss)`` (0.0 for a
    dense config).  With
    ``cfg.remat`` and autograd on, each block is recomputed in the
    backward pass instead of keeping its activations."""
    x = embed(params, frames, cfg)
    router_x = (_router_features(params, frames, cfg) if cfg.n_experts
                else None)
    remat = cfg.remat and torch.is_grad_enabled()
    aux_total = 0.0
    for lp in params["layers"]:
        if remat:
            x, aux = torch_checkpoint.checkpoint(
                block_forward_aux, x, lp, cfg, router_x,
                use_reentrant=False)
        else:
            x, aux = block_forward_aux(x, lp, cfg, router_x)
        aux_total = aux_total + aux
    logits = head(params, x)
    return (logits, aux_total) if with_aux else logits


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _bce(z: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Numerically stable sigmoid BCE-with-logits in f32, mean over the
    batch."""
    z = z.float()
    y = labels.float()
    per = torch.clamp(z, min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
    return per.mean()


def _logit_l2(z: torch.Tensor, coef: float) -> torch.Tensor:
    """Score-scale regulariser ``coef · mean(z²)`` on the raw logits: it
    bounds the training families' margins so an unseen family's scores
    separate at 0.5 (``avd_tpu/models/detector.py:630-643``)."""
    return coef * torch.mean(torch.square(z.float()))


def loss_fn(params, frames, labels, cfg: ViTConfig,
            logit_l2: float = 0.0) -> torch.Tensor:
    """Sigmoid BCE in f32 (labels [B] in {0, 1}); an MoE config adds the
    Switch load-balancing loss at 0.01, ``logit_l2`` the score-scale
    regulariser."""
    out, aux = forward(params, frames, cfg, with_aux=True)
    z = out[:, 0]
    loss = _bce(z, labels)
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    if logit_l2:
        loss = loss + _logit_l2(z, logit_l2)
    return loss


def make_train_step(cfg, optimizer, loss=None, logit_l2: float = 0.0):
    """(params, opt_state, frames, labels) → (params, opt_state, loss).

    ``params`` is the f32 tree; the step takes the gradients of ``loss``
    (default this module's ``loss_fn``; the CNN and temporal families pass
    their own) with autograd and lets ``optimizer`` (``optim.AdamW``)
    update the leaves in place."""
    loss = loss or loss_fn

    def step(params, opt_state, frames, labels):
        leaves = optim.leaves_of(params)
        for p in leaves:
            p.requires_grad_(True)
        lval = loss(params, frames, labels, cfg, logit_l2=logit_l2)
        # a leaf the loss does not use gets a zero gradient, as in JAX
        grads = torch.autograd.grad(lval, leaves, materialize_grads=True)
        optimizer.update(leaves, grads, opt_state)
        return params, opt_state, lval.detach()

    return step


make_optimizer = optim.make_optimizer


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] f32 weights of ``jax.image.resize``'s bilinear
    (triangle) kernel along one axis, antialiased: the kernel widens by
    n_in / n_out when the grid shrinks, columns normalised
    (``jax/_src/image/scale.py::compute_weight_mat``)."""
    f = np.float32
    inv = 1.0 / (n_out / n_in)
    kscale = f(max(inv, 1.0))
    sample = (np.arange(n_out, dtype=f) + f(0.5)) * f(inv) - f(0.0) - f(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f)[:, None]) / kscale
    w = np.maximum(f(0), f(1) - np.abs(x))
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f(1)), f(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f(0)).astype(f)


def interpolate_pos_emb(params: Dict[str, Any],
                        cfg_new: ViTConfig) -> Dict[str, Any]:
    """Adapt a tree trained at one resolution to ``cfg_new``'s token grid:
    the cls row of ``pos_emb`` is kept, the patch grid [g, g, d] resized
    bilinearly as ``jax.image.resize`` does (antialiased when it shrinks)
    and flattened back.  Every other leaf is resolution-independent and
    kept as it is; a tree already at the grid is returned unchanged."""
    pos = params["pos_emb"].detach().float().cpu()
    t_old = pos.shape[0] - 1
    g_old = int(round(t_old ** 0.5))
    g_new = cfg_new.image_size // cfg_new.patch
    if g_old * g_old != t_old:
        raise ValueError(f"pos_emb grid {t_old} is not square")
    if g_new * g_new + 1 == pos.shape[0]:
        return params
    w = torch.from_numpy(_resize_weights(g_old, g_new))
    grid = pos[1:].reshape(g_old, g_old, pos.shape[1])
    resized = torch.einsum("ijd,ia,jb->abd", grid, w, w)
    out = dict(params)
    out["pos_emb"] = torch.cat(
        [pos[:1], resized.reshape(g_new * g_new, pos.shape[1])]).to(
            params["pos_emb"].device)
    return out
