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
port's ``params.npz`` (``convert.save_checkpoint``).  ``avd_tpu``'s
``scan`` option rolls the layers into one ``lax.scan`` to shrink XLA's
program and computes what the loop computes: the port has no counterpart.

Inference over a rank group (``parallel/``): ``param_specs`` is
``avd_tpu``'s tensor-parallel plan (qkv and MLP-in column-sharded,
projections row-sharded over ``model``, experts over ``model``).
``avd_tpu`` annotates it and lets GSPMD place the collectives; here each
rank holds its slices (``shard``: qkv columns head-major first, so a
contiguous slice holds whole heads) and ``forward(..., sharded=True,
mesh=...)`` writes the collectives out: the batch over ``data``, each
block through ``block_forward_tp`` with one ``psum`` over ``model`` after
each row-sharded product (Megatron), the experts' share of an MoE
combine summed the same way, and with ``seq_sharded`` the residual's
token axis sharded over ``model`` (reduce-scatter out of each region,
all-gather into it).  ``forward_pipelined`` runs the layer stack as a
GPipe pipeline over ``stage`` (``parallel/pipeline.py``), alone or with
``data`` and, dense only, ``model``.  The sharded programs keep the einsum
attention, as ``avd_tpu`` does.

Training over a rank group: ``make_train_step(..., sharded=True)`` is the
dp × tp step (each rank's loss on its ``data`` slice, the gradients
averaged over ``data`` by ``parallel/zero.py``, with ZeRO-1 or FSDP on
request), ``make_pp_train_step`` the GPipe step; ``layout`` and
``pp_layout`` say where a rank's slices of the tree live, and
``load_checkpoint_sharded`` restores a checkpoint straight into them.
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
from avd_tpu_torch.parallel import collectives as col
from avd_tpu_torch.parallel import mesh as mesh_mod
from avd_tpu_torch.parallel import pipeline as pl
from avd_tpu_torch.parallel import zero
from avd_tpu_torch.parallel.mesh import P


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


def param_specs(cfg: ViTConfig) -> Dict[str, Any]:
    """The tensor-parallel plan, per parameter path
    (``avd_tpu/models/detector.py:114-142``): ``model`` shards the
    attention heads, the MLP hidden width and, for an MoE config, the
    expert axis; everything else replicates."""
    layer = {
        "ln1_scale": P(), "ln1_bias": P(),
        "qkv_w": P(None, "model"), "qkv_b": P("model"),
        "proj_w": P("model", None), "proj_b": P(),
        "ln2_scale": P(), "ln2_bias": P(),
    }
    if cfg.n_experts:
        layer.update({
            "router_w": P(),
            "moe_in_w": P("model", None, None), "moe_in_b": P("model", None),
            "moe_out_w": P("model", None, None),
            "moe_out_b": P("model", None),
        })
    else:
        layer.update({
            "mlp_in_w": P(None, "model"), "mlp_in_b": P("model"),
            "mlp_out_w": P("model", None), "mlp_out_b": P(),
        })
    return {
        "patch_w": P(), "patch_b": P(),
        "pos_emb": P(), "cls_tok": P(),
        "layers": [dict(layer) for _ in range(cfg.depth)],
        "ln_f_scale": P(), "ln_f_bias": P(),
        "head_w": P(), "head_b": P(),
    }


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


def _moe_route(h: torch.Tensor, lp: Dict[str, Any], cfg: ViTConfig,
               router_x: Optional[torch.Tensor]):
    """Top-1 routing of ``_moe_mlp`` → (dispatch [B, T, E, C] 0/1, combine
    = dispatch · gate value, one-hot choice [B, T, E], gate softmax)."""
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
    return disp, disp * gateval[..., None, None], onehot, gate


def _experts(h: torch.Tensor, disp: torch.Tensor, comb: torch.Tensor,
             lp: Dict[str, Any], partial: bool = False) -> torch.Tensor:
    """The experts of ``lp`` (leading axis E) on their dispatched tokens,
    scattered back by ``comb`` (bf16 einsums) → [B, T, d]; ``partial``
    leaves the combine in f32 (a rank's share of an expert-parallel sum,
    ``block_forward_tp``)."""
    xin = torch.einsum("btec,btd->becd", _bf16(disp), h)
    z = torch.einsum("becd,edh->bech", xin, _bf16(lp["moe_in_w"]))
    z = F.gelu(z + _bf16(lp["moe_in_b"])[None, :, None], approximate="tanh")
    z = torch.einsum("bech,ehd->becd", z, _bf16(lp["moe_out_w"]))
    z = z + _bf16(lp["moe_out_b"])[None, :, None]
    if partial:
        return torch.einsum("btec,becd->btd", _bf16(comb).float(), z.float())
    return torch.einsum("btec,becd->btd", _bf16(comb), z)


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
    E = cfg.n_experts
    disp, comb, onehot, gate = _moe_route(h, lp, cfg, router_x)
    y = _experts(h, disp, comb, lp)
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


def _tp_shuffle_qkv(layers, cfg: ViTConfig):
    """Each layer's qkv_w/qkv_b columns permuted from ``(3, heads,
    head_dim)`` to ``(heads, 3, head_dim)``, so a contiguous column slice
    over ``model`` holds whole heads: the layout ``block_forward_tp``
    reads (``avd_tpu/models/detector.py:456-465``)."""
    idx = np.arange(3 * cfg.width).reshape(3, cfg.heads, cfg.head_dim)
    idx = torch.from_numpy(idx.transpose(1, 0, 2).reshape(-1))
    return [dict(lp, qkv_w=lp["qkv_w"][:, idx.to(lp["qkv_w"].device)],
                 qkv_b=lp["qkv_b"][idx.to(lp["qkv_b"].device)])
            for lp in layers]


def _tp_unshuffle_qkv(layers, cfg: ViTConfig):
    """The inverse of ``_tp_shuffle_qkv``."""
    idx = np.arange(3 * cfg.width).reshape(3, cfg.heads, cfg.head_dim)
    inv = np.argsort(idx.transpose(1, 0, 2).reshape(-1))
    inv = torch.from_numpy(inv)
    return [dict(lp, qkv_w=lp["qkv_w"][:, inv.to(lp["qkv_w"].device)],
                 qkv_b=lp["qkv_b"][inv.to(lp["qkv_b"].device)])
            for lp in layers]


def layout(mesh, cfg: ViTConfig, fsdp: bool = False) -> zero.Layout:
    """Where the tree of ``forward(..., sharded=True)`` and the sharded
    train step lives on a rank: the qkv columns head-major, each leaf cut
    by ``param_specs``, and with ``fsdp`` also over ``data``
    (``zero.fsdp_param_specs``)."""
    specs = param_specs(cfg)
    if fsdp:
        specs = zero.fsdp_param_specs(param_shapes(cfg), specs,
                                      col.axis_size(mesh, "data"))
    return zero.Layout(
        mesh, specs,
        lambda t: dict(t, layers=_tp_shuffle_qkv(t["layers"], cfg)),
        lambda t: dict(t, layers=_tp_unshuffle_qkv(t["layers"], cfg)))


def shard(mesh, params: Dict[str, Any], cfg: ViTConfig) -> Dict[str, Any]:
    """This rank's shards of the tree for ``forward(..., sharded=True)``:
    the qkv columns head-major (``_tp_shuffle_qkv``), then each leaf cut
    by ``param_specs``."""
    return layout(mesh, cfg).shard(params)


def _pad_tokens(x: torch.Tensor, t: int) -> torch.Tensor:
    """[B, T, d] → [B, t, d], zero rows appended."""
    if x.shape[1] == t:
        return x
    return torch.cat([x, x.new_zeros(x.shape[0], t - x.shape[1],
                                     x.shape[2])], dim=1)


def block_forward_tp(x: torch.Tensor, lp: Dict[str, Any], cfg: ViTConfig,
                     mesh, axis: str = "model",
                     router_x: Optional[torch.Tensor] = None,
                     seq_tokens: int = 0, with_aux: bool = False):
    """One transformer block with the Megatron collectives written out
    (``avd_tpu/models/detector.py:406-453``).

    ``lp`` holds this rank's shards: qkv and MLP-in column-sliced over
    ``axis`` (the local heads, qkv head-major as ``_tp_shuffle_qkv``
    lays it out, and the local hidden width), the projections row-sliced;
    for an MoE layer the local experts (``_moe_mlp``'s routing is computed
    in full from the replicated f32 ``router_x`` on every rank, each rank
    runs its experts' share of the combine).  Each region exits through
    one ``psum`` over ``axis`` of the ranks' f32 partial products, rounded
    to bf16 once after the sum and its bias added before the residual, as
    ``block_forward_aux`` rounds and adds on one device.  (``avd_tpu``
    sums bf16 partials and adds the bias after the residual, which costs
    most of the 2e-2 logit budget on the trained ``full`` ViT.)  Each
    region's input enters through ``col.enter`` (the identity; its
    gradient summed over ``axis``), as does the routing's combine tensor
    before a rank takes its experts' columns, so the gradients of the
    replicated leaves are whole and equal on every rank.

    ``seq_tokens`` > 0 is Megatron sequence parallelism: ``x`` is this
    rank's block of the residual's token axis (the stream of
    ``seq_tokens`` tokens, zero-padded to a multiple of the axis), a
    region's input is all-gathered over tokens after its LayerNorm and its
    exit reduce-scattered over tokens.  ``with_aux`` returns ``(x', aux)``,
    ``aux`` the MoE load-balancing loss of this rank's examples (0.0 for a
    dense layer)."""
    m = col.axis_size(mesh, axis)
    if seq_tokens:
        t_pad = x.shape[1] * m

        def enter(h):
            return col.all_gather(h, mesh, axis, dim=1)[:, :seq_tokens]

        def leave(y):
            return _bf16(col.psum_scatter(_pad_tokens(y, t_pad), mesh, axis,
                                          dim=1))
    else:
        def enter(h):
            return col.enter(h, mesh, axis)

        def leave(y):
            return _bf16(col.psum(y, mesh, axis))

    local_width = lp["qkv_w"].shape[1] // 3
    local_heads = local_width // cfg.head_dim
    h = enter(_bf16(_ln(x.float(), lp["ln1_scale"], lp["ln1_bias"])))
    qkv = h @ _bf16(lp["qkv_w"]) + _bf16(lp["qkv_b"])
    b, t, _ = qkv.shape
    qkv = qkv.reshape(b, t, local_heads, 3, cfg.head_dim)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]
    att = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    att = torch.softmax(att / np.sqrt(cfg.head_dim), dim=-1)
    o = torch.einsum("bhts,bshd->bthd", _bf16(att).float(), v.float())
    o = _bf16(o.reshape(b, t, local_width))
    x = x + (leave(_partial(o, lp["proj_w"])) + _bf16(lp["proj_b"]))

    h = enter(_bf16(_ln(x.float(), lp["ln2_scale"], lp["ln2_bias"])))
    aux = 0.0
    if "router_w" in lp:
        disp, comb, onehot, gate = _moe_route(h, lp, cfg, router_x)
        comb = col.enter(comb, mesh, axis)
        n_local = lp["moe_in_w"].shape[0]
        e0 = col.axis_index(mesh, axis) * n_local
        y = _experts(h, disp[:, :, e0:e0 + n_local],
                     comb[:, :, e0:e0 + n_local], lp, partial=True)
        x = x + leave(y)
        if with_aux:
            aux = cfg.n_experts * (onehot.mean(dim=1) * gate.mean(dim=1)
                                   ).sum(dim=-1).mean()
    else:
        h = h @ _bf16(lp["mlp_in_w"]) + _bf16(lp["mlp_in_b"])
        h = F.gelu(h, approximate="tanh")
        x = x + (leave(_partial(h, lp["mlp_out_w"]))
                 + _bf16(lp["mlp_out_b"]))
    return (x, aux) if with_aux else x


def _partial(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A rank's share of a row-sharded product, unrounded: the bf16
    operands multiplied in f32 (their products are exact)."""
    return a.float() @ _bf16(w).float()


def head(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """Final LN on the cls token → f32 logits."""
    x = _ln(x.float(), params["ln_f_scale"].float(),
            params["ln_f_bias"].float())
    return x[:, 0] @ params["head_w"].float() + params["head_b"].float()


def forward(params: Dict[str, Any], frames: torch.Tensor,
            cfg: ViTConfig, with_aux: bool = False, sharded: bool = False,
            seq_sharded: bool = False, mesh=None):
    """ViT forward: [B, H, W, 3] float in [0,1] → [B, n_classes] f32
    logits, on the device the frames and parameters lie on;
    ``with_aux`` returns ``(logits, MoE load-balancing loss)`` (0.0 for a
    dense config).  With
    ``cfg.remat`` and autograd on, each block is recomputed in the
    backward pass instead of keeping its activations.

    ``sharded`` runs this rank's share over ``mesh`` (dims ``data`` and
    ``model``): ``params`` are its shards (``shard``), ``frames`` the
    whole batch (any device; the batch must divide by ``data``); every
    rank returns every logit, and ``with_aux`` the mean of the ranks'
    losses over ``data`` (the global batch's: the slices are equal).
    ``seq_sharded`` adds sequence parallelism (``block_forward_tp``)."""
    if sharded:
        _check_mesh(mesh)
        frames = mesh_mod.batch_slice(mesh, frames, "data").to(
            params["patch_w"].device)
        logits, aux = _forward_local(params, frames, cfg, mesh, seq_sharded)
        logits = col.all_gather(logits, mesh, "data", dim=0)
        if not with_aux:
            return logits
        n = col.axis_size(mesh, "data")
        return logits, col.psum(torch.as_tensor(
            aux, dtype=torch.float32, device=logits.device), mesh,
            "data") / n
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


def _check_mesh(mesh) -> None:
    if mesh is None or not {"data", "model"} <= set(mesh.mesh_dim_names):
        raise ValueError("sharded=True needs a mesh with 'data' and "
                         "'model' dims")


def _fsdp_block(x, lp, lspecs, cfg, mesh, router_x):
    return block_forward_tp(x, zero.gather_leaves(lp, lspecs, mesh), cfg,
                            mesh, "model", router_x, with_aux=True)


def _forward_local(params, frames, cfg: ViTConfig, mesh,
                   seq_sharded: bool = False, fsdp_specs=None):
    """This rank's share of the sharded forward on its own ``frames`` (its
    ``data`` slice, on its device) → (its logits, its examples' MoE loss).

    ``fsdp_specs`` (``parallel/zero.fsdp_param_specs``): ``params`` hold
    this rank's FSDP slices; each block all-gathers its leaves over
    ``data`` when it runs and again when the backward pass recomputes it,
    so one block's gathered weights live at a time."""
    top = {k: v for k, v in params.items() if k != "layers"}
    if fsdp_specs is not None:
        top = zero.gather_leaves(top, {k: fsdp_specs[k] for k in top}, mesh)
    x = embed(top, frames, cfg)
    router_x = (_router_features(top, frames, cfg) if cfg.n_experts
                else None)
    seq_tokens = 0
    if seq_sharded:
        m = col.axis_size(mesh, "model")
        seq_tokens = cfg.tokens
        x = _pad_tokens(x, -(-seq_tokens // m) * m)
        x = x.chunk(m, dim=1)[col.axis_index(mesh, "model")].contiguous()
    ckpt = torch.is_grad_enabled() and (cfg.remat or fsdp_specs is not None)
    aux_total = 0.0
    for i, lp in enumerate(params["layers"]):
        if fsdp_specs is not None:
            x, aux = torch_checkpoint.checkpoint(
                _fsdp_block, x, lp, fsdp_specs["layers"][i], cfg, mesh,
                router_x, use_reentrant=False)
        elif ckpt:
            x, aux = torch_checkpoint.checkpoint(
                block_forward_tp, x, lp, cfg, mesh, "model", router_x,
                seq_tokens, True, use_reentrant=False)
        else:
            x, aux = block_forward_tp(x, lp, cfg, mesh, "model", router_x,
                                      seq_tokens, with_aux=True)
        aux_total = aux_total + aux
    if seq_sharded:
        x = col.all_gather(x, mesh, "model", dim=1)[:, :seq_tokens]
    return head(top, x), aux_total


def forward_pipelined(params: Dict[str, Any], frames: torch.Tensor,
                      cfg: ViTConfig, mesh, n_micro: int = 0,
                      tp: bool = False) -> torch.Tensor:
    """Pipeline-parallel ViT forward over the mesh's ``stage`` dim (with
    ``data`` when the mesh has it) (``avd_tpu/models/detector.py:518-617``):
    each stage runs its ``depth/S`` layers of the stacked tree, microbatches
    stream through the GPipe ring (``parallel/pipeline.py``); embed and
    head run outside the pipeline.  ``params`` is the whole tree, on the
    rank's device, and ``frames`` the whole batch (any device); every rank
    returns every logit.

    ``n_micro`` defaults to the stage count; the batch must divide by it
    and each microbatch by ``data``.  An MoE stack routes on the f32
    pre-gating features, which ride the ring beside the activations.
    ``tp=True`` also slices every stage's blocks over ``model``
    (``block_forward_tp``, dense only; heads and MLP width must divide by
    the axis): the dp × pp × tp configuration."""
    _check_pipeline(cfg, mesh, tp)
    return _forward_pp(pp_layout(mesh, cfg, tp).shard(params), frames, cfg,
                       mesh, n_micro, tp)


def _check_pipeline(cfg: ViTConfig, mesh, tp: bool) -> None:
    n_stages = col.axis_size(mesh, "stage")
    if cfg.depth % n_stages:
        raise ValueError(f"depth {cfg.depth} not divisible by "
                         f"{n_stages} stages")
    if tp:
        if "model" not in mesh.mesh_dim_names:
            raise ValueError("tp=True needs a 'model' mesh axis")
        if cfg.n_experts:
            raise ValueError("tp=True composes dense blocks only "
                             "(block_forward_tp); MoE uses the sharded "
                             "forward")
        m = col.axis_size(mesh, "model")
        if cfg.heads % m or cfg.mlp_width % m:
            raise ValueError(f"heads {cfg.heads} / mlp {cfg.mlp_width} "
                             f"not divisible by model axis {m}")


def pp_layout(mesh, cfg: ViTConfig, tp: bool = False) -> zero.Layout:
    """Where the pipeline's tree lives on a rank: the embedding and head
    leaves replicated, the layers stacked ``[depth, ...]`` under
    ``"stages"`` and cut over ``stage`` (with ``tp``, also over ``model``
    by ``param_specs`` after the head-major qkv shuffle)."""
    layer_specs = param_specs(cfg)["layers"][0]
    stage = {k: P("stage", *(layer_specs[k] if tp else ()))
             for k in layer_specs}
    top = {k: P() for k in param_specs(cfg) if k != "layers"}

    def permute(tree):
        layers = tree["layers"]
        if tp:
            layers = _tp_shuffle_qkv(layers, cfg)
        out = {k: v for k, v in tree.items() if k != "layers"}
        out["stages"] = pl.stack_layers(layers)
        return out

    def unpermute(pp):
        n = next(iter(pp["stages"].values())).shape[0]
        layers = [{k: v[i] for k, v in pp["stages"].items()}
                  for i in range(n)]
        if tp:
            layers = _tp_unshuffle_qkv(layers, cfg)
        out = {k: v for k, v in pp.items() if k != "stages"}
        out["layers"] = layers
        return out

    return zero.Layout(mesh, dict(top, stages=stage), permute, unpermute)


def _pp_rows(mesh, x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """A batch [B, ...] → this rank's rows, microbatch-major: the batch cut
    into ``n_micro`` microbatches, each sliced over ``data``."""
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible by {n_micro} microbatches")
    mb = B // n_micro
    n_data = col.axis_size(mesh, "data") \
        if "data" in mesh.mesh_dim_names else 1
    if mb % n_data:
        raise ValueError(f"microbatch {mb} not divisible by data axis "
                         f"{n_data}")
    f = x.reshape((n_micro, mb) + tuple(x.shape[1:]))
    if n_data > 1:
        f = mesh_mod.batch_slice(mesh, f.transpose(0, 1), "data") \
            .transpose(0, 1)
    return f.reshape((-1,) + tuple(x.shape[1:]))


def _forward_pp(pp: Dict[str, Any], frames: torch.Tensor, cfg: ViTConfig,
                mesh, n_micro: int = 0, tp: bool = False,
                gather: bool = True) -> torch.Tensor:
    """The pipelined forward on this rank's ``pp_layout`` slices ``pp``;
    ``gather=False`` returns this rank's logits alone, in ``_pp_rows``
    order (the training loss)."""
    names = mesh.mesh_dim_names
    n_stages = col.axis_size(mesh, "stage")
    n_micro = n_micro or n_stages
    B = frames.shape[0]
    f = _pp_rows(mesh, frames, n_micro).to(pp["patch_w"].device)
    rows = f.shape[0] // n_micro

    def micro(t):
        return t.reshape(n_micro, rows, cfg.tokens, cfg.width)

    xs = micro(embed(pp, f, cfg))
    if cfg.n_experts:
        # the pre-gating features ride the ring as a second leaf
        xs = (xs, micro(_router_features(pp, f, cfg)))

        def stage_fn(sp, xm):
            h, r = xm
            return (pl.scan_layers(
                lambda hc, lp: block_forward_aux(hc, lp, cfg, r)[0], sp, h),
                r)
    elif tp:
        def stage_fn(sp, xm):
            return pl.scan_layers(
                lambda h, lp: block_forward_tp(h, lp, cfg, mesh, "model"),
                sp, xm)
    else:
        def stage_fn(sp, xm):
            return pl.scan_layers(
                lambda h, lp: block_forward_aux(h, lp, cfg)[0], sp, xm)

    ys = pl.gpipe(stage_fn, pp["stages"], xs, n_stages, mesh)
    if cfg.n_experts:
        ys = ys[0]
    logits = head(pp, ys.reshape(-1, cfg.tokens, cfg.width))
    if not gather:
        return logits
    logits = logits.reshape(n_micro, rows, -1)
    if "data" in names and col.axis_size(mesh, "data") > 1:
        logits = col.all_gather(logits, mesh, "data", dim=1)
    return logits.reshape(B, -1)


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
            logit_l2: float = 0.0, mesh=None, fsdp_specs=None
            ) -> torch.Tensor:
    """Sigmoid BCE in f32 (labels [B] in {0, 1}); an MoE config adds the
    Switch load-balancing loss at 0.01, ``logit_l2`` the score-scale
    regulariser.  With ``mesh``, ``params`` are this rank's shards
    (``layout``; ``fsdp_specs`` for FSDP slices) and ``frames``/``labels``
    its ``data`` slice of the batch: the loss is this rank's share, which
    the step averages over ``data``."""
    if mesh is None:
        out, aux = forward(params, frames, cfg, with_aux=True)
    else:
        out, aux = _forward_local(params, frames, cfg, mesh,
                                  fsdp_specs=fsdp_specs)
    z = out[:, 0]
    loss = _bce(z, labels)
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    if logit_l2:
        loss = loss + _logit_l2(z, logit_l2)
    return loss


def _grads(lval, leaves):
    # a leaf the loss does not use gets a zero gradient, as in JAX
    return torch.autograd.grad(lval, leaves, materialize_grads=True)


def make_train_step(cfg, optimizer, loss=None, logit_l2: float = 0.0,
                    sharded: bool = False, mesh=None, zero_mode=None,
                    specs=None):
    """(params, opt_state, frames, labels) → (params, opt_state, loss).

    ``params`` is the f32 tree; the step takes the gradients of ``loss``
    (default this module's ``loss_fn``; the CNN and temporal families pass
    their own) with autograd and lets ``optimizer`` (``optim.AdamW``)
    update the leaves in place.

    ``sharded`` is the step over ``mesh``'s (``data``, ``model``) ranks
    (``avd_tpu/models/detector.py:656-672``): ``params`` hold this rank's
    slices as ``specs`` lay them out (default ``layout(mesh, cfg)``'s;
    the CNN and temporal families pass theirs), ``frames`` and ``labels``
    the whole batch, of which the step keeps its ``data`` slice;
    ``zero_mode`` is ``parallel/zero.py``'s (``None``: replicated over
    ``data``; ``"zero1"``; ``"fsdp"``, with ``specs`` the FSDP ones).  The
    optimizer state comes from ``step.dp.init(leaves)``, and the loss
    returned is the global batch's."""
    loss = loss or loss_fn
    if not sharded:
        if zero_mode:
            raise ValueError(f"zero_mode={zero_mode!r} needs sharded=True "
                             "and a mesh")

        def step(params, opt_state, frames, labels):
            leaves = optim.leaves_of(params)
            for p in leaves:
                p.requires_grad_(True)
            lval = loss(params, frames, labels, cfg, logit_l2=logit_l2)
            optimizer.update(leaves, _grads(lval, leaves), opt_state)
            return params, opt_state, lval.detach()

        return step

    _check_mesh(mesh)
    if specs is None:
        specs = layout(mesh, cfg, fsdp=zero_mode == "fsdp").specs
    dp = zero.DataParallel(optimizer, mesh, zero.spec_leaves(specs),
                           zero_mode or "replicated")
    fsdp_specs = specs if zero_mode == "fsdp" else None

    def sharded_step(params, opt_state, frames, labels):
        leaves = optim.leaves_of(params)
        dev = leaves[0].device
        for p in leaves:
            p.requires_grad_(True)
        lval = loss(params, mesh_mod.batch_slice(mesh, frames).to(dev),
                    mesh_mod.batch_slice(mesh, labels).to(dev), cfg,
                    logit_l2=logit_l2, mesh=mesh, fsdp_specs=fsdp_specs)
        dp.update(leaves, _grads(lval, leaves), opt_state)
        return params, opt_state, dp.mean(lval.detach())

    sharded_step.dp = dp
    return sharded_step


def make_pp_train_step(cfg: ViTConfig, optimizer, mesh, n_micro: int = 0,
                       tp: bool = False):
    """The train step whose forward runs pipeline-parallel over ``mesh``'s
    ``stage`` dim (``avd_tpu/models/detector.py:675-696``): ``params`` are
    this rank's ``pp_layout(mesh, cfg, tp)`` slices, ``frames`` and
    ``labels`` the whole batch; each rank takes the BCE on its ``data``
    rows and the gradients flow back through the GPipe schedule
    (``parallel/pipeline.py``), then average over ``data``.  Dense configs:
    the MoE loss is not collected on the pipelined path in ``avd_tpu``,
    so an MoE config raises here (``avd_tpu`` trains it
    without its load-balancing loss).  The optimizer state comes from
    ``step.dp.init``."""
    if cfg.n_experts:
        raise ValueError("the pipelined loss collects no MoE "
                         "load-balancing loss: dense configs only "
                         "(avd_tpu/models/detector.py:680-681)")
    _check_pipeline(cfg, mesh, tp)
    lay = pp_layout(mesh, cfg, tp)
    dp = zero.DataParallel(optimizer, mesh, zero.spec_leaves(lay.specs))
    n_micro = n_micro or col.axis_size(mesh, "stage")

    def step(pp, opt_state, frames, labels):
        leaves = optim.leaves_of(pp)
        for p in leaves:
            p.requires_grad_(True)
        logits = _forward_pp(pp, frames, cfg, mesh, n_micro, tp,
                             gather=False)
        rows = _pp_rows(mesh, labels, n_micro).to(logits.device)
        lval = _bce(logits[:, 0], rows)
        dp.update(leaves, _grads(lval, leaves), opt_state)
        return pp, opt_state, dp.mean(lval.detach())

    step.dp = dp
    step.layout = lay
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


def load_checkpoint_sharded(path: str, cfg, lay: zero.Layout, device=None):
    """Restore the checkpoint directory ``path`` (the port's ``params.npz``)
    straight into this rank's slices under ``lay`` (``layout``,
    ``pp_layout``, the FSDP layout, or another family's): each rank reads
    the file and puts only its slices on ``device`` (default CUDA)
    (``avd_tpu/models/detector.py:790-814``).  Any family whose
    ``convert.load_checkpoint`` reads the file."""
    from avd_tpu_torch.models import convert
    dev = device_mod.resolve(device)
    return _map_tree(lambda _, x: x.to(dev),
                     lay.shard(convert.load_checkpoint(path, cfg)))
