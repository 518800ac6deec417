"""Per-frame AI-content detector — the ConvNeXt-style CNN.

Port of ``avd_tpu/models/cnn.py`` on one device: the config and presets, a
seeded initialiser, the loss and train step (the ViT's optimizer step over
this family's loss), and the forward pass over a parameter dict
with the JAX package's keys and layouts (``[in, out]`` dense weights, the
depthwise kernel as HWIO ``[k, k, 1, C]``), so a converted checkpoint
drops in unchanged (``models/convert.py``).

The stem and the stage downsamples are non-overlapping patch merges
(reshape, then a matmul); the block's expand and project are channel
matmuls; the one true convolution is the depthwise k×k, SAME-padded, which
``avd_tpu`` leaves to XLA and the port to ``F.conv2d`` (a library call: no
Pallas kernel stands behind it).  Numerics follow the JAX forward: every
product and the stream between LayerNorms are bf16, each bias added in
bf16 after its product; LayerNorm runs in f32 (eps 1e-6) and is cast back;
GELU is the tanh approximation; the global pool, final LayerNorm and head
are f32.

Over a rank group, ``param_specs`` is ``avd_tpu``'s plan (block expand
column-sharded, project row-sharded over ``model``, the rest
replicated); ``shard`` cuts a rank's slices and ``forward(...,
sharded=True, mesh=...)`` runs the batch over ``data`` and each block's
MLP over ``model`` with one ``psum`` a block (of the f32 partial
products, ``detector.block_forward_tp``), where ``avd_tpu`` lets GSPMD
insert it.  The depthwise convolution sees every channel, so no
halo is needed.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.models import detector
from avd_tpu_torch.models.detector import _bf16, _ln, _map_tree
from avd_tpu_torch.parallel import collectives as col
from avd_tpu_torch.parallel import mesh as mesh_mod
from avd_tpu_torch.parallel import zero
from avd_tpu_torch.parallel.mesh import P


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    image_size: int = 64
    stem_patch: int = 4
    widths: Tuple[int, ...] = (64, 128, 256)
    depths: Tuple[int, ...] = (1, 2, 2)
    expand: int = 4
    kernel: int = 7
    n_classes: int = 1

    @property
    def stages(self) -> int:
        return len(self.widths)


Config = CNNConfig

PRESETS = {
    "small": {},  # the defaults above: 64 px, widths (64, 128, 256)
    # the 224 px serving-size variant
    "full": dict(image_size=224, widths=(128, 256, 512), depths=(2, 2, 4)),
}

# bf16 operands of the forward pass (cast_for_inference); LayerNorms,
# gamma and the head stay f32
_BF16 = ("stem_w", "stem_b", "down_w", "down_b", "dw_w", "dw_b", "exp_w",
         "exp_b", "proj_w", "proj_b")


def make_config(preset: str = "small", **over) -> CNNConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown CNN preset {preset!r}; "
                         f"choose from {sorted(PRESETS)}")
    kw = dict(PRESETS[preset])
    kw.update(over)
    return CNNConfig(**kw)


def stored_bf16(cfg: CNNConfig):
    """The leaves every served mode reads in bf16, which a checkpoint may
    store as bf16: the depthwise kernels and their biases (the int8
    forward reads every other leaf in f32)."""
    return ("dw_w", "dw_b")


def param_specs(cfg: CNNConfig) -> Dict[str, Any]:
    """The tensor-parallel plan (``avd_tpu/models/cnn.py:90-110``): block
    expand column-sharded and project row-sharded over ``model``; merges,
    depthwise kernels and norms replicate."""
    def block():
        return {
            "dw_w": P(), "dw_b": P(),
            "ln_scale": P(), "ln_bias": P(),
            "exp_w": P(None, "model"), "exp_b": P("model"),
            "proj_w": P("model", None), "proj_b": P(),
            "gamma": P(),
        }

    stages = []
    for si, depth in enumerate(cfg.depths):
        st: Dict[str, Any] = {}
        if si > 0:  # the keys in param_shapes' order (leaves_of's)
            st.update({"down_ln_scale": P(), "down_ln_bias": P(),
                       "down_w": P(), "down_b": P()})
        st["blocks"] = [block() for _ in range(depth)]
        stages.append(st)
    return {
        "stem_w": P(), "stem_b": P(),
        "stem_ln_scale": P(), "stem_ln_bias": P(),
        "stages": stages,
        "ln_f_scale": P(), "ln_f_bias": P(),
        "head_w": P(), "head_b": P(),
    }


def shard(mesh, params: Dict[str, Any], cfg: CNNConfig) -> Dict[str, Any]:
    """This rank's shards of the tree for ``forward(..., sharded=True)``."""
    return layout(mesh, cfg).shard(params)


def param_shapes(cfg: CNNConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the tree's layout."""
    c0, k = cfg.widths[0], cfg.kernel
    stem_dim = cfg.stem_patch * cfg.stem_patch * 3
    stages = []
    for si, depth in enumerate(cfg.depths):
        c, e = cfg.widths[si], cfg.widths[si] * cfg.expand
        st: Dict[str, Any] = {}
        if si > 0:
            cin = cfg.widths[si - 1]
            st.update({"down_ln_scale": (cin,), "down_ln_bias": (cin,),
                       "down_w": (4 * cin, c), "down_b": (c,)})
        st["blocks"] = [{"dw_w": (k, k, 1, c), "dw_b": (c,),
                         "ln_scale": (c,), "ln_bias": (c,),
                         "exp_w": (c, e), "exp_b": (e,),
                         "proj_w": (e, c), "proj_b": (c,),
                         "gamma": (c,)} for _ in range(depth)]
        stages.append(st)
    return {"stem_w": (stem_dim, c0), "stem_b": (c0,),
            "stem_ln_scale": (c0,), "stem_ln_bias": (c0,),
            "stages": stages,
            "ln_f_scale": (cfg.widths[-1],), "ln_f_bias": (cfg.widths[-1],),
            "head_w": (cfg.widths[-1], cfg.n_classes),
            "head_b": (cfg.n_classes,)}


def init_params(seed: int, cfg: CNNConfig) -> Dict[str, Any]:
    """Seeded f32 parameter tree on the CPU: dense weights N(0, 1/fan_in),
    depthwise kernels N(0, 1/k²), LayerNorm scales 1, layer scales 1e-2,
    every bias 0.  The same distributions as the JAX initialiser, not its
    random stream."""
    gen = torch.Generator().manual_seed(seed)

    def make(name, shape):
        if name.endswith("_scale"):
            return torch.ones(shape)
        if name == "gamma":
            return torch.full(shape, 1e-2)
        if name == "dw_w":
            return torch.randn(shape, generator=gen) / cfg.kernel
        if name.endswith("_w"):
            return torch.randn(shape, generator=gen) / math.sqrt(shape[0])
        return torch.zeros(shape)

    return _map_tree(make, param_shapes(cfg))


def cast_for_inference(params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The tree on ``device`` (default CUDA) with the bf16 operands already
    rounded, so a forward pass casts nothing; results are equal."""
    dev = device_mod.resolve(device)
    return _map_tree(
        lambda name, x: x.to(dev, torch.bfloat16 if name in _BF16
                             else torch.float32), params)


def _patch_merge(x: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] → [B, H/p, W/p, p·p·C], a patch laid out as (row,
    column, channel): the stem and downsample convolutions become
    matmuls on this layout."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // patch, w // patch, patch * patch * c)


def _dwconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
            ) -> torch.Tensor:
    """SAME-padded depthwise k×k over NHWC in ``x``'s dtype; ``w`` is the
    HWIO kernel ``[k, k, 1, C]``, the bias added after the convolution."""
    c, k = x.shape[-1], w.shape[0]
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype).permute(3, 2, 0, 1),
                 padding=k // 2, groups=c)
    return y.permute(0, 2, 3, 1) + b.to(x.dtype)


def forward(params: Dict[str, Any], frames: torch.Tensor,
            cfg: CNNConfig, sharded: bool = False, mesh=None) -> torch.Tensor:
    """[B, H, W, 3] float in [0,1] → [B, n_classes] f32 logits, on the
    device the frames and parameters lie on.

    ``sharded`` runs this rank's share over ``mesh`` (dims ``data`` and
    ``model``): ``params`` are its shards (``shard``), ``frames`` the whole
    batch (any device, divisible by ``data``); every rank returns every
    logit."""
    if not sharded:
        return _forward(params, frames, cfg)
    detector._check_mesh(mesh)
    frames = mesh_mod.batch_slice(mesh, frames, "data").to(
        params["stem_w"].device)
    return col.all_gather(_forward(params, frames, cfg, mesh), mesh,
                          "data", dim=0)


def _block(x, blk, mesh=None, specs=None):
    """One ConvNeXt block; over ``mesh`` the MLP is this rank's share
    (its input entering the region, one ``psum`` out, as
    ``detector.block_forward_tp``), and with ``specs`` the block's FSDP
    slices are all-gathered over ``data`` first."""
    if specs is not None:
        blk = zero.gather_leaves(blk, specs, mesh)
    h = _dwconv(x, blk["dw_w"], blk["dw_b"])
    h = _bf16(_ln(h.float(), blk["ln_scale"], blk["ln_bias"]))
    if mesh is not None:
        h = col.enter(h, mesh, "model")
    h = h @ _bf16(blk["exp_w"]) + _bf16(blk["exp_b"])
    h = F.gelu(h, approximate="tanh")
    if mesh is not None:  # the row-sharded project's Megatron psum
        h = _bf16(col.psum(detector._partial(h, blk["proj_w"]),
                           mesh, "model")) + _bf16(blk["proj_b"])
    else:
        h = h @ _bf16(blk["proj_w"]) + _bf16(blk["proj_b"])
    return x + _bf16(blk["gamma"]) * h


def _forward(params: Dict[str, Any], frames: torch.Tensor, cfg: CNNConfig,
             mesh=None, fsdp_specs=None) -> torch.Tensor:
    """The forward on one device, or this rank's share over ``mesh`` on its
    own ``data`` slice of the frames (``fsdp_specs``: ``params`` hold FSDP
    slices, gathered a block at a time and again when the backward pass
    recomputes the block)."""
    top = {k: v for k, v in params.items() if k != "stages"}
    if fsdp_specs is not None:
        top = zero.gather_leaves(top, {k: fsdp_specs[k] for k in top}, mesh)
    x = _patch_merge(_bf16(frames), cfg.stem_patch)
    x = x @ _bf16(top["stem_w"]) + _bf16(top["stem_b"])
    x = _bf16(_ln(x.float(), top["stem_ln_scale"],
                  top["stem_ln_bias"]))
    for si, st in enumerate(params["stages"]):
        sspec = None if fsdp_specs is None else fsdp_specs["stages"][si]
        if si > 0:
            down = {k: v for k, v in st.items() if k != "blocks"}
            if sspec is not None:
                down = zero.gather_leaves(down, {k: sspec[k] for k in down},
                                          mesh)
            x = _bf16(_ln(x.float(), down["down_ln_scale"],
                          down["down_ln_bias"]))
            x = _patch_merge(x, 2)
            x = x @ _bf16(down["down_w"]) + _bf16(down["down_b"])
        for bi, blk in enumerate(st["blocks"]):
            if sspec is not None and torch.is_grad_enabled():
                x = torch_checkpoint.checkpoint(
                    _block, x, blk, mesh, sspec["blocks"][bi],
                    use_reentrant=False)
            else:
                x = _block(x, blk, mesh,
                           None if sspec is None else sspec["blocks"][bi])
    # global average pool (f32) → final LN → head
    g = x.float().mean(dim=(1, 2))
    g = _ln(g, top["ln_f_scale"].float(), top["ln_f_bias"].float())
    return g @ top["head_w"].float() + top["head_b"].float()


def layout(mesh, cfg: CNNConfig, fsdp: bool = False) -> zero.Layout:
    """Where the sharded forward's and step's tree lives on a rank: each
    leaf cut by ``param_specs``, with ``fsdp`` also over ``data``."""
    specs = param_specs(cfg)
    if fsdp:
        specs = zero.fsdp_param_specs(param_shapes(cfg), specs,
                                      col.axis_size(mesh, "data"))
    return zero.Layout(mesh, specs)


def loss_fn(params, frames, labels, cfg: CNNConfig,
            logit_l2: float = 0.0, mesh=None, fsdp_specs=None
            ) -> torch.Tensor:
    """Sigmoid BCE in f32 (labels [B] in {0, 1}) plus the optional
    logit-scale regulariser (``detector._logit_l2``); with ``mesh``, this
    rank's share on its ``data`` slice (``detector.loss_fn``)."""
    z = _forward(params, frames, cfg, mesh, fsdp_specs)[:, 0]
    loss = detector._bce(z, labels)
    if logit_l2:
        loss = loss + detector._logit_l2(z, logit_l2)
    return loss


def make_train_step(cfg: CNNConfig, optimizer, logit_l2: float = 0.0,
                    sharded: bool = False, mesh=None, zero_mode=None):
    """(params, opt_state, frames, labels) → (params, opt_state, loss): the
    shared optimizer step over this family's loss (over a rank group with
    ``sharded``, as ``detector.make_train_step``)."""
    specs = layout(mesh, cfg, zero_mode == "fsdp").specs if sharded \
        else None
    return detector.make_train_step(cfg, optimizer, loss=loss_fn,
                                    logit_l2=logit_l2, sharded=sharded,
                                    mesh=mesh, zero_mode=zero_mode,
                                    specs=specs)


make_optimizer = detector.make_optimizer
