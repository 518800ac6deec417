"""Temporal detector family — per-frame scores with temporal context.

Port of ``avd_tpu/models/temporal.py`` on one device: each frame is
encoded on its own (patchify, project, ``frame_depth`` spatial transformer
blocks over its patch tokens, an f32 mean-pool, project), a sinusoidal
encoding of the frame's index in the clip is added, and ``depth``
transformer blocks attend over the frames, so each frame's score sees its
neighbours:

    [B, T, H, W, 3] → [B, T, width] → temporal blocks → [B, T, n_classes]

The parameter dict has the JAX package's keys and ``[in, out]`` weight
layout, so a converted checkpoint drops in (``models/convert.py``).
Numerics follow the JAX forward: a bf16 stream and bf16 products, each
bias added after its product (and, in the block, after the residual sum,
as ``x + o @ w + b`` groups in ``avd_tpu``); LayerNorm, the mean-pool,
attention, the heads in f32.  The attention core is
``parallel/attention.full_attention`` (or ``masked_attention``, which
keeps padded frames out of every softmax): plain torch ops, since
``avd_tpu`` computes them in XLA with no Pallas kernel behind them.
Training supervises every frame, and the frame embedding directly through
the per-frame head (``aux_frame_loss``); ``synthetic_sequences`` splices
the per-frame curriculum into clips.  The time-sharded forward (ring /
Ulysses attention) belongs to the parallelism slice (``ROADMAP.md``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.models import detector
from avd_tpu_torch.models.detector import _bf16, _ln, _map_tree, patchify
from avd_tpu_torch.parallel import attention as pattn


@dataclasses.dataclass(frozen=True)
class TemporalConfig:
    image_size: int = 64
    patch: int = 16
    width: int = 256          # temporal stream width
    depth: int = 4            # temporal blocks (attention over frames)
    frame_depth: int = 4      # spatial blocks per frame (over patches)
    heads: int = 4
    mlp_ratio: int = 4
    n_classes: int = 1        # per-frame binary: AI-generated?
    # weight of the per-frame head's BCE in training: it supervises the
    # spatial trunk before any cross-frame attention, so the trunk carries
    # the smooth-vs-noisy cue itself (avd_tpu/models/temporal.py:75-88);
    # serving ignores the head
    aux_frame_loss: float = 0.5

    @property
    def head_dim(self) -> int:
        return self.width // self.heads

    @property
    def mlp_width(self) -> int:
        return self.width * self.mlp_ratio


Config = TemporalConfig

PRESETS = {
    "small": {},  # the defaults above; ships trained
    "full": dict(image_size=224, width=384, depth=6, heads=6),
}

_BLOCK_BF16 = ("qkv_w", "qkv_b", "proj_w", "proj_b", "mlp_in_w",
               "mlp_in_b", "mlp_out_w", "mlp_out_b")
# bf16 operands of the forward pass; LayerNorms and both heads stay f32
_BF16 = ("frame_w", "frame_b", "in_w", "in_b") + _BLOCK_BF16


def make_config(preset: str = "small", **over) -> TemporalConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown temporal preset {preset!r}; "
                         f"choose from {sorted(PRESETS)}")
    kw = dict(PRESETS[preset])
    kw.update(over)
    return TemporalConfig(**kw)


def stored_bf16(cfg: TemporalConfig):
    """The leaves every served mode reads in bf16, which a checkpoint may
    store as bf16: all the bf16 operands (no int8 mode serves this
    family)."""
    return _BF16


def _block_shapes(d: int, m: int) -> Dict[str, Any]:
    return {"ln1_scale": (d,), "ln1_bias": (d,),
            "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
            "proj_w": (d, d), "proj_b": (d,),
            "ln2_scale": (d,), "ln2_bias": (d,),
            "mlp_in_w": (d, m), "mlp_in_b": (m,),
            "mlp_out_w": (m, d), "mlp_out_b": (d,)}


def param_shapes(cfg: TemporalConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the tree's layout."""
    d, m = cfg.width, cfg.mlp_width
    return {"frame_w": (cfg.patch * cfg.patch * 3, d), "frame_b": (d,),
            "frame_layers": [_block_shapes(d, m)
                             for _ in range(cfg.frame_depth)],
            "in_w": (d, d), "in_b": (d,),
            "layers": [_block_shapes(d, m) for _ in range(cfg.depth)],
            "ln_f_scale": (d,), "ln_f_bias": (d,),
            "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,),
            "aux_w": (d, cfg.n_classes), "aux_b": (cfg.n_classes,)}


def check_template(tree: Dict[str, Any], cfg: TemporalConfig, what: str
                   ) -> None:
    """Raise the one-line error of ``avd_tpu``'s loader
    (``avd_tpu/models/temporal.py:187-218``) for a tree of the template
    before the per-frame head landed: no ``aux_w``/``aux_b``, or two frame
    layers where the config has more."""
    legacy = not ("aux_w" in tree and "aux_b" in tree) or (
        len(tree.get("frame_layers", ())) == 2 and cfg.frame_depth > 2)
    if legacy:
        raise ValueError(
            f"{what} holds a pre-round-4 temporal checkpoint (template v1: "
            "frame_depth 2, no aux per-frame head). The round-4 transfer "
            "fix changed the template (frame_depth 4 + aux_w/aux_b); "
            "retrain it with `python -m avd_tpu.models.train --arch "
            "temporal` and convert it with tools/torch_convert_weights.py.")


def init_params(seed: int, cfg: TemporalConfig) -> Dict[str, Any]:
    """Seeded f32 parameter tree on the CPU: weights N(0, 1/fan_in),
    LayerNorm scales 1, every bias 0.  The same distributions as the JAX
    initialiser, not its random stream."""
    gen = torch.Generator().manual_seed(seed)

    def make(name, shape):
        if name.endswith("_scale"):
            return torch.ones(shape)
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


def _time_encoding(t0: int, n: int, d: int,
                   device=None) -> torch.Tensor:
    """Sinusoidal encoding of the clip's frame indices [t0, t0+n) →
    [n, d] f32: sin of the index over 10000^(2i/d) in the first half, cos
    in the second."""
    pos = (t0 + torch.arange(n, device=device)).float()[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def masked_attention(mask: torch.Tensor):
    """``full_attention`` with the invalid KEY positions (``mask`` [B, T]
    bool, True = a real frame) set to -1e30 before the softmax: padded
    frames move no real frame's score."""
    def attn(q, k, v):
        scale = 1.0 / math.sqrt(q.shape[-1])
        s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
        s = s.masked_fill(~mask[:, None, None, :], -1e30)
        p = torch.softmax(s, dim=-1)
        return torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)
    return attn


def _block(x: torch.Tensor, lp: Dict[str, Any], cfg: TemporalConfig,
           attn_fn) -> torch.Tensor:
    """Pre-LN transformer block on the [B, T, d] bf16 stream; the
    attention core takes and returns [B, H, T, D]."""
    h = _bf16(_ln(x.float(), lp["ln1_scale"], lp["ln1_bias"]))
    qkv = h @ _bf16(lp["qkv_w"]) + _bf16(lp["qkv_b"])
    b, t, _ = qkv.shape
    qkv = qkv.reshape(b, t, 3, cfg.heads, cfg.head_dim)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    o = attn_fn(q, k, v)
    o = _bf16(o.transpose(1, 2).reshape(b, t, cfg.width))
    x = x + o @ _bf16(lp["proj_w"]) + _bf16(lp["proj_b"])

    h = _bf16(_ln(x.float(), lp["ln2_scale"], lp["ln2_bias"]))
    h = F.gelu(h @ _bf16(lp["mlp_in_w"]) + _bf16(lp["mlp_in_b"]),
               approximate="tanh")
    return x + h @ _bf16(lp["mlp_out_w"]) + _bf16(lp["mlp_out_b"])


def _encode_frames(params: Dict[str, Any], frames: torch.Tensor,
                   cfg: TemporalConfig) -> torch.Tensor:
    """[B, T, H, W, 3] → [B, T, width] bf16: patchify each frame,
    project, ``frame_depth`` spatial blocks over its patch tokens, f32
    mean-pool, project."""
    b, t = frames.shape[:2]
    x = _bf16(frames.reshape((b * t,) + tuple(frames.shape[2:])))
    toks = patchify(x, cfg.patch) @ _bf16(params["frame_w"]) \
        + _bf16(params["frame_b"])
    for lp in params["frame_layers"]:
        toks = _block(toks, lp, cfg, pattn.full_attention)
    emb = toks.float().mean(dim=1)
    emb = _bf16(emb) @ _bf16(params["in_w"]) + _bf16(params["in_b"])
    return emb.reshape(b, t, cfg.width)


def _head(params: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    x = _ln(x.float(), params["ln_f_scale"].float(),
            params["ln_f_bias"].float())
    return x @ params["head_w"].float() + params["head_b"].float()


def forward(params: Dict[str, Any], frames: torch.Tensor,
            cfg: TemporalConfig, t0: int = 0,
            mask: Optional[torch.Tensor] = None, return_aux: bool = False):
    """[B, T, H, W, 3] float in [0,1] → [B, T, n_classes] f32 logits, one
    per frame, attention over the whole sequence.  ``mask`` ([B, T] bool,
    True = a real frame) keeps padded frames out of every temporal
    softmax; ``return_aux`` also returns the per-frame head's logits, read
    off the frame embedding before any cross-frame attention."""
    x = _encode_frames(params, frames, cfg)
    aux = x.float() @ params["aux_w"].float() + params["aux_b"].float()
    x = x + _bf16(_time_encoding(t0, x.shape[1], cfg.width,
                                 device=x.device))[None]
    attn = pattn.full_attention if mask is None else masked_attention(mask)
    for lp in params["layers"]:
        x = _block(x, lp, cfg, attn)
    out = _head(params, x)
    return (out, aux) if return_aux else out


def forward_clip(params: Dict[str, Any], frames: torch.Tensor,
                 cfg: TemporalConfig,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Serving form: the [N, H, W, 3] sampled frames of ONE clip → [N,
    n_classes] logits (the batch axis is time here); ``mask`` [N] bool."""
    return forward(params, frames[None], cfg,
                   mask=None if mask is None else mask[None])[0]


def loss_fn(params, frames, labels, cfg: TemporalConfig,
            logit_l2: float = 0.0) -> torch.Tensor:
    """Per-frame sigmoid BCE (labels [B, T] in {0, 1}), the optional
    logit-scale regulariser, and ``aux_frame_loss`` times the same two
    terms on the per-frame head."""
    out, aux = forward(params, frames, cfg, return_aux=True)
    z = out[..., 0].reshape(-1)
    y = labels.reshape(-1)
    loss = detector._bce(z, y)
    if logit_l2:
        loss = loss + detector._logit_l2(z, logit_l2)
    if cfg.aux_frame_loss:
        za = aux[..., 0].reshape(-1)
        loss = loss + cfg.aux_frame_loss * detector._bce(za, y)
        if logit_l2:
            loss = loss + cfg.aux_frame_loss * detector._logit_l2(za,
                                                                  logit_l2)
    return loss


def make_train_step(cfg: TemporalConfig, optimizer, logit_l2: float = 0.0):
    """The shared optimizer step over this family's loss."""
    return detector.make_train_step(cfg, optimizer, loss=loss_fn,
                                    logit_l2=logit_l2)


make_optimizer = detector.make_optimizer


def synthetic_sequences(rng: np.random.Generator, batch: int, t: int,
                        size: int, families=("blobs",)):
    """Procedural spliced sequences → (frames [batch, t, size, size, 3]
    f32, per-frame labels [batch, t] int32): camera-like frames with a
    random contiguous AI-like span, or none, or all, drawn from pools of
    the per-frame curriculum (``train.synthetic_batch``); the same numpy
    draws as ``avd_tpu``'s, so the same seed gives the same clips."""
    from avd_tpu_torch.models.train import synthetic_batch

    frames = np.empty((batch, t, size, size, 3), np.float32)
    labels = np.zeros((batch, t), np.int32)
    need = max(8, (batch * t * 3) // 5)
    pool_f, pool_l = synthetic_batch(rng, 2 * need, size, families)
    ai_pool = pool_f[pool_l == 1]
    cam_pool = pool_f[pool_l == 0]
    while len(ai_pool) < need or len(cam_pool) < need:
        short = need - min(len(ai_pool), len(cam_pool))
        f2, l2 = synthetic_batch(rng, max(32, 2 * short), size, families)
        ai_pool = np.concatenate([ai_pool, f2[l2 == 1]])
        cam_pool = np.concatenate([cam_pool, f2[l2 == 0]])
    ai_i = cam_i = 0
    for b in range(batch):
        kind = rng.random()
        if kind < 0.25:          # all camera
            s0, s1 = 0, 0
        elif kind < 0.5:         # all AI
            s0, s1 = 0, t
        else:                    # spliced span
            s0 = int(rng.integers(0, t))
            s1 = int(rng.integers(s0 + 1, t + 1))
        for i in range(t):
            if s0 <= i < s1:
                frames[b, i] = ai_pool[ai_i % len(ai_pool)]
                ai_i += 1
                labels[b, i] = 1
            else:
                frames[b, i] = cam_pool[cam_i % len(cam_pool)]
                cam_i += 1
    return frames, labels
