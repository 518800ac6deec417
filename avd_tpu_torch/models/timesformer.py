"""TimeSformer clip detector — divided space-time attention over windows.

The architecture of Bertasius, Wang and Torresani, "Is Space-Time
Attention All You Need for Video Understanding?" (ICML 2021,
arXiv:2102.05095), as Hugging Face's ``TimesformerModel`` computes it with
``attention_type="divided_space_time"``; preset ``hr`` has the sizes of
``facebook/timesformer-hr-finetuned-k400`` (448², patch 16, 16 frames,
width 768, 12 heads, depth 12, MLP 3072) with one logit.

A window is ``frames`` = T sampled frames of N = (S/patch)² patches.  The
stream is ``[c; X]``: one class token and the T·N patch tokens, ordered
patch-major and frame-minor (token n·T + t), as the published model lays
them out.  Each frame's patches are projected (the conv as a product),
the class token is prepended and the positions [N+1, D] added per frame,
then the time embedding [T, D] is added by frame; c is the class token
plus position 0.  Each block:

1. temporal: for every patch n, X_n ∈ R^{T×D}:
   X' = X + temporal_dense(MHSA_t(LN_t(X_n)));
2. spatial: for every frame t, S_t = [c; X'_{·,t}] ∈ R^{(N+1)×D},
   B_t = MHSA_s(LN_1(S_t)); c' = c + mean_t B_t[0], X'' = X' + B_t[1:];
3. MLP: y = [c'; X'']; y + W_2 GELU(W_1 LN_2(y) + b_1) + b_2.

Then the final LayerNorm, and the head reads the class token: one logit a
window.  MHSA is ``qkv`` then the heads' softmax attention then the output
projection (HF's ``attention.qkv`` and ``output.dense``).  The parameter
dict holds one ``[in, out]`` product per HF module (keys in
``param_shapes``), the ViT's names where the module is the ViT block's.

Numerics follow the ViT block's (``models/detector.py``): a bf16 stream and
bf16 products, each bias added after its product; f32 LayerNorm (eps 1e-6);
both attentions through the hand-written kernel
``ops/kernels/attention.attention`` (f32 scores and exact softmax, P
rounded to bf16 after its normalisation, f32 P·V; the function of the
ViT's ``detector.attention_core``), which takes the spatial attention's
N + 1 tokens (785 at ``hr``) on its ``"tiled"`` variant and the temporal
attention's T on ``"mma"``, and the plain version on the CPU; the exact
(erf) GELU, as published; the class token's mean over frames in f32,
rounded once; the final LayerNorm and the head in f32.  The input is
normalised on the device by ``MEAN`` and ``STD`` (the Kinetics
statistics of the published image processor).

Each (n, t) ↔ (t, n) re-layout is a view or one copy: the temporal branch
reads the patch tokens as a [W, N, T, D] view of the stream, the spatial
branch's input is one concatenation of the class token and the permuted
patches, and its result is added back through a permuted view into the
next stream.  ``models/scoring.py`` serves the family in 16-frame windows.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.models.detector import _bf16, _ln, _map_tree, patchify
from avd_tpu_torch.ops.kernels import attention as attention_k

# the Kinetics statistics of the published image processor, per RGB channel
MEAN = (0.45, 0.45, 0.45)
STD = (0.225, 0.225, 0.225)


@dataclasses.dataclass(frozen=True)
class TimesformerConfig:
    image_size: int = 448
    patch: int = 16
    frames: int = 16          # T, the frames of one window
    width: int = 768
    depth: int = 12
    heads: int = 12
    mlp_width: int = 3072
    n_classes: int = 1        # one logit a window (published: 400 labels)
    # the most windows one forward takes: a clip's windows go through in
    # forwards of 1, 2, 4 … max_windows (models/scoring.py); at ``hr`` the
    # largest power of two at which four clients' concurrent forwards keep
    # an H100's peak memory under 60 GB
    max_windows: int = 8

    @property
    def patches(self) -> int:
        return (self.image_size // self.patch) ** 2

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


Config = TimesformerConfig

PRESETS = {
    "hr": {},  # the dataclass defaults: facebook/timesformer-hr-finetuned-k400
    # the CPU tests' size
    "tiny": dict(image_size=32, patch=16, frames=4, width=64, depth=2,
                 heads=4, mlp_width=256, max_windows=2),
}

_LAYER_BF16 = ("temporal_qkv_w", "temporal_qkv_b", "temporal_proj_w",
               "temporal_proj_b", "temporal_dense_w", "temporal_dense_b",
               "qkv_w", "qkv_b", "proj_w", "proj_b", "mlp_in_w", "mlp_in_b",
               "mlp_out_w", "mlp_out_b")
# bf16 operands of the forward pass; LayerNorms and the head stay f32
_BF16 = ("patch_w", "patch_b", "cls_tok", "pos_emb", "time_emb") + _LAYER_BF16


def make_config(preset: str = "hr", **over) -> TimesformerConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown timesformer preset {preset!r}; "
                         f"choose from {sorted(PRESETS)}")
    kw = dict(PRESETS[preset])
    kw.update(over)
    return TimesformerConfig(**kw)


def stored_bf16(cfg: TimesformerConfig):
    """The leaves every served mode reads in bf16, which a checkpoint may
    store as bf16: all the bf16 operands (no int8 mode serves this
    family)."""
    return _BF16


def param_shapes(cfg: TimesformerConfig) -> Dict[str, Any]:
    """Shape of every parameter, in the tree's layout: per layer the HF
    modules ``temporal_layernorm``, ``temporal_attention`` (qkv, output),
    ``temporal_dense``, ``layernorm_before``, ``attention`` (qkv, output),
    ``layernorm_after``, ``intermediate`` and ``output``."""
    d, m = cfg.width, cfg.mlp_width
    layer = {"temporal_ln_scale": (d,), "temporal_ln_bias": (d,),
             "temporal_qkv_w": (d, 3 * d), "temporal_qkv_b": (3 * d,),
             "temporal_proj_w": (d, d), "temporal_proj_b": (d,),
             "temporal_dense_w": (d, d), "temporal_dense_b": (d,),
             "ln1_scale": (d,), "ln1_bias": (d,),
             "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
             "proj_w": (d, d), "proj_b": (d,),
             "ln2_scale": (d,), "ln2_bias": (d,),
             "mlp_in_w": (d, m), "mlp_in_b": (m,),
             "mlp_out_w": (m, d), "mlp_out_b": (d,)}
    return {"patch_w": (cfg.patch * cfg.patch * 3, d), "patch_b": (d,),
            "cls_tok": (d,), "pos_emb": (cfg.patches + 1, d),
            "time_emb": (cfg.frames, d),
            "layers": [dict(layer) for _ in range(cfg.depth)],
            "ln_f_scale": (d,), "ln_f_bias": (d,),
            "head_w": (d, cfg.n_classes), "head_b": (cfg.n_classes,)}


def init_params(seed: int, cfg: TimesformerConfig) -> Dict[str, Any]:
    """Seeded f32 parameter tree on the CPU: every weight and embedding
    N(0, 0.02²) (the published ``initializer_range``), LayerNorm scales 1,
    every bias 0."""
    gen = torch.Generator().manual_seed(seed)

    def make(name, shape):
        if name.endswith("_scale"):
            return torch.ones(shape)
        if name.endswith(("_w", "_tok", "_emb")):
            return torch.randn(shape, generator=gen) * 0.02
        return torch.zeros(shape)

    return _map_tree(make, param_shapes(cfg))


def cast_for_inference(params: Dict[str, Any], device=None) -> Dict[str, Any]:
    """The tree on ``device`` (default CUDA) with the bf16 operands already
    rounded, so a forward pass casts nothing; results are equal."""
    dev = device_mod.resolve(device)
    return _map_tree(
        lambda name, x: x.to(dev, torch.bfloat16 if name in _BF16
                             else torch.float32), params)


def embed(params: Dict[str, Any], clips: torch.Tensor,
          cfg: TimesformerConfig) -> torch.Tensor:
    """[W, T, S, S, 3] RGB in [0, 1] → the bf16 stream [W, 1 + N·T, D],
    the patch tokens patch-major (token 1 + n·T + t)."""
    w, t = clips.shape[:2]
    mean = clips.new_tensor(MEAN)
    std = clips.new_tensor(STD)
    x = _bf16((clips.float() - mean) / std)
    x = patchify(x.reshape(w * t, *x.shape[2:]), cfg.patch)  # [W·T, N, P]
    x = x @ _bf16(params["patch_w"]) + _bf16(params["patch_b"])
    pos = _bf16(params["pos_emb"])
    x = (x + pos[1:]).reshape(w, t, cfg.patches, cfg.width)
    x = x.transpose(1, 2) + _bf16(params["time_emb"])  # [W, N, T, D]
    c = _bf16(params["cls_tok"]) + pos[0]
    return torch.cat([c.expand(w, 1, cfg.width),
                      x.reshape(w, cfg.patches * t, cfg.width)], dim=1)


def _mhsa(h: torch.Tensor, qkv_w, qkv_b, proj_w, proj_b,
          cfg: TimesformerConfig) -> torch.Tensor:
    """Multi-head self-attention of the bf16 [B, L, D] sequences ``h``
    (already normalised) through its output projection."""
    b, n = h.shape[:2]
    qkv = (h @ qkv_w + qkv_b).reshape(b, n, 3, cfg.heads, cfg.head_dim)
    o = attention_k.attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
    return o @ proj_w + proj_b


def block_forward(x: torch.Tensor, lp: Dict[str, Any],
                  cfg: TimesformerConfig) -> torch.Tensor:
    """One divided space-time block on the bf16 stream [W, 1 + N·T, D]."""
    w, n, t, d = x.shape[0], cfg.patches, cfg.frames, cfg.width
    c, xs = x[:, 0], x[:, 1:].view(w, n, t, d)       # xs: (n, t) view

    # temporal: each patch's T tokens
    h = _bf16(_ln(xs.float(), lp["temporal_ln_scale"],
                  lp["temporal_ln_bias"])).reshape(w * n, t, d)
    a = _mhsa(h, _bf16(lp["temporal_qkv_w"]), _bf16(lp["temporal_qkv_b"]),
              _bf16(lp["temporal_proj_w"]), _bf16(lp["temporal_proj_b"]),
              cfg)
    a = a @ _bf16(lp["temporal_dense_w"]) + _bf16(lp["temporal_dense_b"])
    xt = xs + a.view(w, n, t, d)                      # X', (n, t)

    # spatial: each frame's class token and N patches, (t, n): one copy
    s = torch.cat([c[:, None, None].expand(w, t, 1, d),
                   xt.transpose(1, 2)], dim=2).reshape(w * t, n + 1, d)
    h = _bf16(_ln(s.float(), lp["ln1_scale"], lp["ln1_bias"]))
    bs = _mhsa(h, _bf16(lp["qkv_w"]), _bf16(lp["qkv_b"]),
               _bf16(lp["proj_w"]), _bf16(lp["proj_b"]),
               cfg).view(w, t, n + 1, d)
    y = torch.empty_like(x)
    y[:, 0] = c + _bf16(bs[:, :, 0].float().mean(dim=1))
    torch.add(xt, bs[:, :, 1:].transpose(1, 2),
              out=y[:, 1:].view(w, n, t, d))          # back to (n, t)

    # MLP over the whole stream
    h = _bf16(_ln(y.float(), lp["ln2_scale"], lp["ln2_bias"]))
    h = h @ _bf16(lp["mlp_in_w"]) + _bf16(lp["mlp_in_b"])
    h = F.gelu(h)
    return y + (h @ _bf16(lp["mlp_out_w"]) + _bf16(lp["mlp_out_b"]))


def forward(params: Dict[str, Any], clips: torch.Tensor,
            cfg: TimesformerConfig) -> torch.Tensor:
    """[W, T, S, S, 3] float RGB in [0, 1] (W windows of T frames) →
    [W, n_classes] f32 logits, one row a window, on the device the clips
    and parameters lie on."""
    x = embed(params, clips, cfg)
    for lp in params["layers"]:
        x = block_forward(x, lp, cfg)
    c = _ln(x[:, 0].float(), params["ln_f_scale"].float(),
            params["ln_f_bias"].float())
    return c @ params["head_w"].float() + params["head_b"].float()
