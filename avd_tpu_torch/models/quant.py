"""Int8 post-training quantization of the ViT and CNN detectors (W8A8).

Port of ``avd_tpu/models/quant.py``:

* weights: symmetric per-output-channel int8, ``scale = max|w| / 127`` per
  column, quantized once from the f32 weights (``quantize_weight``);
* activations: dynamic symmetric per-token int8, the scale taken from
  each row's largest magnitude inside the forward;
* products: int8 × int8 → int32, dequantized in f32 as ``acc · s_x ·
  scale`` with the bias added in f32 (``qdense``).

LayerNorm, softmax, GELU, the attention einsums, the CNN's depthwise
convolution and the head stay f32 or bf16, as in ``avd_tpu``.  On a CUDA
tensor the int8 product is ``torch._int_mm`` (cuBLASLt's int8 GEMM; no
TPU kernel stands behind it, so a library call is the port): it takes more
than 16 rows, so shorter inputs are padded with zero rows, and inner and
output widths that are multiples of 8, which every preset has; any other
shape raises and never falls back to a float product.  On the CPU the
product is an exact int32 matmul.  Mixture-of-experts trees are rejected,
as ``avd_tpu`` rejects them.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from avd_tpu_torch.models.detector import _ln, _map_tree, patchify

# weight leaves that become int8 {w_i8, scale}; everything else stays f32
_VIT_LAYER_KEYS = ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w")
_CNN_BLOCK_KEYS = ("exp_w", "proj_w")

INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows
INT_MM_MULTIPLE = 8   # ... and inner and output widths in multiples of 8


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """``max(amax / 127, 1e-12)`` by true division on every device: CUDA
    divides by a Python number as a product with its reciprocal, one ulp
    off ``avd_tpu``'s scale, so the divisor is a tensor on the device."""
    return torch.clamp(amax / amax.new_full((), 127.0), min=1e-12)


def quantize_weight(w: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[d_in, d_out] f32 → symmetric per-output-channel int8 with
    ``w ≈ w_i8 · scale[None, :]`` and ``|w_i8| ≤ 127``."""
    w = w.float()
    scale = _scale(w.abs().amax(dim=0))
    return {"w_i8": torch.round(w / scale).to(torch.int8), "scale": scale}


def int_matmul(x_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 × [K, N] int8 → [M, N] int32, exact.  CUDA:
    ``torch._int_mm``, the rows padded to its minimum; CPU: an int32
    matmul."""
    if x_i8.device.type != "cuda":
        return x_i8.to(torch.int32) @ w_i8.to(torch.int32)
    m, k = x_i8.shape
    n = w_i8.shape[1]
    if k % INT_MM_MULTIPLE or n % INT_MM_MULTIPLE:
        raise ValueError(
            f"the int8 product [{m},{k}]x[{k},{n}] needs inner and output "
            f"widths that are multiples of {INT_MM_MULTIPLE} on CUDA "
            "(torch._int_mm)")
    if m < INT_MM_MIN_ROWS:
        x_i8 = F.pad(x_i8, (0, 0, 0, INT_MM_MIN_ROWS - m))
    return torch._int_mm(x_i8.contiguous(), w_i8.contiguous())[:m]


def qdense(x: torch.Tensor, qw: Dict[str, torch.Tensor],
           b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Int8 dense: dynamic per-token activation quant, the int8 product,
    f32 dequant (+ f32 bias).  ``x``: [..., d_in] float."""
    xf = x.float()
    s_x = _scale(xf.abs().amax(dim=-1, keepdim=True))
    x_i8 = torch.round(xf / s_x).to(torch.int8)
    lead = x_i8.shape[:-1]
    acc = int_matmul(x_i8.reshape(-1, x_i8.shape[-1]), qw["w_i8"])
    y = acc.reshape(lead + (acc.shape[-1],)).float() * s_x * qw["scale"]
    return y if b is None else y + b.float()


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """f32 parameter tree → mixed int8/f32 tree for ``forward``; the family
    is read from the tree (``layers``: ViT, ``stages``: CNN)."""
    if "layers" in params:
        if any("router_w" in lp for lp in params["layers"]):
            raise ValueError("int8 PTQ supports dense configs only; "
                             "MoE (n_experts>0) runs in bf16")
        qp: Dict[str, Any] = {k: v for k, v in params.items()
                              if k not in ("patch_w", "layers")}
        qp["patch_w"] = quantize_weight(params["patch_w"])
        qp["layers"] = [
            {k: quantize_weight(v) if k in _VIT_LAYER_KEYS else v
             for k, v in lp.items()} for lp in params["layers"]]
        return qp
    if "stages" in params:
        qp = {k: v for k, v in params.items()
              if k not in ("stem_w", "stages")}
        qp["stem_w"] = quantize_weight(params["stem_w"])
        qp["stages"] = []
        for st in params["stages"]:
            qst = {k: quantize_weight(v) if k == "down_w" else v
                   for k, v in st.items() if k != "blocks"}
            qst["blocks"] = [
                {k: quantize_weight(v) if k in _CNN_BLOCK_KEYS else v
                 for k, v in blk.items()} for blk in st["blocks"]]
            qp["stages"].append(qst)
        return qp
    raise ValueError("unrecognized parameter tree (expected a ViT "
                     "'layers' or CNN 'stages' pytree)")


def to_device(qparams: Dict[str, Any], device) -> Dict[str, Any]:
    """The quantized tree on ``device``: int8 stays int8, the rest f32."""
    return _map_tree(lambda _, x: x.to(device, x.dtype if x.dtype ==
                                       torch.int8 else torch.float32),
                     qparams)


def _vit_forward(qp: Dict[str, Any], frames: torch.Tensor,
                 cfg) -> torch.Tensor:
    """The ViT block's arithmetic with every weight product on the int8
    path and the residual stream in f32."""
    x = qdense(patchify(frames.float(), cfg.patch), qp["patch_w"],
               qp["patch_b"])
    cls = qp["cls_tok"].float().expand(x.shape[0], 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + qp["pos_emb"].float()[None]
    scale = math.sqrt(cfg.head_dim)
    for lp in qp["layers"]:
        h = _ln(x, lp["ln1_scale"], lp["ln1_bias"])
        qkv = qdense(h, lp["qkv_w"], lp["qkv_b"])
        b, t, _ = qkv.shape
        qkv = qkv.reshape(b, t, 3, cfg.heads, cfg.head_dim).bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        # f32 scores of the bf16 values, P rounded to bf16, f32 sums
        att = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
        att = torch.softmax(att / scale, dim=-1)
        o = torch.einsum("bhts,bshd->bthd", att.bfloat16().float(),
                         v.float())
        x = x + qdense(o.reshape(b, t, cfg.width), lp["proj_w"],
                       lp["proj_b"])
        h = _ln(x, lp["ln2_scale"], lp["ln2_bias"])
        h = F.gelu(qdense(h, lp["mlp_in_w"], lp["mlp_in_b"]),
                   approximate="tanh")
        x = x + qdense(h, lp["mlp_out_w"], lp["mlp_out_b"])
    x = _ln(x, qp["ln_f_scale"], qp["ln_f_bias"])
    return x[:, 0] @ qp["head_w"] + qp["head_b"]


def _cnn_forward(qp: Dict[str, Any], frames: torch.Tensor,
                 cfg) -> torch.Tensor:
    """The CNN forward with the merges, expands and projects on the int8
    path; the depthwise convolution stays bf16."""
    from avd_tpu_torch.models.cnn import _dwconv, _patch_merge
    x = qdense(_patch_merge(frames.float(), cfg.stem_patch), qp["stem_w"],
               qp["stem_b"])
    x = _ln(x, qp["stem_ln_scale"], qp["stem_ln_bias"])
    for si, st in enumerate(qp["stages"]):
        if si > 0:
            x = _ln(x, st["down_ln_scale"], st["down_ln_bias"])
            x = qdense(_patch_merge(x, 2), st["down_w"], st["down_b"])
        for blk in st["blocks"]:
            h = _dwconv(x.bfloat16(), blk["dw_w"], blk["dw_b"])
            h = _ln(h.float(), blk["ln_scale"], blk["ln_bias"])
            h = F.gelu(qdense(h, blk["exp_w"], blk["exp_b"]),
                       approximate="tanh")
            h = qdense(h, blk["proj_w"], blk["proj_b"])
            x = x + blk["gamma"].float() * h
    g = _ln(x.mean(dim=(1, 2)), qp["ln_f_scale"], qp["ln_f_bias"])
    return g @ qp["head_w"] + qp["head_b"]


def forward(qparams: Dict[str, Any], frames: torch.Tensor,
            cfg) -> torch.Tensor:
    """[B, H, W, 3] float in [0,1] → [B, n_classes] f32 logits on the int8
    path; the family is read from the quantized tree."""
    if "layers" in qparams:
        return _vit_forward(qparams, frames, cfg)
    return _cnn_forward(qparams, frames, cfg)
