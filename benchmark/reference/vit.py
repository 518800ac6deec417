"""Plain PyTorch ViT detector, float32 end to end.

The architecture of the port's ``models/detector.py`` (dense ``full``
preset): 16×16 patches of the RGB frame in [0, 1], a class token and
learned positions, pre-LayerNorm blocks (eps 1e-6) of softmax attention
and a tanh-GELU MLP, the final LayerNorm's class token through one
linear head; probability = sigmoid(logit / temperature).  It reads the
checkpoint's raw ``params.npz`` (keys ``patch_w``, ``layers.<i>.qkv_w``,
…) and ``calibration.json`` itself, and imports nothing of the program.
With another ``dtype`` (bfloat16, float8_e4m3fn) every product's
operands and the residual stream are rounded to it on the way forward
(the gradient passes the rounding unchanged): the lower precisions that
the controls put in the program's place.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F


class _Round(torch.autograd.Function):
    """x rounded to ``dtype`` and back; the gradient passes unchanged."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def shapes(image_size: int, patch: int, width: int, heads: int, mlp: int,
           depth: int) -> Dict:
    """The parameter tree's shapes, in the checkpoint's key order."""
    d, t = width, (image_size // patch) ** 2 + 1
    layer = {"ln1_scale": (d,), "ln1_bias": (d,), "qkv_w": (d, 3 * d),
             "qkv_b": (3 * d,), "proj_w": (d, d), "proj_b": (d,),
             "ln2_scale": (d,), "ln2_bias": (d,), "mlp_in_w": (d, mlp),
             "mlp_in_b": (mlp,), "mlp_out_w": (mlp, d), "mlp_out_b": (d,)}
    return {"patch_w": (patch * patch * 3, d), "patch_b": (d,),
            "pos_emb": (t, d), "cls_tok": (d,),
            "layers": [dict(layer) for _ in range(depth)],
            "ln_f_scale": (d,), "ln_f_bias": (d,),
            "head_w": (d, 1), "head_b": (1,)}


def named(tree: Dict, prefix: str = ""):
    """(name, leaf) pairs in the tree's insertion order."""
    for k, v in tree.items():
        if k == "temperature":
            continue
        if isinstance(v, list):
            for i, lp in enumerate(v):
                yield from named(lp, f"{prefix}{k}.{i}.")
        else:
            yield f"{prefix}{k}", v


def load(ckpt_dir: str, device) -> Dict:
    """The parameter tree (float32 tensors on ``device``) and the
    temperature of a checkpoint directory."""
    z = np.load(os.path.join(ckpt_dir, "params.npz"))
    flat = {k: torch.from_numpy(np.asarray(z[k], np.float32)).to(device)
            for k in z.files}
    depth = 1 + max(int(k.split(".")[1]) for k in flat
                    if k.startswith("layers."))
    tree = {k: v for k, v in flat.items() if not k.startswith("layers.")}
    tree["layers"] = [{k.split(".", 2)[2]: v for k, v in flat.items()
                       if k.startswith(f"layers.{i}.")} for i in range(depth)]
    temp = 1.0
    cal = os.path.join(ckpt_dir, "calibration.json")
    if os.path.exists(cal):
        with open(cal) as f:
            temp = float(json.load(f)["temperature"])
    tree["temperature"] = temp
    return tree


def _ln(x, scale, bias, eps: float = 1e-6):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def forward(params: Dict, frames: torch.Tensor, heads: int, patch: int,
            dtype=torch.float32) -> torch.Tensor:
    """[B, H, W, 3] RGB in [0, 1] → [B] logits."""
    def r(x):
        return x if dtype == torch.float32 else _Round.apply(x, dtype)

    b, h, w, c = frames.shape
    x = frames.reshape(b, h // patch, patch, w // patch, patch, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, -1, patch * patch * c)
    x = r(r(x) @ r(params["patch_w"]) + r(params["patch_b"]))
    width = x.shape[-1]
    cls = r(params["cls_tok"]).expand(b, 1, width)
    x = r(torch.cat([cls, x], dim=1) + r(params["pos_emb"])[None])
    hd = width // heads
    for lp in params["layers"]:
        y = r(_ln(x, lp["ln1_scale"], lp["ln1_bias"]))
        qkv = r(y @ r(lp["qkv_w"]) + r(lp["qkv_b"]))
        t = qkv.shape[1]
        qkv = qkv.reshape(b, t, 3, heads, hd)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        att = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
        att = r(torch.softmax(att, dim=-1))
        o = r(torch.einsum("bhts,bshd->bthd", att, v).reshape(b, t, width))
        x = r(x + r(o @ r(lp["proj_w"]) + r(lp["proj_b"])))
        y = r(_ln(x, lp["ln2_scale"], lp["ln2_bias"]))
        y = r(F.gelu(r(y @ r(lp["mlp_in_w"]) + r(lp["mlp_in_b"])),
                     approximate="tanh"))
        x = r(x + r(y @ r(lp["mlp_out_w"]) + r(lp["mlp_out_b"])))
    x = _ln(x, params["ln_f_scale"], params["ln_f_bias"])
    return (x[:, 0] @ params["head_w"] + params["head_b"])[:, 0]


def loss(params: Dict, frames, labels, heads: int, patch: int,
         logit_l2: float, dtype=torch.float32) -> torch.Tensor:
    """Sigmoid BCE with logits, mean over the batch, plus
    ``logit_l2 · mean(z²)``."""
    z = forward(params, frames, heads, patch, dtype)
    y = labels.float()
    bce = (torch.clamp(z, min=0) - z * y
           + torch.log1p(torch.exp(-z.abs()))).mean()
    return bce + logit_l2 * torch.mean(z * z)


def probabilities(params: Dict, rgb01: np.ndarray, heads: int, patch: int,
                  device, block: int = 64, dtype=torch.float32) -> np.ndarray:
    """Per-frame probabilities of [N, S, S, 3] float32 RGB frames in
    [0, 1], in blocks of ``block`` frames."""
    out = []
    with torch.no_grad():
        for s in range(0, rgb01.shape[0], block):
            x = torch.from_numpy(np.ascontiguousarray(
                rgb01[s:s + block])).to(device)
            z = forward(params, x, heads, patch, dtype)
            out.append(torch.sigmoid(z / params["temperature"])
                       .double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)
