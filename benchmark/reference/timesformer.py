"""Plain PyTorch TimeSformer (divided space-time attention), float32; and
the seeded checkpoint that the cell serves.

The published block (Bertasius et al., ICML 2021, arXiv:2102.05095;
Hugging Face's ``TimesformerLayer``, ``divided_space_time``), written with
einsums that name the window ``w``, patch ``n``, frame ``t``, head ``h``
and channels; the stream kept as the class token ``c`` [W, D] and the
patch tokens ``x`` [W, N, T, D] (the published (n, t) order):

* embedding: each frame's 16² patches of the normalised RGB frame through
  one product, the positions [N+1, D] added per frame, the time
  embedding [T, D] by frame; c = class token + position 0;
* a block: x' = x + temporal_dense(MHSA_t(LN_t(x_n))) over each patch's
  frames; B_t = MHSA_s(LN_1([c; x'_{·,t}])) over each frame's tokens,
  c' = c + mean_t B_t[0], x'' = x' + B_t[1:]; then y + MLP(LN_2(y)) with
  the exact GELU, token by token;
* the final LayerNorm's class token through the head: one logit a window;
  probability = sigmoid(logit / temperature).

It reads the checkpoint's ``params.npz`` (keys ``patch_w``,
``layers.<i>.temporal_qkv_w``, …, ``[in, out]`` products) and
``calibration.json`` itself, and imports nothing of the program.  Float32
with TF32 off; with another ``dtype`` (bfloat16, float8_e4m3fn) every
product's operands and result, and the stream, are rounded to it and back:
the precision the configuration states, and the control's lower one.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

MEAN = (0.45, 0.45, 0.45)   # the published processor's Kinetics statistics
STD = (0.225, 0.225, 0.225)
INIT_STD = 0.02             # the published initializer_range


def shapes(image_size: int, patch: int, frames: int, width: int, mlp: int,
           depth: int) -> Dict:
    """The flat checkpoint's keys and shapes, one ``[in, out]`` product per
    published module."""
    d, n = width, (image_size // patch) ** 2
    layer = {"temporal_ln_scale": (d,), "temporal_ln_bias": (d,),
             "temporal_qkv_w": (d, 3 * d), "temporal_qkv_b": (3 * d,),
             "temporal_proj_w": (d, d), "temporal_proj_b": (d,),
             "temporal_dense_w": (d, d), "temporal_dense_b": (d,),
             "ln1_scale": (d,), "ln1_bias": (d,),
             "qkv_w": (d, 3 * d), "qkv_b": (3 * d,),
             "proj_w": (d, d), "proj_b": (d,),
             "ln2_scale": (d,), "ln2_bias": (d,),
             "mlp_in_w": (d, mlp), "mlp_in_b": (mlp,),
             "mlp_out_w": (mlp, d), "mlp_out_b": (d,)}
    out = {"patch_w": (patch * patch * 3, d), "patch_b": (d,),
           "cls_tok": (d,), "pos_emb": (n + 1, d), "time_emb": (frames, d)}
    for i in range(depth):
        out.update({f"layers.{i}.{k}": v for k, v in layer.items()})
    out.update({"ln_f_scale": (d,), "ln_f_bias": (d,), "head_w": (d, 1),
                "head_b": (1,)})
    return out


def write_seeded(ckpt_dir: str, rng: np.random.Generator, **sizes) -> None:
    """A checkpoint directory of seeded weights: every product's weight and
    every embedding N(0, 0.02²), LayerNorm scales 1, biases 0, in
    ``params.npz``; ``calibration.json`` at temperature 1."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = {}
    for k, shape in shapes(**sizes).items():
        if k.endswith("_scale"):
            leaves[k] = np.ones(shape, np.float32)
        elif k.endswith(("_w", "_tok", "_emb")):
            leaves[k] = rng.standard_normal(shape, np.float32) * np.float32(
                INIT_STD)
        else:
            leaves[k] = np.zeros(shape, np.float32)
    np.savez(os.path.join(ckpt_dir, "params.npz"), **leaves)
    with open(os.path.join(ckpt_dir, "calibration.json"), "w") as f:
        json.dump({"temperature": 1.0}, f)


def load(ckpt_dir: str, device) -> Dict:
    """The parameter tree (float32 tensors on ``device``) and the
    temperature of a checkpoint directory."""
    with np.load(os.path.join(ckpt_dir, "params.npz")) as z:
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


def forward(params: Dict, clips: torch.Tensor, heads: int, patch: int,
            dtype=torch.float32) -> torch.Tensor:
    """[W, T, S, S, 3] RGB in [0, 1] → [W] logits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def r(x):
        return x if dtype == torch.float32 else x.to(dtype).float()

    def dense(x, w, b):
        return r(torch.einsum("...i,io->...o", r(x), r(w)) + r(b))

    def mhsa(h, lp, pre, batch):
        """Self-attention over ``h``'s second-to-last axis; ``batch`` names
        its two leading axes."""
        q, k, v = dense(h, lp[pre + "qkv_w"], lp[pre + "qkv_b"]).chunk(3, -1)
        split = [*q.shape[:-1], heads, q.shape[-1] // heads]
        q, k, v = (z.reshape(split) for z in (q, k, v))
        a = torch.einsum(f"{batch}ahk,{batch}bhk->{batch}hab", q, k) \
            / math.sqrt(q.shape[-1])
        p = r(torch.softmax(a, dim=-1))
        o = r(torch.einsum(f"{batch}hab,{batch}bhk->{batch}ahk", p, v))
        return dense(o.flatten(-2), lp[pre + "proj_w"], lp[pre + "proj_b"])

    wn, t, size = clips.shape[0], clips.shape[1], clips.shape[2]
    g = size // patch
    px = r((clips.float() - clips.new_tensor(MEAN)) / clips.new_tensor(STD))
    px = px.reshape(wn, t, g, patch, g, patch, 3)
    px = torch.einsum("wtyixjc->wtyxijc", px).reshape(wn, t, g * g, -1)
    pos = r(params["pos_emb"])
    e = r(dense(px, params["patch_w"], params["patch_b"]) + pos[1:])
    x = r(torch.einsum("wtnd->wntd", e) + r(params["time_emb"]))
    c = r(r(params["cls_tok"]) + pos[0]).expand(wn, -1)

    for lp in params["layers"]:
        h = r(_ln(x, lp["temporal_ln_scale"], lp["temporal_ln_bias"]))
        a = mhsa(h, lp, "temporal_", "wn")             # over t
        x = r(x + dense(a, lp["temporal_dense_w"], lp["temporal_dense_b"]))
        s = torch.cat([c[:, None, None].expand(-1, t, 1, -1),
                       torch.einsum("wntd->wtnd", x)], dim=2)
        h = r(_ln(s, lp["ln1_scale"], lp["ln1_bias"]))
        b = mhsa(h, lp, "", "wt")                      # over [c; x_{·,t}]
        c = r(c + r(b[:, :, 0].mean(dim=1)))
        x = r(x + torch.einsum("wtnd->wntd", b[:, :, 1:]))
        c, x = (r(y + dense(r(F.gelu(dense(
            r(_ln(y, lp["ln2_scale"], lp["ln2_bias"])), lp["mlp_in_w"],
            lp["mlp_in_b"]))), lp["mlp_out_w"], lp["mlp_out_b"]))
            for y in (c, x))

    c = _ln(c, params["ln_f_scale"], params["ln_f_bias"])
    return c @ params["head_w"][:, 0] + params["head_b"][0]


def window_logits(params: Dict, windows: List[np.ndarray], heads: int,
                  patch: int, device, block: int = 4,
                  dtype=torch.float32) -> np.ndarray:
    """Logits of [T, S, S, 3] BGR uint8 windows (flipped to RGB and scaled
    to [0, 1] here), ``block`` windows a forward; the temperature divides
    them, as it divides the served logits before the sigmoid."""
    out = []
    with torch.no_grad():
        for s in range(0, len(windows), block):
            x = torch.from_numpy(np.stack(windows[s:s + block])).to(device)
            x = x.flip(-1).float() / 255.0
            z = forward(params, x, heads, patch, dtype)
            out.append((z / params["temperature"]).double().cpu().numpy())
    return np.concatenate(out) if out else np.zeros(0)
