"""Plain PyTorch TimeSformer (divided space-time attention), float32.

The reference of ``models/timesformer.py``, written from the published
block (Bertasius et al., ICML 2021; Hugging Face's ``TimesformerLayer``
with ``attention_type="divided_space_time"``) with einsums that name the
window ``w``, the patch ``n``, the frame ``t`` (``s`` a second frame or
token), the head ``h`` and the channels; it imports nothing of the port.
The stream is kept as the class token ``c`` [W, D] and the patch tokens
``x`` [W, N, T, D], which is the published (n, t) order.

Float32 with TF32 off (set on each call).  With another ``dtype``
(bfloat16, float8_e4m3fn) every product's operands and result, and the
stream, are rounded to it and back on the way: the lower precisions that
a comparison puts in the program's place.  The parameter tree has the
keys of ``models/timesformer.param_shapes``; the input is [W, T, S, S, 3]
RGB in [0, 1], normalised by the Kinetics statistics below.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

MEAN = (0.45, 0.45, 0.45)
STD = (0.225, 0.225, 0.225)


def _ln(x, scale, bias, eps: float = 1e-6):
    m = x.mean(dim=-1, keepdim=True)
    v = ((x - m) ** 2).mean(dim=-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * scale + bias


def forward(params: Dict, clips: torch.Tensor, heads: int, patch: int,
            dtype=torch.float32) -> torch.Tensor:
    """[W, T, S, S, 3] RGB in [0, 1] → [W] logits (the head's first
    output)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def r(x):
        return x if dtype == torch.float32 else x.to(dtype).float()

    def dense(x, w, b):
        return r(torch.einsum("...i,io->...o", r(x), r(w)) + r(b))

    def mhsa(h, lp, pre, seq):
        """Self-attention of ``h`` over its axis ``seq`` ('t' or 's':
        the operand's second-to-last axis), heads split from D."""
        q, k, v = dense(h, lp[pre + "qkv_w"], lp[pre + "qkv_b"]).chunk(3, -1)
        split = [*q.shape[:-1], heads, q.shape[-1] // heads]
        q, k, v = (z.reshape(split) for z in (q, k, v))
        e = "wn" if seq == "t" else "wt"   # the batch axes of the operand
        a = torch.einsum(f"{e}ahk,{e}bhk->{e}hab", q, k) \
            / math.sqrt(q.shape[-1])
        p = r(torch.softmax(a, dim=-1))
        o = r(torch.einsum(f"{e}hab,{e}bhk->{e}ahk", p, v))
        return dense(o.flatten(-2), lp[pre + "proj_w"], lp[pre + "proj_b"])

    wn, t, size = clips.shape[0], clips.shape[1], clips.shape[2]
    g = size // patch
    mean = clips.new_tensor(MEAN)
    std = clips.new_tensor(STD)
    px = r((clips.float() - mean) / std)
    # each frame's patches, a patch laid out (row, column, channel)
    px = px.reshape(wn, t, g, patch, g, patch, 3)
    px = torch.einsum("wtyixjc->wtyxijc", px).reshape(wn, t, g * g, -1)
    pos = r(params["pos_emb"])
    e = r(dense(px, params["patch_w"], params["patch_b"]) + pos[1:])
    x = r(torch.einsum("wtnd->wntd", e) + r(params["time_emb"]))
    c = r(r(params["cls_tok"]) + pos[0]).expand(wn, -1)

    for lp in params["layers"]:
        # temporal: for every patch n, attention over its frames t
        h = r(_ln(x, lp["temporal_ln_scale"], lp["temporal_ln_bias"]))
        a = mhsa(h, lp, "temporal_", "t")
        x = r(x + dense(a, lp["temporal_dense_w"], lp["temporal_dense_b"]))
        # spatial: for every frame t, attention over [c; x_{·,t}]
        s = torch.cat([c[:, None, None].expand(-1, t, 1, -1),
                       torch.einsum("wntd->wtnd", x)], dim=2)
        h = r(_ln(s, lp["ln1_scale"], lp["ln1_bias"]))
        b = mhsa(h, lp, "", "s")                       # [W, T, 1+N, D]
        c = r(c + r(b[:, :, 0].mean(dim=1)))           # mean over frames
        x = r(x + torch.einsum("wtnd->wntd", b[:, :, 1:]))
        # MLP, token by token
        c, x = (r(y + dense(r(F.gelu(dense(
            r(_ln(y, lp["ln2_scale"], lp["ln2_bias"])), lp["mlp_in_w"],
            lp["mlp_in_b"]))), lp["mlp_out_w"], lp["mlp_out_b"]))
            for y in (c, x))

    c = _ln(c, params["ln_f_scale"], params["ln_f_bias"])
    return c @ params["head_w"][:, 0] + params["head_b"][0]
