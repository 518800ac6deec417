"""Forward FLOPs of one window through the TimeSformer detector (divided
space-time attention): the patch projection of every frame; per block
the temporal qkv, attention over each patch's T frames (scores and
values), output projection and ``temporal_dense``, the spatial qkv,
attention over each frame's N + 1 tokens, output projection, and the MLP
over all T·N + 1 tokens; and the head.  A multiply-add is 2 FLOPs.  At
``hr`` (448², patch 16, 16 frames, width 768, 12 heads, MLP 3072, depth
12) it is 3.405 TFLOP a window, 10.7 % of it the spatial attention."""


def flops(image_size: int = 448, patch: int = 16, frames: int = 16,
          width: int = 768, heads: int = 12, mlp: int = 3072,
          depth: int = 12) -> float:
    n = (image_size // patch) ** 2             # patches a frame
    tn = frames * n                            # patch tokens a window
    d = width
    embed = 2.0 * tn * (patch * patch * 3) * d
    temporal = (2.0 * tn * d * 3 * d           # qkv
                + 2.0 * 2.0 * n * frames * frames * d   # scores, values
                + 2.0 * tn * d * d             # output projection
                + 2.0 * tn * d * d)            # temporal_dense
    spatial = (2.0 * frames * (n + 1) * d * 3 * d
               + 2.0 * 2.0 * frames * (n + 1) ** 2 * d
               + 2.0 * frames * (n + 1) * d * d)
    mlp_ = 2.0 * 2.0 * (tn + 1) * d * mlp
    return embed + depth * (temporal + spatial + mlp_) + 2.0 * d
