"""Forward FLOPs of one frame through the dense ViT detector: the patch
projection, and per block the qkv, attention (scores and values), output
projection and MLP products, and the head; a multiply-add is 2 FLOPs.
At ``full`` (224², patch 16, width 384, 6 heads, MLP 1536, depth 6) it is
4.66 GFLOP a frame."""


def flops(image_size: int = 224, patch: int = 16, width: int = 384,
          heads: int = 6, mlp: int = 1536, depth: int = 6) -> float:
    p = (image_size // patch) ** 2
    t = p + 1
    embed = 2.0 * p * (patch * patch * 3) * width
    block = (2.0 * t * width * 3 * width          # qkv
             + 2.0 * 2.0 * t * t * width          # scores and values
             + 2.0 * t * width * width            # output projection
             + 2.0 * 2.0 * t * width * mlp)       # MLP in and out
    return embed + depth * block + 2.0 * width


def train_step_flops(batch: int, **cfg) -> float:
    """Forward and backward (3 × the forward) of a batch."""
    return 3.0 * batch * flops(**cfg)
