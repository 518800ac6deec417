"""``csrc/flow_iter.cu`` ``flow_iter_kernel`` (``AVD_PALLAS_ITER=1``): one
fused Farnebäck round per launch.  Per pixel it reads R0 and R1 (five
float32 planes each) and the two flow planes and writes two: 56 B/px, and
computes about 215 operations; bytes bound it.  Its grid is
(ceil(W / 32), rows, B)."""

from . import peaks

KERNEL = "flow_iter_kernel"
BYTES_PER_PX = 56
OPS_PER_PX = 215
TILE_W = 32


def least_s(b: int, h: int, w: int) -> float:
    px = float(b) * h * w
    return max(px * BYTES_PER_PX / peaks.HBM_BYTES_PER_S,
               px * OPS_PER_PX / peaks.FP32_FLOPS)
