"""``csrc/warp.cu`` ``warp_bilinear_kernel``: per pixel it reads the five
source planes once (4 bytes each in float32, 2 in bfloat16) and the two
float32 flow planes, and writes five float32 planes: 48 B/px (38 in
bfloat16).  Its arithmetic is a few dozen operations a pixel, far under
the byte bound."""

from . import peaks

KERNEL = "warp_bilinear_kernel"


def bytes_moved(b: int, h: int, w: int, src_bytes: int = 4) -> float:
    return float(b) * h * w * (5 * src_bytes + 2 * 4 + 5 * 4)


def least_s(b: int, h: int, w: int, src_bytes: int = 4) -> float:
    return bytes_moved(b, h, w, src_bytes) / peaks.HBM_BYTES_PER_S


def grid_blocks(b: int, h: int, w: int) -> int:
    """The launch's 1-D grid: 256 threads a block, a thread a pixel."""
    return -(-(b * h * w) // 256)
