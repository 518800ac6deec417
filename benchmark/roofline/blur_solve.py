"""``csrc/blur_solve.cu`` ``blur_solve_kernel`` (float32 M) and
``blur_solve_bf16_kernel``: per pixel it reads the five M planes once (4
or 2 bytes each) and writes the two float32 flow planes: 28 B/px (18 in
bfloat16).  The 15×15 box sums and the solve are about 60 operations a
pixel, under the byte bound.  Its grid is (ceil(W / 32), rows, B)."""

from . import peaks

KERNELS = ("blur_solve_kernel", "blur_solve_bf16_kernel")
TILE_W = 32


def bytes_moved(b: int, h: int, w: int, m_bytes: int = 4) -> float:
    return float(b) * h * w * (5 * m_bytes + 2 * 4)


def least_s(b: int, h: int, w: int, m_bytes: int = 4) -> float:
    return bytes_moved(b, h, w, m_bytes) / peaks.HBM_BYTES_PER_S


def shape_of(grid, sizes) -> tuple:
    """(B, H, W) of a launch from its grid, the level being the square
    size in ``sizes`` whose column tiles match; None if none does."""
    for s in sizes:
        if -(-s // TILE_W) == grid[0]:
            return grid[2], s, s
    return None
