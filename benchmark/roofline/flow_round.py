"""The flow work of the heuristic path, counted from the work itself and
not from the kernels that do it: every distinct sampled frame's pyramid
level and polynomial expansion once per level (its level image read, five
float32 planes written: 24 B/px), and every pair's 3 solver rounds per
level at the fused round's 56 B/px and 215 operations a pixel
(``flow_iter.py``).  Levels: 320², 160², 80², 40² (OpenCV's clamp for
levels=3 at 320²)."""

from . import flow_iter, peaks

LEVELS = (320, 160, 80, 40)
ROUNDS = 3
EXPAND_BYTES_PER_PX = 24


def level_px() -> int:
    return sum(s * s for s in LEVELS)


def least_s(frames: int, pairs: int) -> float:
    px = level_px()
    expand = frames * px * EXPAND_BYTES_PER_PX / peaks.HBM_BYTES_PER_S
    rounds = pairs * ROUNDS * flow_iter.least_s(1, 1, px)
    return expand + rounds
