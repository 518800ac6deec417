"""Decoded frame batches.

The port starts from decoded media: container decode and probe stay with
the next slice.  This module keeps the ``FrameBatch`` container and the
reference's sampling cadence, copied from ``avd_tpu/ingest/video_reader.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FrameBatch:
    """A batch of sampled frames plus decode bookkeeping."""

    frames: np.ndarray  # [N, H, W, 3] uint8, BGR (matches cv2 decode)
    sampled: int        # frames retrieved (== N)
    fps: float
    width: int
    height: int
    duration: float


def sampling_step(fps: float) -> int:
    """step = max(1, round((fps or 30)/2)) — reference video.py:19."""
    return max(1, int(round((fps or 30) / 2)))
