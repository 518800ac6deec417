"""The one traffic generator: what a traffic file's parameters mean.

Closed-loop clip traffic (``kind: closed_loop_clips``): ``clients``
clients each send clip after clip.  Clip lengths (sampled frames) are a
fixed grid of ``length_grid`` quantiles of the log-uniform distribution
over ``clip_frames`` = [lo, hi]: every seed sends the same sizes, each
client in its own seeded order, a fresh permutation of the grid per
cycle.  A clip is the contiguous slice of the run's frame pool that starts
at a seeded offset, and its audio the matching slice of the pool's wave.

Training traffic (``kind: train_steps``): step k trains on the rows of a
device-resident pool that a seeded permutation per epoch assigns to it.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A generator for (seed, stream...): any whole seed, large ones too."""
    return np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64),
                                                         *stream]))


def clip_lengths(traffic: Dict) -> np.ndarray:
    """The grid of clip lengths every seed sends, in sampled frames."""
    lo, hi = traffic["clip_frames"]
    k = int(traffic["length_grid"])
    q = (np.arange(k) + 0.5) / k
    return np.rint(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                   ).astype(int)


def clips(traffic: Dict, seed: int,
          client: int) -> Iterator[Tuple[int, int]]:
    """Endless (start, length) clips of one client."""
    r = rng(seed, 1, client)
    grid = clip_lengths(traffic)
    pool = int(traffic["pool_frames"])
    while True:
        for n in r.permutation(grid):
            yield int(r.integers(0, pool - n + 1)), int(n)


def step_rows(seed: int, pool: int, batch: int, steps: int) -> np.ndarray:
    """[steps, batch] pool rows: each epoch a seeded permutation of the
    pool cut into batches, so the rows of one step all differ."""
    r = rng(seed, 2)
    per = pool // batch
    out = np.empty((steps, batch), np.int64)
    for k in range(steps):
        if k % per == 0:
            perm = r.permutation(pool)
        j = k % per
        out[k] = perm[j * batch:(j + 1) * batch]
    return out
