"""The same seed gives the same inputs; another seed gives others; every
seed sends the same sizes."""

from __future__ import annotations

import itertools

import numpy as np

from benchmark import generate, media, spec

TRAFFIC = spec.traffic("clips-c4-1080p")
BIG = 2 ** 31 + 12345


def _clips(seed, client, n=80):
    return list(itertools.islice(generate.clips(TRAFFIC, seed, client), n))


def test_same_seed_same_clips_other_seed_others():
    assert _clips(BIG, 0) == _clips(BIG, 0)
    assert _clips(BIG, 0) != _clips(BIG + 1, 0)
    assert _clips(BIG, 0) != _clips(BIG, 1)


def test_every_seed_sends_the_same_sizes():
    grid = sorted(generate.clip_lengths(TRAFFIC))
    lo, hi = TRAFFIC["clip_frames"]
    assert grid[0] >= lo and grid[-1] <= hi and len(grid) == 32
    for seed in (0, BIG, 2 ** 40 + 3):
        first = [n for _, n in _clips(seed, 2, len(grid))]
        assert sorted(first) == grid
        for s, n in _clips(seed, 2, 200):
            assert 0 <= s and s + n <= TRAFFIC["pool_frames"]


def test_log_uniform_grid():
    lengths = np.log(generate.clip_lengths(TRAFFIC))
    steps = np.diff(lengths)
    assert np.all(steps >= 0) and np.ptp(steps) < 0.05


def test_frames_and_wave_follow_the_seed():
    a = media.make_frames(3, 40, 64, BIG)
    assert np.array_equal(a, media.make_frames(3, 40, 64, BIG))
    assert not np.array_equal(a, media.make_frames(3, 40, 64, BIG + 1))
    assert not np.array_equal(a[0], a[1])
    w = media.speech_wave(4.0, 7)
    assert w.dtype == np.float32 and w.shape == (64000,)
    assert np.array_equal(w, media.speech_wave(4.0, 7))
    assert not np.array_equal(w, media.speech_wave(4.0, 8))


def test_step_rows_differ_within_a_step():
    rows = generate.step_rows(BIG, 256, 64, 10)
    assert np.array_equal(rows, generate.step_rows(BIG, 256, 64, 10))
    assert not np.array_equal(rows, generate.step_rows(BIG + 1, 256, 64, 10))
    for r in rows:
        assert len(set(r.tolist())) == 64
    assert len(set(rows[:4].ravel().tolist())) == 256
