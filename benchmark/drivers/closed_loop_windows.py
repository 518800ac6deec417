"""Closed-loop clip traffic with a windowed clip detector (TimeSformer).

The traffic, the window, the card's time and every check of
``closed_loop_clips`` (by import: its ``run``, with two of its steps
widened), plus the detector's:

* set-up first draws the detector's weights from the seed (numpy,
  ``reference/timesformer.write_seeded``) into a run directory, points
  ``AVD_DETECTOR_CKPT`` at it and warms every forward size through
  ``scoring.warm``; a program without the family raises there, before
  the frame pool is made;
* a clip whose envelope has no detector timeline, or one whose
  ``weights`` is not that directory, fails (``failed_clips``);
* ``tsf_gap``: each scored window's logit (from the probability of the
  frames it is the first window of) against the reference at the
  precision the configuration states, the widest absolute gap.  The
  windows are those of every clip checked (0, T, 2T, … and, where T does
  not divide the clip, its last T frames), up to a seeded sample of
  ``checked`` windows, computed in blocks of ``block``.  With
  ``--control 1`` the reference in ``control_dtype`` takes the program's
  place.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
from typing import List, Tuple

import numpy as np

from . import closed_loop_clips as base
from .. import generate
from ..reference import host_prep as ref_prep
from ..reference import timesformer as ref_tsf
from ..run import Check, Run

_SIZES = ("image_size", "patch", "frames", "width", "mlp", "depth")


def run(ctx) -> Run:
    import torch
    m = ctx.config["timesformer"]
    ckpt = tempfile.mkdtemp(prefix="bench_tsf_")
    try:
        ref_tsf.write_seeded(ckpt, generate.rng(ctx.seed, 4),
                             **{k: int(m[k]) for k in _SIZES})
        os.environ["AVD_DETECTOR_CKPT"] = ckpt
        from avd_tpu_torch.models import scoring
        dev = torch.device(ctx.device)
        scoring.warm(dev)
        ctx.log(f"detector weights written and every forward size warmed "
                f"({time.perf_counter() - ctx.t0:.1f} s)")
        failure, compare = base._failure, base._compare

        def widened_failure(c, detector):
            why = failure(c, True)
            if why is None and c.env["video"]["detector"].get(
                    "weights") != ckpt:
                why = f"weights {c.env['video']['detector'].get('weights')}"
            return why

        def widened_compare(ctx_, run_, clips, pool, wave, spf, sr, dev_,
                            detector):
            compare(ctx_, run_, clips, pool, wave, spf, sr, dev_, detector)
            run_.checks.append(Check("tsf_gap", _tsf_gap(
                ctx_, clips, pool, dev_, ckpt), float(
                    ctx_.config["limits"]["tsf_gap"])))

        base._failure, base._compare = widened_failure, widened_compare
        try:
            out = base.run(ctx)
        finally:
            base._failure, base._compare = failure, compare
        out.data["timesformer"] = m
        return out
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


def window_starts(n: int, t: int) -> List[int]:
    """The window contract: 0, t, 2t, … and, where ``t`` does not divide
    ``n``, the last ``t`` frames (a clip under ``t`` frames is one window,
    padded with its last frame)."""
    n = max(n, t)
    starts = list(range(0, n - t + 1, t))
    if n % t:
        starts.append(n - t)
    return starts


def _logit(p) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def _tsf_gap(ctx, clips, pool, dev, ckpt: str) -> float:
    import torch
    m = ctx.config["timesformer"]
    t, size = int(m["frames"]), int(m["image_size"])
    # (clip, window index, start) of every window of every clip
    wins: List[Tuple[object, int, int]] = [
        (c, j, s) for c in clips
        for j, s in enumerate(window_starts(c.n, t))]
    if not wins:
        return float("inf")
    if len(wins) > int(m["checked"]):
        pick = generate.rng(ctx.seed, 5).choice(len(wins), int(m["checked"]),
                                                replace=False)
        wins = [wins[i] for i in sorted(pick)]
    a = min(c.start for c, _, _ in wins)
    b = max(c.start + c.n for c, _, _ in wins)
    resized = ref_prep.resize_area(pool[a:b], size)

    def frames_of(c, s):
        clip = resized[c.start - a:c.start - a + c.n]
        if c.n < t:
            clip = np.concatenate([clip, np.repeat(clip[-1:], t - c.n, 0)])
        return clip[s:s + t]

    windows = [frames_of(c, s) for c, _, s in wins]
    params = ref_tsf.load(ckpt, dev)
    heads, patch, block = int(m["heads"]), int(m["patch"]), int(m["block"])

    def logits(dtype, ws=windows):
        return ref_tsf.window_logits(params, ws, heads, patch, dev, block,
                                     getattr(torch, dtype))

    ref = logits(m["dtype"])
    gaps = np.empty(len(wins))
    if ctx.control:  # the reference one precision down in the program's place
        gaps[:] = np.abs(logits(m["control_dtype"]) - ref)
    else:
        for i, (c, j, _) in enumerate(wins):
            # the frames this window is the first window of
            tl = np.asarray(c.env["video"]["detector"]["timeline"])
            mine = tl[j * t:min((j + 1) * t, c.n)] if len(tl) == c.n \
                else np.full(1, np.nan)
            gaps[i] = np.max(np.abs(_logit(mine) - ref[i]))
    k = min(len(windows), int(m["block"]) * 4)
    r32 = logits("float32", windows[:k])
    _log(ctx, gaps, ref[:k] - r32, len(wins))
    del params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return float(np.max(gaps)) if np.all(np.isfinite(gaps)) else float("inf")


def _log(ctx, gaps, stated_vs_f32, n: int) -> None:
    def q(x):
        return " ".join(f"{v:.3g}" for v in np.percentile(np.abs(x),
                                                          [50, 90, 100]))

    ctx.log(f"detector windows checked: {n}; |dlogit| p50/p90/max {q(gaps)}; "
            f"the stated reference against float32 on "
            f"{len(stated_vs_f32)}: {q(stated_vs_f32)}")
