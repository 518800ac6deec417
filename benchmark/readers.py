"""Arithmetic that the metric readers in ``metrics/`` share.  A reader
returns None where its cell's run has nothing for it to read."""

from __future__ import annotations

from typing import Optional

import numpy as np

from .roofline import blur_solve, flow_iter, flow_round, peaks, warp


def traced(trace) -> bool:
    """A slice that recorded the device's work, all of it: a CPU run
    records none, and its numbers are never written under a device
    metric's name; nor are those of a slice that lost kernels."""
    return (trace is not None and trace.complete
            and bool(trace.device_events()))


def rate(run, key: str) -> Optional[float]:
    """A count of the window's completed work over the window's seconds."""
    n = run.data.get(key)
    return None if n is None or run.window_s <= 0 else n / run.window_s


def card_ms_per(run, key: str) -> Optional[float]:
    """The card's busy ms over all the window's work ÷ ``key``, the work
    it did; nothing where no complete session recorded it."""
    busy, n = run.data.get("card_busy_s"), run.data.get(key)
    return None if busy is None or not n else 1e3 * busy / n


def card_ms_per_frame(run) -> Optional[float]:
    """Over every clip sent in the window: its sampled frames."""
    return card_ms_per(run, "frames_sent")


def p95(values) -> Optional[float]:
    return float(np.percentile(values, 95)) if len(values) else None


def idle_percent(trace) -> Optional[float]:
    if not traced(trace) or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)


def per(trace, value: float, key: str) -> Optional[float]:
    n = trace.work.get(key) if traced(trace) else None
    return value / n if n else None


def _dtype_bytes(name: str) -> int:
    return 2 if ("bfloat16" in name or "bf16" in name) else 4


def flow_kernels_roofline(trace) -> Optional[float]:
    """Σ least time of the flow kernels' launches in the slice ÷ Σ their
    device time, in %.  Each launch's shape comes from its grid: a
    blur+solve's or a fused round's (B, H, W) directly; a warp's from the
    blur+solve that follows it on its stream (the round's order), checked
    against the warp's own grid."""
    if not traced(trace):
        return None
    evs = sorted((e for e in trace.kernels if trace.lo <= e["ts"] < trace.hi),
                 key=lambda e: e["ts"])
    least = spent = 0.0
    pending = {}
    for e in evs:
        name = e["name"]
        grid = (e.get("args") or {}).get("grid")
        stream = (e.get("args") or {}).get("stream")
        if grid is None:
            continue
        if warp.KERNEL in name:
            pending.setdefault(stream, []).append(e)
        elif any(k in name for k in blur_solve.KERNELS):
            shape = blur_solve.shape_of(grid, flow_round.LEVELS)
            if shape is None:
                continue
            least += blur_solve.least_s(*shape, _dtype_bytes(name))
            spent += e["dur"] / 1e6
            for wv in pending.pop(stream, []):
                if (wv.get("args") or {}).get("grid", [0])[0] == \
                        warp.grid_blocks(*shape):
                    least += warp.least_s(*shape, _dtype_bytes(wv["name"]))
                    spent += wv["dur"] / 1e6
        elif flow_iter.KERNEL in name:
            shape = blur_solve.shape_of(grid, flow_round.LEVELS)
            if shape is not None:
                least += flow_iter.least_s(*shape)
                spent += e["dur"] / 1e6
    return 100.0 * least / spent if spent > 0 else None


def flow_mfu(trace) -> Optional[float]:
    """Least time of the slice's flow work ÷ the slice, in %."""
    if not traced(trace) or not trace.work.get("frames"):
        return None
    return 100.0 * flow_round.least_s(trace.work["frames"],
                                      trace.work["pairs"]) / trace.window_s


def model_mfu(trace, flops: float) -> Optional[float]:
    """``flops`` over the slice at the bf16 dense peak, in %."""
    if not traced(trace) or not flops:
        return None
    return 100.0 * flops / (trace.window_s * peaks.BF16_FLOPS)


def pageable_h2d_s(trace) -> float:
    return trace.seconds_of([e for e in trace.copies
                             if "HtoD" in e["name"]
                             and "Pageable" in e["name"]])
