"""The traced slice of a run: ``torch.profiler`` with CPU and CUDA
activities over a few steady seconds of the window, reduced to the
device's kernels, copies and sets, the host's operations, and the work the
driver counted in the same seconds.

The slice is marked by a ``record_function`` range on the thread that
opens it, so the device intervals are clipped to the same clock.  The
profile goes through the profiler's Chrome-trace export (the only form
that keeps each kernel's launch grid) into a temporary file under
``TMPDIR``, which is read and deleted at once.

A session of the profiler can lose every kernel that one thread launches
while it still records that thread's launch calls (seen on the H100 with
the dispatch thread: 50248 launches in a 2 s slice, none with its kernel).
So a slice is ``complete`` only where at most ``MAX_LOST`` of the launches
in it have no kernel of the same correlation; the readers read nothing
from one that is not, and the drivers take another slice.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

SLICE = "benchmark.slice"
MAX_LOST = 0.05  # sound slices lose 0.3-0.8 % (the launches at the close)


def prime() -> None:
    """Start and stop the profiler once on an idle card, in set-up: a
    process's first profiler session, opened while other threads launch
    kernels, can record none of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.ones(8, device="cuda" if torch.cuda.is_available()
                   else "cpu").sum().item()


class Slice:
    """``start()``, then ``open()`` a warm-up later, then ``stop()``, all
    on one thread; ``digest()`` gives the ``Trace``.

    The profiler's first cycle is a warm-up that is thrown away: without
    it the card's first events of a trace can be lost.  Operators are
    recorded on the opening thread only, which keeps the profiler's cost
    on the clients low; the CUDA runtime calls of every thread come from
    CUPTI with the device's events."""

    def __init__(self):
        self._prof = None
        self._mark = None
        self.t0 = self.t1 = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        import torch
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(
            activities=acts,
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
        self._prof.start()

    def open(self) -> None:
        from torch.profiler import record_function
        self._prof.step()
        self._mark = record_function(SLICE)
        self._mark.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        import torch
        self.t1 = time.perf_counter()
        self._mark.__exit__(None, None, None)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.step()
        self._prof.stop()

    def abandon(self) -> None:
        """Stop a session whose slice never opened."""
        self._prof.stop()
        self._prof = None

    def digest(self, work: Optional[Dict] = None) -> "Trace":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        return Trace(events, work or {})


WARM_S = 1.0  # the profiler's warm-up cycle, before a slice opens


class Slicer:
    """Takes a window's traced slice, ``length`` seconds from ``t_first``
    on, where a caller polls it (``poll`` says how long it may wait).

    ``begin()`` starts the profiler early, at a moment the caller knows
    the card to be idle: a session started while other threads launch
    kernels is the one that can lose a thread's kernels.  Where a slice
    is not ``complete`` all the same, another session starts at once and
    its slice opens a warm-up later, as long as it ends by ``t_end``.
    ``trace`` is the last slice taken; ``counts`` the caller's count at
    its open and its close."""

    def __init__(self, t_first: float, length: float, t_end: float, log):
        self.t_next, self.length, self.t_end = t_first, length, t_end
        self.log = log
        self.trace: Optional[Trace] = None
        self.t0 = self.t1 = None
        self.counts = (0, 0)
        self.done = False
        self._sl: Optional[Slice] = None
        self._open = False
        self._count0 = 0
        self.tries: List[float] = []  # each slice's lost share

    def begin(self) -> None:
        self._sl = Slice()
        self._sl.start()

    def poll(self, now: float, count: int = 0) -> float:
        if self.done:
            return float("inf")
        if self._open:
            if now < self._sl.t0 + self.length:
                return self._sl.t0 + self.length - now
            return self._close(count)
        if self._sl is None:
            if now < self.t_next - WARM_S:
                return self.t_next - WARM_S - now
            self.begin()
            self.t_next = max(self.t_next, now + WARM_S)
            return self.t_next - now
        if now < self.t_next:
            return self.t_next - now
        if now + self.length > self.t_end:
            self.log(f"no room for a traced slice in the window "
                     f"({len(self.tries)} taken)")
            self._sl.abandon()
            self._sl, self.done = None, True
            return float("inf")
        self._sl.open()
        self._open, self._count0 = True, count
        return self.length

    def finish(self, count: int = 0) -> None:
        """At the window's close: close a slice still open, and stop a
        session whose slice never opened."""
        if self._open:
            self._close(count)
        elif self._sl is not None:
            self._sl.abandon()
            self._sl = None
        self.done = True

    def _close(self, count: int) -> float:
        sl = self._sl
        sl.stop()
        self._open, self._sl = False, None
        self.trace = sl.digest()
        self.t0, self.t1 = sl.t0, sl.t1
        self.counts = (self._count0, count)
        self.tries.append(self.trace.lost_share)
        if self.trace.complete:
            self.done = True
            return float("inf")
        self.log(f"the profiler lost the kernels of "
                 f"{100 * self.trace.lost_share:.1f} % of the slice's "
                 f"{self.trace.launches} launches; another slice")
        self.t_next = time.perf_counter() + WARM_S
        return 0.0


WINDOW = "benchmark.window"
MAX_GAP_S = 10.0  # a longer pause in the launches: the records stopped


class Busy:
    """The card's busy seconds over all of a window: a profiler session
    from before the window to after its drain, reduced in memory (no
    export) to the union of kernel, copy and set intervals inside a
    ``record_function`` range on the opening thread.

    ``start()`` where the card is idle (see ``Slicer``), ``open()`` and
    ``close()`` on one thread, then ``stop()``.  ``complete`` as for a
    ``Trace``, and besides no pause of ``MAX_GAP_S`` in the launches and
    at least ``expect`` kernels whose names hold one of ``named``: the
    profiler's buffers stop taking records once full, and the program
    counts the launches of its own kernels."""

    def __init__(self, named: Tuple[str, ...] = (), expect: int = 0):
        self._prof = self._mark = None
        self.busy_s = self.span_s = self.lost_share = 0.0
        self.launches = self.counted = 0
        self.gap_s = 0.0
        self.named, self.expect = named, expect

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.start()

    def open(self) -> None:
        from torch.profiler import record_function
        self._mark = record_function(WINDOW)
        self._mark.__enter__()

    def close(self) -> None:
        self._mark.__exit__(None, None, None)

    def stop(self) -> None:
        import torch
        from torch._C._autograd import DeviceType
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        lo = hi = None
        device, launches, seen = [], [], set()
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name == WINDOW or e.is_user_annotation():
                    continue  # the range's shadow on the card, no work
                device.append((e.start_ns(), e.end_ns(),
                               any(k in name for k in self.named)))
                seen.add(e.correlation_id())
            elif name == WINDOW:
                lo, hi = e.start_ns(), e.end_ns()
            elif name.startswith("cudaLaunch") or name.startswith("cuLaunch"):
                launches.append((e.start_ns(), e.correlation_id()))
        del events
        if lo is None:
            raise RuntimeError("the window's marker is missing")
        self.reduce(lo, hi, device, launches, seen)

    def reduce(self, lo, hi, device, launches, seen) -> None:
        """Busy and span seconds of [lo, hi] (ns) from the device's
        intervals, and the launches' lost share and longest pause."""
        ivs = [(max(lo, a), min(hi, b)) for a, b, _ in device
               if a < hi and b > lo]
        self.busy_s = _union(ivs) / 1e9
        self.counted = sum(k for a, _, k in device if lo <= a < hi)
        self.span_s = (hi - lo) / 1e9
        inside = [(ts, c) for ts, c in launches if lo <= ts < hi]
        self.launches = len(inside)
        lost = sum(c not in seen for _, c in inside)
        self.lost_share = lost / len(inside) if inside else 1.0
        edges = [lo] + sorted(ts for ts, _ in inside) + [hi]
        self.gap_s = max(b - a for a, b in zip(edges, edges[1:])) / 1e9

    @property
    def complete(self) -> bool:
        return (self.lost_share <= MAX_LOST and self.gap_s < MAX_GAP_S
                and self.counted >= self.expect)


def _union(intervals: List[Tuple[float, float]]) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def _is_launch(ev: Dict) -> bool:
    name = ev.get("name", "")
    return name.startswith("cudaLaunch") or name.startswith("cuLaunch")


def _correlation(ev: Dict):
    return (ev.get("args") or {}).get("correlation")


class Trace:
    """Device and host events of the slice (times in microseconds of the
    profiler's clock) and ``work``: the driver's counts in the slice."""

    def __init__(self, events: List[Dict], work: Dict):
        self.work = work
        self.kernels: List[Dict] = []
        self.copies: List[Dict] = []
        self.sets: List[Dict] = []
        self.host: List[Tuple[float, float, str]] = []
        threads = {ev.get("tid"): ev.get("args", {}).get("name", "")
                   for ev in events
                   if ev.get("ph") == "M" and ev.get("name") == "thread_name"}
        lo = hi = None
        launches: List[Dict] = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            if cat == "kernel":
                self.kernels.append(ev)
            elif cat == "gpu_memcpy":
                self.copies.append(ev)
            elif cat == "gpu_memset":
                self.sets.append(ev)
            elif cat in ("cpu_op", "user_annotation", "cuda_runtime",
                         "cuda_driver"):
                if ev.get("name") == SLICE and cat == "user_annotation":
                    lo, hi = ts, ts + dur
                else:
                    if _is_launch(ev):
                        launches.append(ev)
                    tid = ev.get("tid")
                    who = threads.get(tid) or f"thread {tid}"
                    self.host.append((ts, ts + dur,
                                      f"{who}: {ev.get('name', '')}"))
        if lo is None:
            raise RuntimeError("the traced slice's marker is missing")
        self.lo, self.hi = lo, hi
        clip = lambda evs: [e for e in evs  # noqa: E731
                            if e["ts"] < hi and e["ts"] + e["dur"] > lo]
        seen = {_correlation(e) for e in self.kernels}
        launched = [e for e in launches if lo <= e["ts"] < hi]
        lost = sum(_correlation(e) not in seen for e in launched)
        self.launches = len(launched)
        self.lost_share = lost / len(launched) if launched else 0.0
        self.kernels, self.copies, self.sets = (
            clip(self.kernels), clip(self.copies), clip(self.sets))
        self.host.sort()

    @property
    def complete(self) -> bool:
        """The profiler kept the kernels of the slice's launches."""
        return self.lost_share <= MAX_LOST

    # --------------------------------------------------------- quantities
    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def device_events(self) -> List[Dict]:
        return self.kernels + self.copies + self.sets

    def intervals(self) -> List[Tuple[float, float]]:
        return [(max(self.lo, e["ts"]), min(self.hi, e["ts"] + e["dur"]))
                for e in self.device_events()]

    @property
    def busy_s(self) -> float:
        return _union(self.intervals()) / 1e6

    def seconds_of(self, events: List[Dict]) -> float:
        return sum(min(self.hi, e["ts"] + e["dur"]) - max(self.lo, e["ts"])
                   for e in events) / 1e6

    # ---------------------------------------------------------- breakdown
    def device_ops(self, top: int = 10) -> List[List]:
        by: Dict[str, float] = {}
        for e in self.device_events():
            by[e["name"]] = by.get(e["name"], 0.0) + e["dur"] / 1e6
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def _host_at(self, t: float) -> Optional[str]:
        """The innermost host call running at ``t``, else the last one
        that ended before it."""
        i = bisect.bisect_right(self.host, (t, float("inf"), ""))
        best = last = None
        for s, e, name in self.host[max(0, i - 4000):i]:
            if s <= t < e and (best is None or e - s < best[0]):
                best = (e - s, name)
            elif e <= t and (last is None or e > last[0]):
                last = (e, name)
        if best:
            return best[1]
        return f"after {last[1]}" if last else None

    def idle_gaps(self, top: int = 10) -> List[List]:
        ivs = sorted(self.intervals())
        gaps, end = [], self.lo
        for s, e in ivs:
            if s > end:
                gaps.append((s - end, end))
            end = max(end, e)
        if self.hi > end:
            gaps.append((self.hi - end, end))
        gaps.sort(reverse=True)
        return [[self._host_at(start + length / 2) or "no host operation",
                 length / 1e6] for length, start in gaps[:top]]
