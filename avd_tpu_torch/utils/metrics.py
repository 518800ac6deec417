"""Process counters, and the spans that time the port's stages.

* ``COUNTERS``: process-wide counters (requests, frames analyzed,
  analyzed-frames/sec), the port's copy of ``avd_tpu/utils/metrics.py``'s.
* ``span(name, **attrs)``: a context manager that times one stage of the
  program on ``time.time_ns()``, the clock that ``torch.profiler``
  (kineto) stamps its events with, so that spans lie on a profiler
  trace's timeline.  Each span records its name, request id, parent,
  thread, start, end and small integer attributes (``frames``, ``pad``,
  ``bucket``) into ``SPANS``, one process-wide ring of ``CAPACITY``
  records, and adds to per-name totals (count, seconds, summed
  attributes).  A span opened where none is open on its thread is a root
  and opens a request id (its own span id); spans opened inside it on the
  same thread inherit it.  Work handed to another thread carries
  ``current()`` there and passes it as ``parent`` (``in_span``,
  ``record``).
* Each span also enters a ``record_function`` range of its name, so a
  profiler that records the thread (``/debug/trace``, the benchmark's
  sessions) shows the program's stages among the operators.

Spans are taken at stage granularity (a request, chunk, window, detector
batch or training step), never per torch call: about a microsecond each.
``/metrics`` reads the totals (``SPANS.flat()``); ``AVD_PROFILE=1``
attaches a request's stages from its spans (``SPANS.stage_ms``); the
benchmark reads the ring (``between``, ``oldest_start_ns``).
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import defaultdict
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from torch._C._profiler import _RecordFunctionFast


class Counters:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._values: Dict[str, float] = defaultdict(float)
        self._started = time.time()

    def inc(self, name: str, amount: float = 1.0) -> None:
        with self._lock:
            self._values[name] += amount

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            out = dict(self._values)
        uptime = max(1e-9, time.time() - self._started)
        out["uptime_s"] = round(uptime, 3)
        if "frames_analyzed" in out:
            out["frames_per_sec_lifetime"] = round(
                out["frames_analyzed"] / uptime, 3)
        return out


COUNTERS = Counters()

CAPACITY = 65536  # records; the benchmark's cells make under 300 a second

Context = Tuple[int, int]  # (request id, span id) of an open span


class SpanRecord(NamedTuple):
    """One span.  A profiler trace names a thread by its ``ident`` cut to
    32 bits (CUDA runtime calls) or by its ``tid``; the benchmark matches
    either (``benchmark/spans.py``)."""
    name: str
    request: int
    span: int
    parent: int          # the parent's span id; 0 for a root
    thread: str
    ident: int           # threading.get_ident()
    tid: int             # threading.get_native_id()
    start_ns: int        # time.time_ns()
    end_ns: int
    attrs: Dict[str, int]


class _Span:
    __slots__ = ("_owner", "name", "attrs", "parent", "ctx", "start_ns",
                 "first", "_prev", "_rf")

    def __init__(self, owner: "Spans", name: str, parent: Optional[Context],
                 attrs: Dict[str, int]):
        self._owner, self.name, self.parent, self.attrs = (owner, name,
                                                           parent, attrs)

    def __enter__(self) -> "_Span":
        owner = self._owner
        local = owner._local
        try:
            self._prev = local.top
        except AttributeError:
            self._prev = None
        self.parent = self.parent or self._prev
        sid = next(owner._ids)
        self.ctx = (self.parent[0] if self.parent else sid, sid)
        local.top = self.ctx
        self.first = owner._n  # the ring's index of the next record
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.time_ns()
        self._rf.__exit__(None, None, None)
        self._owner._local.top = self._prev
        self._owner._add(self.name, self.ctx, self.parent, self.start_ns,
                         end, self.attrs)
        return False


class Spans:
    """The ring of span records and the per-name totals; ``SPANS`` is the
    process's."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: List[Optional[tuple]] = [None] * capacity
        self._n = 0  # records ever added
        self._totals: Dict[str, List] = {}  # name → [count, ns, {attr: Σ}]
        self._ids = itertools.count(1)
        self._local = threading.local()

    # ------------------------------------------------------------ writing
    def span(self, name: str, parent: Optional[Context] = None,
             **attrs: int) -> _Span:
        """Time the ``with`` block as span ``name``; ``parent`` (a
        ``current()`` taken on another thread) where the work was handed
        over, else the span open on this thread, if any."""
        return _Span(self, name, parent, attrs)

    def record(self, name: str, start_ns: int, end_ns: int,
               parent: Optional[Context] = None, **attrs: int) -> None:
        """Add a span whose times were taken elsewhere (a wait that began
        on another thread); no ``record_function`` range."""
        parent = parent or self.current()
        self._add(name, self._open(parent), parent, start_ns, end_ns, attrs)

    def current(self) -> Optional[Context]:
        """The span open on this thread, to hand to another thread."""
        return getattr(self._local, "top", None)

    def in_span(self, name: str, fn):
        """``fn``, to run on another thread inside span ``name`` whose
        parent is the span open here."""
        parent = self.current()

        def run(*args, **kwargs):
            with self.span(name, parent=parent):
                return fn(*args, **kwargs)
        return run

    def _open(self, parent: Optional[Context]) -> Context:
        sid = next(self._ids)
        return (parent[0] if parent else sid, sid)

    def _add(self, name, ctx, parent, start_ns, end_ns, attrs) -> None:
        local = self._local
        try:
            who = local.who
        except AttributeError:
            who = local.who = (threading.current_thread().name,
                               threading.get_ident(),
                               threading.get_native_id())
        # a plain tuple here (a NamedTuple costs several times as much to
        # make); ``records`` hands out SpanRecords
        rec = (name, ctx[0], ctx[1], parent[1] if parent else 0, *who,
               start_ns, end_ns, attrs)
        with self._lock:
            self._ring[self._n % self.capacity] = rec
            self._n += 1
            tot = self._totals.get(name)
            if tot is None:
                tot = self._totals[name] = [0, 0, {}]
            tot[0] += 1
            tot[1] += end_ns - start_ns
            for k, v in attrs.items():
                tot[2][k] = tot[2].get(k, 0) + v

    # ------------------------------------------------------------ reading
    def records(self) -> List[SpanRecord]:
        """Every record in the ring, oldest first."""
        with self._lock:
            n, cap = self._n, self.capacity
            if n > cap:
                recs = self._ring[n % cap:] + self._ring[:n % cap]
            else:
                recs = self._ring[:n]
        return [SpanRecord._make(r) for r in recs]

    def between(self, t0_ns: int, t1_ns: int) -> List[SpanRecord]:
        """The spans that ended in [t0_ns, t1_ns]."""
        return [r for r in self.records() if t0_ns <= r.end_ns <= t1_ns]

    def oldest_start_ns(self) -> Optional[int]:
        """The start of the oldest record still in the ring: spans that
        ended before it may have been overwritten."""
        with self._lock:
            if not self._n:
                return None
            return SpanRecord._make(self._ring[
                self._n % self.capacity if self._n > self.capacity
                else 0]).start_ns

    def stage_ms(self, root: _Span) -> Dict[str, float]:
        """Milliseconds of the children of ``root``, a span still open,
        summed by name, in the order they first ended: the records added
        since ``root`` opened, whatever their threads' clocks read."""
        with self._lock:
            n, cap = self._n, self.capacity
            kids = [self._ring[i % cap]
                    for i in range(max(root.first, n - cap), n)]
        out: Dict[str, float] = {}
        for r in map(SpanRecord._make, kids):
            if r.parent == root.ctx[1]:
                out[r.name] = out.get(r.name, 0.0) \
                    + (r.end_ns - r.start_ns) / 1e6
        return {k: round(v, 2) for k, v in out.items()}

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Per name: ``count``, ``seconds`` and each attribute's sum."""
        with self._lock:
            return {name: {"count": c, "seconds": ns / 1e9, **dict(a)}
                    for name, (c, ns, a) in self._totals.items()}

    def flat(self) -> Dict[str, float]:
        """``span_<name>_count``, ``span_<name>_seconds`` and, for each
        attribute, ``span_<name>_<attr>_total`` of every span name (dots
        as underscores), for ``/metrics``: the ratio of two such sums (say
        ``pad`` to ``frames`` of ``vf.enqueue``) is a live share."""
        out: Dict[str, float] = {}
        for name, t in self.totals().items():
            key = "span_" + name.replace(".", "_")
            out[key + "_count"] = t.pop("count")
            out[key + "_seconds"] = round(t.pop("seconds"), 6)
            for attr, total in t.items():
                out[f"{key}_{attr}_total"] = total
        return out


SPANS = Spans()
span = SPANS.span
record = SPANS.record
current = SPANS.current
in_span = SPANS.in_span
