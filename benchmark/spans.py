"""The program's own spans (``avd_tpu_torch.utils.metrics``) laid over a
traced slice, for the readers of the per-layer metrics that time the host
path where its work happens.

The program stamps a span with ``time.time_ns()``, the clock on which
``torch.profiler`` (kineto) stamps its events.  The Chrome export writes
an event's ``ts`` as (ns − base) / 1000 µs, where the base is a session's
start rounded down to a multiple of ``PERIOD_S`` (kineto's rule, stated in
``torch/profiler/_cupti_monitor_trace.py``).  ``Trace`` keeps the events
and not the base, so the base is found again: the multiple of the period
at or below (now − the slice's opening), which the slice's opening and
the reading minutes later cannot straddle.

A reader here returns None unless the slice recorded the device's work
(``readers.traced``), the program records spans (a program without them
has nothing to read) and its ring still reaches back before the slice: a
slice that the ring no longer covers gives no number, not a wrong one.
"""

from __future__ import annotations

import bisect
import re
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from .readers import traced

PERIOD_S = 7889238  # kineto's "trimester": a trace's base is a multiple


def program_ring():
    """The program's ring of spans, or None where it keeps none."""
    try:
        from avd_tpu_torch.utils.metrics import SPANS
    except ImportError:
        return None
    return SPANS


def base_ns(trace, now_ns: Optional[int] = None) -> int:
    """The epoch ns at ``ts`` 0 of the slice's export."""
    period = PERIOD_S * 10 ** 9
    now = time.time_ns() if now_ns is None else now_ns
    return (now - int(trace.lo * 1000)) // period * period


def laid(trace, ring=None) -> Optional[List[Tuple[float, float, object]]]:
    """(start µs, end µs, record) of every span that overlaps the slice,
    on the slice's clock, oldest end first; None as the module says."""
    if not traced(trace):
        return None
    ring = ring if ring is not None else program_ring()
    if ring is None:
        return None
    base = base_ns(trace)
    lo_ns = base + int(trace.lo * 1000)
    oldest = ring.oldest_start_ns()
    if oldest is None or oldest >= lo_ns:
        return None
    hi_ns = base + int(trace.hi * 1000)
    return [((r.start_ns - base) / 1000, (r.end_ns - base) / 1000, r)
            for r in ring.between(lo_ns, 2 ** 63) if r.start_ns < hi_ns]


def ended(trace, name: str, ring=None) -> Optional[List[object]]:
    """The records of span ``name`` that ended inside the slice; None as
    ``laid``, and where there is none."""
    spans = laid(trace, ring)
    if spans is None:
        return None
    out = [r for _, e, r in spans if r.name == name
           and trace.lo <= e <= trace.hi]
    return out or None


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def ms_per(trace, name: str, attr: Optional[str] = None,
           ring=None) -> Optional[float]:
    """Σ ms of the spans ``name`` that ended in the slice ÷ Σ their
    attribute ``attr`` (frames), or ÷ their count (a mean)."""
    recs = ended(trace, name, ring)
    if recs is None:
        return None
    n = sum(r.attrs.get(attr, 0) for r in recs) if attr else len(recs)
    return sum(_ms(r) for r in recs) / n if n else None


def share(trace, name: str, part: Callable[[Dict], float],
          whole: Callable[[Dict], float], ring=None) -> Optional[float]:
    """100 × Σ ``part`` ÷ Σ ``whole`` of the attributes of the spans
    ``name`` that ended in the slice."""
    recs = ended(trace, name, ring)
    if recs is None:
        return None
    total = sum(whole(r.attrs) for r in recs)
    return 100.0 * sum(part(r.attrs) for r in recs) / total if total else None


def _merged(ivs: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for s, e in sorted(ivs):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return out


def idle(trace) -> List[List[float]]:
    """The slice's idle intervals (µs): the slice less the union of the
    card's kernels, copies and sets."""
    out, t = [], trace.lo
    for s, e in _merged(trace.intervals()):
        if s > t:
            out.append([t, s])
        t = max(t, e)
    if trace.hi > t:
        out.append([t, trace.hi])
    return out


_LAUNCH = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cuMemcpy", "cudaMemset",
           "cuMemset")


def id32(x: int) -> int:
    """A thread id as a trace's label shows it: cut to a signed 32-bit
    integer, without its sign.  CUDA runtime calls carry a thread's
    ``get_ident()`` so (``thread 1711278400`` for an ident whose low 32
    bits read 2583688896), operators its native id."""
    x &= 0xFFFFFFFF
    return 2 ** 32 - x if x >= 2 ** 31 else x


def _keys(label: str) -> List[int]:
    """The numbers in a trace's thread label, as ``id32`` gives them."""
    return [id32(int(m)) for m in re.findall(r"-?\d+", label)]


def _enders(trace) -> Tuple[List[float], List[str]]:
    """Start (µs) and thread label of every launch, copy and set call."""
    starts, threads = [], []
    for s, _, who in trace.host:
        thread, _, call = who.rpartition(": ")
        if call.startswith(_LAUNCH):
            starts.append(s)
            threads.append(thread)
    return starts, threads


def idle_charged(trace, names: Tuple[str, ...],
                 ring=None) -> Optional[float]:
    """Of the card's idle time in the slice, the share (%) that the
    thread which ended each gap spent inside a span of one of ``names``.

    A gap ends when the card starts its next operation, issued by the
    last launch, copy or set call that began before the gap's end; the
    gap is charged to that call's thread, for as long as that thread had
    a span of ``names`` open during the gap.  So a thread busy launching
    inside ``vf.enqueue`` while the card waits is charged; one that
    waited for work (its queue empty) is not, and nor is a gap that ends
    the slice or that no launch of a known thread ends."""
    spans = laid(trace, ring)
    if spans is None:
        return None
    gaps = idle(trace)
    total = sum(e - s for s, e in gaps)
    if total <= 0:
        return None
    mine: Dict[int, List] = {}
    for s, e, r in spans:
        if r.name in names:
            for k in {id32(r.ident), id32(r.tid)}:
                mine.setdefault(k, []).append((s, e))
    mine = {k: _merged(v) for k, v in mine.items()}
    opens = {k: [s for s, _ in v] for k, v in mine.items()}
    starts, threads = _enders(trace)
    charged = 0.0
    for g0, g1 in gaps:
        i = bisect.bisect_left(starts, g1) - 1
        if g1 >= trace.hi or i < 0:
            continue
        for k in _keys(threads[i]):
            if k in mine:
                ivs = mine[k]
                j = max(0, bisect.bisect_right(opens[k], g0) - 1)
                while j < len(ivs) and ivs[j][0] < g1:
                    charged += max(0.0, min(g1, ivs[j][1])
                                   - max(g0, ivs[j][0]))
                    j += 1
                break
    return 100.0 * charged / total
