"""The readers of the program's spans (``benchmark/spans.py`` and the
thirteen ``metrics/`` files that use it) on a hand-built slice and a
hand-built ring: each gives its known answer, and None on a CPU slice,
on a ring that no longer reaches back to the slice, and where the program
keeps no spans."""

from __future__ import annotations

import threading
import time

import pytest

from avd_tpu_torch.utils import metrics
from benchmark import spans, spec
from benchmark.trace import SLICE, Trace

PERIOD = spans.PERIOD_S * 10 ** 9
T0 = 5_000_000.0  # the slice's opening, µs on the export's clock
ME = spans.id32(threading.get_ident())  # this thread, as a trace names it


def _base():
    return time.time_ns() // PERIOD * PERIOD


def _trace(kernels=((0, 400), (600, 1000)), launches=((598, ME),)):
    """A 1 ms slice at ``T0``: kernels at the given µs offsets and CUDA
    launch calls ``(offset, tid)``, each with a kernel of its
    correlation; by default this thread's launch ends the one gap."""
    evs = [{"ph": "X", "cat": "user_annotation", "name": SLICE, "ts": T0,
            "dur": 1000.0, "tid": 1}]
    for i, (s, e) in enumerate(kernels):
        evs.append({"ph": "X", "cat": "kernel", "name": f"k{i}",
                    "ts": T0 + s, "dur": float(e - s),
                    "args": {"correlation": i}})
    for j, (t, tid) in enumerate(launches):
        c = 100 + j
        evs.append({"ph": "X", "cat": "cuda_runtime",
                    "name": "cudaLaunchKernel", "ts": T0 + t, "dur": 2.0,
                    "tid": tid, "args": {"correlation": c}})
        evs.append({"ph": "X", "cat": "kernel", "name": "late",
                    "ts": T0 + 999, "dur": 0.5, "args": {"correlation": c}})
    return Trace(evs, {})


def _ring(capacity=1024):
    """The program's spans around the slice, by µs offset from ``T0``."""
    base = _base()
    ring = metrics.Spans(capacity)

    def add(name, s, e, **attrs):
        ring.record(name, base + int((T0 + s) * 1000),
                    base + int((T0 + e) * 1000), **attrs)

    add("vf.queued", -100, 450)
    add("vf.enqueue", 450, 550, frames=49, pad=0)
    add("vf.host_prep", -2900, 100, frames=30)
    add("det.resize", 100, 400, frames=30)
    add("det.stage", 400, 500, frames=30, bucket=32)
    add("det.forward", 500, 560, frames=30)
    add("vf.queued", 600, 700)
    add("train.forward", 0, 200)
    add("train.backward", 200, 600)
    add("train.optim", 600, 700)
    add("vf.enqueue", 700, 900, frames=37, pad=6)
    add("vf.host_prep", 800, 1500, frames=40)  # ends after the slice
    add("analyze", -5000, 2000)
    return ring


EXPECTED = {
    "host_prep_ms_per_frame.heur": 3.0 / 30,
    "enqueue_ms_per_window.heur": (0.1 + 0.2) / 2,
    "dispatch_wait_ms_per_window.heur": (0.55 + 0.1) / 2,
    "window_pad_pct.heur": 100 * 6 / 86,
    # the one idle gap, 400-600 µs, ended by this thread's launch and
    # half covered by its first enqueue
    "idle_in_enqueue_pct.heur": 50.0,
    "det_resize_ms_per_frame": 0.3 / 30,
    "det_stage_ms_per_frame": 0.1 / 30,
    "det_submit_ms_per_frame": 0.06 / 30,
    "det_pad_pct": 100 * 2 / 32,
    # resize, stage and forward together hold 400-560 of the gap
    "idle_in_det_prep_pct": 80.0,
    "train_forward_host_ms_per_step": 0.2,
    "train_backward_host_ms_per_step": 0.4,
    "train_optim_host_ms_per_step": 0.1,
}


def test_the_thirteen_readers_are_the_spans_entries():
    s = spec.load()
    names = {m["name"] for m in s["per_layer"]}
    assert set(EXPECTED) <= names
    for m in s["per_layer"]:
        if m["name"] in EXPECTED:
            assert len(m["workloads"]) == 1


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_gives_its_known_answer(monkeypatch, name):
    ring = _ring()
    monkeypatch.setattr(spans, "program_ring", lambda: ring)
    got = spec.reader(name)(None, _trace())
    assert got == pytest.approx(EXPECTED[name], rel=1e-6, abs=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_reader_reads_nothing_it_cannot_trust(monkeypatch, name):
    read = spec.reader(name)
    # a CPU slice: no device event
    monkeypatch.setattr(spans, "program_ring", lambda: _ring())
    assert read(None, _trace(kernels=(), launches=())) is None
    assert read(None, None) is None
    # a ring that no longer reaches back before the slice
    short = _ring(capacity=4)
    assert short.oldest_start_ns() > _base() + int(T0 * 1000)
    monkeypatch.setattr(spans, "program_ring", lambda: short)
    assert read(None, _trace()) is None
    # a program that keeps no spans
    monkeypatch.setattr(spans, "program_ring", lambda: None)
    assert read(None, _trace()) is None


def test_the_base_is_the_period_below_the_slice():
    trace = _trace()
    assert spans.base_ns(trace) == _base()
    now = _base() + int(T0 * 1000) + 30 * 10 ** 9  # read 30 s later
    assert spans.base_ns(trace, now) == _base()


def _recorded_on(name, ring, *args, **attrs):
    """``ring.record(*args)`` made on a new thread ``name``; its ids."""
    ids = {}

    def work():
        ring.record(*args, **attrs)
        ids.update(ident=threading.get_ident(),
                   tid=threading.get_native_id())
    t = threading.Thread(target=work, name=name)
    t.start()
    t.join(30)
    return ids


@pytest.mark.parametrize("ender", ["ident", "tid", "other", "none"])
def test_an_idle_gap_is_charged_to_the_thread_that_ends_it(ender):
    """The 400-600 µs gap, with an enqueue open on a dispatch thread over
    450-550 and on this thread over 400-600: charged for the dispatch
    thread's 100 µs when its launch, named by either id, ends the gap;
    for nothing when an unknown thread's does or no launch does."""
    base = _base()
    ring = metrics.Spans()
    at = lambda us: base + int((T0 + us) * 1000)  # noqa: E731
    ring.record("analyze", at(-5000), at(2000))
    ids = _recorded_on("avd-dispatch", ring, "vf.enqueue", at(450),
                       at(550), frames=49, pad=0)
    busy = metrics.Spans()  # a second ring: this thread inside enqueue
    busy.record("analyze", at(-5000), at(2000))
    busy.record("vf.enqueue", at(400), at(600))
    tid = {"ident": ids["ident"], "tid": ids["tid"], "other": 424242,
           "none": None}[ender]
    trace = _trace(launches=() if tid is None else ((598, tid),))
    got = spans.idle_charged(trace, ("vf.enqueue",), ring=ring)
    assert got == pytest.approx(50.0 if ender in ("ident", "tid") else 0.0)
    # this thread's enqueue over the whole gap is not the ender's
    if ender in ("ident", "tid"):
        assert spans.idle_charged(trace, ("vf.enqueue",), ring=busy) == 0.0


class _Stub:
    """A ring of the given records."""

    def __init__(self, recs):
        self.recs = recs

    def oldest_start_ns(self):
        return min(r.start_ns for r in self.recs)

    def between(self, t0, t1):
        return [r for r in self.recs if t0 <= r.end_ns <= t1]


@pytest.mark.parametrize("label", ["1711278400", "-1711278400"])
def test_a_thread_whose_ident_reads_negative_in_32_bits_is_matched(label):
    """A thread whose ``get_ident()`` has bit 31 set: the trace names it
    by that id cut to a signed 32-bit integer, unsigned or not."""
    ident = (0x7F12 << 32) | 2583688896  # low 32 bits read -1711278400
    assert spans.id32(ident) == spans.id32(int(label)) == 1711278400
    assert spans.id32(4977) == 4977
    base = _base()
    at = lambda us: base + int((T0 + us) * 1000)  # noqa: E731
    recs = [metrics.SpanRecord("analyze", 1, 1, 0, "bench-client-0", 7, 7,
                               at(-5000), at(2000), {}),
            metrics.SpanRecord("vf.enqueue", 1, 2, 1, "avd-dispatch", ident,
                               330, at(450), at(550), {})]
    evs = [{"ph": "X", "cat": "user_annotation", "name": SLICE, "ts": T0,
            "dur": 1000.0, "tid": 1},
           {"ph": "X", "cat": "kernel", "name": "k", "ts": T0, "dur": 400.0,
            "args": {"correlation": 0}},
           {"ph": "X", "cat": "kernel", "name": "k", "ts": T0 + 600,
            "dur": 400.0, "args": {"correlation": 1}},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": T0 + 598, "dur": 2.0, "tid": int(label),
            "args": {"correlation": 1}}]
    got = spans.idle_charged(Trace(evs, {}), ("vf.enqueue",),
                             ring=_Stub(recs))
    assert got == pytest.approx(50.0)

