"""The operation and byte counts at known shapes, and the reductions from
a trace to per-layer metrics."""

from __future__ import annotations

import math

import pytest

from benchmark import readers
from benchmark.roofline import (blur_solve, flow_iter, flow_round, peaks,
                                vit_forward, warp)
from benchmark import trace as trace_mod
from benchmark.trace import SLICE, Trace


def test_kernel_bytes_per_pixel():
    px = 48 * 320 * 320
    assert warp.bytes_moved(48, 320, 320) == 48 * px
    assert warp.bytes_moved(48, 320, 320, src_bytes=2) == 38 * px
    assert blur_solve.bytes_moved(48, 320, 320) == 28 * px
    assert blur_solve.bytes_moved(48, 320, 320, m_bytes=2) == 18 * px
    assert flow_iter.least_s(48, 320, 320) == pytest.approx(
        56 * px / peaks.HBM_BYTES_PER_S)
    # a full window of 4 levels x 3 rounds: PERF.md's 0.281 and 0.164 ms
    win = sum(3 * warp.least_s(48, s, s) for s in flow_round.LEVELS)
    assert win * 1e3 == pytest.approx(0.281, abs=0.002)
    win = sum(3 * blur_solve.least_s(48, s, s) for s in flow_round.LEVELS)
    assert win * 1e3 == pytest.approx(0.164, abs=0.002)


def test_flow_work_per_frame():
    assert flow_round.level_px() == 320 ** 2 + 160 ** 2 + 80 ** 2 + 40 ** 2
    assert flow_round.least_s(1, 1) * 1e6 == pytest.approx(7.79, abs=0.01)
    assert flow_round.least_s(10, 9) == pytest.approx(
        10 * flow_round.least_s(1, 0) + 9 * flow_round.least_s(0, 1))


def test_vit_flops():
    assert vit_forward.flops() / 1e9 == pytest.approx(4.656, abs=0.001)
    assert vit_forward.train_step_flops(64) == 3 * 64 * vit_forward.flops()
    # the attention term grows with the square of the tokens
    small = vit_forward.flops(image_size=64, width=256, heads=4, mlp=1024,
                              depth=4)
    assert 0 < small < vit_forward.flops()


def _kernel(name, ts, dur, grid, stream=7):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur,
            "args": {"grid": grid, "stream": stream}}


def _trace(events, work=None):
    mark = {"ph": "X", "cat": "user_annotation", "name": SLICE, "ts": 0.0,
            "dur": 1000.0}
    return Trace([mark] + events, work or {})


def test_flow_kernels_roofline_from_grids():
    b, s = 48, 320
    evs = [_kernel("void warp_bilinear_kernel<float>(...)", 10, 100,
                   [warp.grid_blocks(b, s, s), 1, 1]),
           _kernel("at::native::mul", 120, 5, [1, 1, 1]),
           _kernel("void blur_solve_kernel<40, 5>(...)", 130, 50,
                   [math.ceil(s / 32), 8, b])]
    share = readers.flow_kernels_roofline(_trace(evs))
    least = warp.least_s(b, s, s) + blur_solve.least_s(b, s, s)
    assert share == pytest.approx(100 * least / 150e-6)
    # a warp whose grid does not match the next blur+solve is left out
    evs[0]["args"]["grid"] = [7, 1, 1]
    share = readers.flow_kernels_roofline(_trace(evs))
    assert share == pytest.approx(100 * blur_solve.least_s(b, s, s) / 50e-6)


def test_slice_quantities_and_breakdown():
    evs = [_kernel("a", 100, 100, [1, 1, 1]),
           _kernel("b", 150, 100, [1, 1, 1]),
           {"ph": "X", "cat": "gpu_memcpy",
            "name": "Memcpy HtoD (Pageable -> Device)",
            "ts": 600, "dur": 200},
           {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
            "ts": 260, "dur": 300, "tid": 5}]
    t = _trace(evs, {"frames": 10})
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(350e-6)
    assert readers.idle_percent(t) == pytest.approx(65.0)
    assert readers.per(t, 1e3 * readers.pageable_h2d_s(t), "frames") == \
        pytest.approx(0.02)
    gaps = t.idle_gaps()
    assert gaps[0][1] == pytest.approx(350e-6)
    assert "cudaStreamSynchronize" in gaps[0][0]
    assert t.device_ops()[0] == ["Memcpy HtoD (Pageable -> Device)", 2e-4]


def test_no_device_events_reads_nothing():
    t = _trace([], {"frames": 10, "pairs": 9})
    for fn in (readers.idle_percent, readers.flow_kernels_roofline,
               readers.flow_mfu):
        assert fn(t) is None


def _launch(ts, corr, tid=3):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 2.0, "tid": tid, "args": {"correlation": corr}}


def test_a_slice_that_lost_a_threads_kernels_reads_nothing():
    """The profiler kept a thread's launches and none of their kernels:
    the slice is not complete, and no device number is read from it."""
    kept = [_kernel("a", 100 + 10 * i, 5, [1, 1, 1]) for i in range(20)]
    for i, e in enumerate(kept):
        e["args"]["correlation"] = i
    launches = [_launch(90 + 10 * i, i) for i in range(20)]
    t = _trace(kept + launches, {"frames": 10})
    assert t.launches == 20 and t.lost_share == 0.0 and t.complete
    assert readers.idle_percent(t) is not None
    lost = [_launch(95 + 10 * i, 100 + i, tid=4) for i in range(20)]
    t = _trace(kept + launches + lost, {"frames": 10})
    assert t.lost_share == pytest.approx(0.5) and not t.complete
    for fn in (readers.idle_percent, readers.flow_kernels_roofline,
               readers.flow_mfu):
        assert fn(t) is None
    # a few launches at the close whose kernels were not kept are sound
    t = _trace(kept + launches + lost[:1], {"frames": 10})
    assert t.complete


class _FakeSlice:
    """Stands in for the profiler: each slice digests to the next trace
    of ``traces``."""

    def __init__(self, traces, log):
        self.traces, self.log = traces, log
        self.t0 = self.t1 = None

    def start(self):
        self.log.append("start")

    def open(self):
        self.t0 = trace_mod.time.perf_counter()
        self.log.append("open")

    def stop(self):
        self.t1 = trace_mod.time.perf_counter()
        self.log.append("stop")

    def abandon(self):
        self.log.append("abandon")

    def digest(self, work=None):
        return self.traces.pop(0)


def _drive(monkeypatch, traces, seconds):
    log = []
    monkeypatch.setattr(trace_mod, "Slice",
                        lambda: _FakeSlice(traces, log))
    monkeypatch.setattr(trace_mod, "WARM_S", 0.01)
    t = trace_mod.time.perf_counter()
    sl = trace_mod.Slicer(t + 0.02, 0.02, t + seconds, lambda m: None)
    sl.begin()
    n = 0
    while not sl.done:
        trace_mod.time.sleep(min(sl.poll(trace_mod.time.perf_counter(), n),
                                 0.005))
        n += 1
    return sl, log


def test_the_slicer_takes_another_slice_where_one_lost_kernels(
        monkeypatch):
    good = _trace([_kernel("a", 100, 5, [1, 1, 1])])
    bad = _trace([_launch(90, 7)])
    assert not bad.complete
    sl, log = _drive(monkeypatch, [bad, good], 5.0)
    assert sl.trace is good and sl.tries == [1.0, 0.0]
    assert log == ["start", "open", "stop", "start", "open", "stop"]
    assert sl.counts[1] > sl.counts[0]
    # no room for a second slice: the first stands, and reads nothing
    sl, log = _drive(monkeypatch, [bad, good], 0.05)
    assert sl.trace is bad and log[-1] == "abandon"


def test_card_time_over_the_window_and_its_drain():
    """Busy seconds are the union of the card's intervals inside the
    window; a session whose records stopped, or that lost a thread's
    kernels, is not complete and gives no card time."""
    b = trace_mod.Busy(expect=2)
    ms = 1_000_000
    device = [(0, 10 * ms, True), (5 * ms, 20 * ms, False),
              (40 * ms, 50 * ms, True), (990 * ms, 1010 * ms, False)]
    launches = [(i * 10 * ms, i) for i in range(100)]
    b.reduce(0, 1000 * ms, device, launches, set(range(100)))
    assert b.busy_s == pytest.approx(0.040) and b.span_s == 1.0
    assert b.launches == 100 and b.lost_share == 0 and b.complete
    # the program launched more of its own kernels than were recorded
    b.expect = 3
    assert not b.complete
    b.expect = 2
    run = type("R", (), {"data": {"card_busy_s": b.busy_s,
                                  "frames_sent": 20}})()
    assert readers.card_ms_per_frame(run) == pytest.approx(2.0)
    b.reduce(0, 1000 * ms, device, launches, set(range(50)))
    assert b.lost_share == 0.5 and not b.complete
    late = 20_000 * ms  # launches stop 19 s before the close
    b.reduce(0, late, device, launches, set(range(100)))
    assert b.gap_s > trace_mod.MAX_GAP_S and not b.complete
    run.data["card_busy_s"] = None
    assert readers.card_ms_per_frame(run) is None
