"""Checks of the program's spans (``avd_tpu_torch/utils/metrics.py``) on
the machine it runs on, one JSON line each:

* ``clock``: a span and the profiler's record of its ``record_function``
  range, laid on the export's clock by ``benchmark/spans.py``'s rule,
  beside the export's own ``baseTimeNanoseconds``;
* ``cost``: ns per span over 10⁵ spans, with no profiler and with one
  recording the thread;
* with ``--cell NAME``, instead: one traced run of a benchmark cell
  (``--seed``, ``--seconds``), its result line, and from its slice: the
  share of the busiest launching thread's launches inside ``vf.enqueue``
  spans (the dispatch thread's, in a serving cell), the threads that
  recorded spans and those that launched (to check that they match), the
  card's idle time by the thread whose launch ended each gap (with the
  span thread that its label matched) and charged to each span name as
  ``benchmark/spans.py`` charges it, spans per frame or per step, and
  their cost as a share of the host's ms per frame or per step.

    python tools/torch_span_check.py [--cell heuristic-c4-1080p --seed N]
        [--device cpu] [--json OUT]
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def clock(device: str) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from avd_tpu_torch.utils import metrics
    from benchmark import spans
    acts = [ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(ProfilerActivity.CUDA)
    x = torch.ones(256, device=device)
    with metrics.span("clock.warm"):
        x.sum().item()
    with profile(activities=acts) as prof:
        for _ in range(3):
            with metrics.span("clock.check"):
                x.sum().item()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    evs = sorted(e["ts"] for e in data["traceEvents"]
                 if e.get("name") == "clock.check" and e.get("ph") == "X")
    recs = [r for r in metrics.SPANS.records() if r.name == "clock.check"]
    recs = recs[-3:]

    class _At:  # a slice opening at the first range, for the rule
        lo = evs[0]

    base = spans.base_ns(_At)
    gaps = [abs((r.start_ns - base) / 1000 - ts) for r, ts in zip(recs, evs)]
    return {"check": "clock", "torch": torch.__version__,
            "export_base_ns": data.get("baseTimeNanoseconds"),
            "rule_base_ns": base,
            "base_agrees": data.get("baseTimeNanoseconds") in (None, base),
            "span_vs_range_us": gaps}


def cost(n: int = 100_000) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from avd_tpu_torch.utils import metrics
    ring = metrics.Spans()

    def loop():
        t = time.perf_counter_ns()
        for _ in range(n):
            with ring.span("cost", frames=1):
                pass
        return (time.perf_counter_ns() - t) / n

    loop()
    off = loop()
    with profile(activities=[ProfilerActivity.CPU]):
        on = loop()
    return {"check": "cost", "ns_per_span": off,
            "ns_per_span_profiled": on}


def launches_inside(trace, name: str, ring=None):
    """The clock's check on a slice: of the launches of the thread that
    launched most in it, the share (%) that fall inside a span ``name``
    as laid."""
    from benchmark import spans
    laid = spans.laid(trace, ring)
    if laid is None:
        return None
    by = {}
    for s, _, who in trace.host:
        thread, _, call = who.rpartition(": ")
        if call.startswith(("cudaLaunch", "cuLaunch")):
            by.setdefault(thread, []).append(s)
    if not by:
        return None
    thread, starts = max(by.items(), key=lambda kv: len(kv[1]))
    inside = spans._merged((s, e) for s, e, r in laid if r.name == name)
    opens = [s for s, _ in inside]
    n_in = 0
    for t in starts:
        i = bisect.bisect_right(opens, t) - 1
        n_in += i >= 0 and t < inside[i][1]
    return {"thread": thread, "launches": len(starts),
            "inside_pct": 100.0 * n_in / len(starts)}


def idle_ended_by(trace, laid) -> dict:
    """Per thread label, the share (%) of the slice's idle time in gaps
    that its launch ended, and the span thread whose ids its label
    holds."""
    from benchmark import spans
    names = {}
    for _, _, r in laid:
        for k in (spans.id32(r.ident), spans.id32(r.tid)):
            names[k] = r.thread
    gaps = spans.idle(trace)
    total = sum(e - s for s, e in gaps) or 1.0
    starts, threads = spans._enders(trace)
    by = {}
    for g0, g1 in gaps:
        i = bisect.bisect_left(starts, g1) - 1
        label = ("the slice's end" if g1 >= trace.hi
                 else threads[i] if i >= 0 else "no launch")
        by[label] = by.get(label, 0.0) + 100.0 * (g1 - g0) / total
    return {label: {"idle_pct": pct, "span_thread": next(
        (names[k] for k in spans._keys(label) if k in names), None)}
        for label, pct in sorted(by.items(), key=lambda kv: -kv[1])[:8]}


def cell(name: str, seed: int, seconds: float, device: str) -> dict:
    """One traced run of ``name`` through ``benchmark.run.execute``, with
    the ``Run`` that the cell's traffic module returns kept, to read its
    slice."""
    from benchmark import run as run_mod
    from benchmark import spans
    from benchmark import spec

    kept = {}
    find = spec.driver

    def driver(kind):
        mod = find(kind)

        class Kept:
            @staticmethod
            def run(ctx):
                kept["run"] = mod.run(ctx)
                return kept["run"]
        return Kept

    spec.driver = driver
    try:
        out = run_mod.execute(name, seed, seconds, True, device=device)
    finally:
        spec.driver = find
    from avd_tpu_torch.utils import metrics
    trace = kept["run"].trace
    res = {"check": "cell", "cell": name, "seed": seed, "result": out}
    laid = spans.laid(trace)
    if laid is None:
        res["spans"] = None
        return res
    inside = [r for _, e, r in laid if trace.lo <= e <= trace.hi]
    res["launches_in_enqueue"] = launches_inside(trace, "vf.enqueue")
    res["spans_in_slice"] = len(inside)
    res["idle_ended_by"] = idle_ended_by(trace, laid)
    res["span_threads"] = sorted({(r.thread, spans.id32(r.ident), r.tid)
                                  for _, _, r in laid})
    starts, threads = spans._enders(trace)
    calls = {}
    for t, label in zip(starts, threads):
        if trace.lo <= t <= trace.hi:
            calls[label] = calls.get(label, 0) + 1
    res["launch_threads"] = calls
    names = sorted({r.name for _, _, r in laid})
    res["idle_pct_charged"] = {n: spans.idle_charged(trace, (n,))
                               for n in names}
    res["idle_pct_charged"]["any"] = spans.idle_charged(trace, tuple(names))
    per = metrics.SPANS.totals()
    res["spans_per_name"] = {k: v["count"] for k, v in per.items()}
    ns = cost(20_000)["ns_per_span"]
    frames = sum(r.attrs.get("frames", 0) for r in inside
                 if r.name == "vf.host_prep")
    steps = [r for r in inside if r.name == "train.step"]
    if frames:
        enq = [r for r in inside if r.name == "vf.enqueue"]
        host_ms = (sum(r.end_ns - r.start_ns for r in inside
                       if r.name == "vf.host_prep")
                   + sum(r.end_ns - r.start_ns for r in enq)) / 1e6 / frames
        res["spans_per_frame"] = len(inside) / frames
        res["host_ms_per_frame"] = host_ms
        res["span_cost_pct"] = 100 * (len(inside) / frames) * ns / 1e6 \
            / host_ms
    elif steps:
        host_ms = sum(r.end_ns - r.start_ns for r in steps) / 1e6 / len(steps)
        res["spans_per_step"] = len(inside) / len(steps)
        res["host_ms_per_step"] = host_ms
        res["span_cost_pct"] = 100 * (len(inside) / len(steps)) * ns / 1e6 \
            / host_ms
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/torch_span_check.py")
    ap.add_argument("--cell", default=None)
    ap.add_argument("--seed", type=int, default=2 ** 31 + 19)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    if args.cell:
        lines = [cell(args.cell, args.seed, args.seconds, args.device)]
    else:
        lines = [clock(args.device), cost()]
    for ln in lines:
        print(json.dumps(ln), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
