"""The port's spans and counters (``avd_tpu_torch/utils/metrics.py``):
nesting, request ids and parents (across the dispatch thread too), the
ring's bound and its oldest start, the totals and ``/metrics``' keys, the
stages that the benchmark reads (``vf.*``, ``det.*``, ``train.*``),
``AVD_PROFILE``'s ``profile`` from a request's spans, a client thread's
span in ``/debug/trace``'s Chrome trace, and the clock: a span and a
``record_function`` entered together land within 100 µs of each other
once ``benchmark/spans.py`` lays the span on the profiler export's clock.
"""

import http.client
import json
import sys
import threading
import time

import numpy as np
import pytest
import torch

from avd_tpu_torch import config as config_mod
from avd_tpu_torch import pipeline
from avd_tpu_torch.models import detector, optim, scoring
from avd_tpu_torch.ops import video_features as vf
from avd_tpu_torch.serve import app as app_mod
from avd_tpu_torch.serve import http as http_mod
from avd_tpu_torch.utils import metrics
from benchmark import spans as bspans
from benchmark import trace as btrace
from tests import fixtures

torch.set_num_threads(2)


def _since(t0):
    return [r for r in metrics.SPANS.between(t0, time.time_ns())]


def _one(recs, name):
    (r,) = [r for r in recs if r.name == name]
    return r


def test_nesting_gives_parents_and_one_request_id():
    ring = metrics.Spans()
    with ring.span("root") as root:
        with ring.span("child", frames=3) as child:
            with ring.span("leaf", pad=1):
                pass
        assert ring.current() == root.ctx
    assert ring.current() is None
    with ring.span("other") as other:
        pass
    recs = {r.name: r for r in ring.records()}
    assert [r.name for r in ring.records()] == ["leaf", "child", "root",
                                                "other"]
    assert recs["root"].parent == 0 and recs["root"].request == root.ctx[1]
    assert recs["child"].parent == root.ctx[1]
    assert recs["leaf"].parent == child.ctx[1]
    assert {recs[k].request for k in ("root", "child", "leaf")} == \
        {root.ctx[0]}
    assert other.ctx[0] != root.ctx[0] and recs["other"].parent == 0
    assert recs["leaf"].attrs == {"pad": 1}
    assert recs["child"].attrs == {"frames": 3}
    r = recs["leaf"]
    assert r.thread == threading.current_thread().name
    assert r.ident == threading.get_ident()
    assert r.tid == threading.get_native_id()
    assert recs["root"].start_ns <= r.start_ns <= r.end_ns <= \
        recs["root"].end_ns


def test_work_handed_to_another_thread_keeps_its_request():
    ring = metrics.Spans()
    seen = {}
    with ring.span("analyze") as root:
        parent = ring.current()
        t_submit = time.time_ns()

        def work():
            ring.record("queued", t_submit, time.time_ns(), parent=parent)
            with ring.span("enqueue", parent=parent):
                seen["inner"] = ring.current()
            seen["after"] = ring.current()

        t = threading.Thread(target=work, name="worker")
        t.start()
        t.join(30)
        assert not t.is_alive()
        job = ring.in_span("video", lambda: ring.current())
        out = []
        t = threading.Thread(target=lambda: out.append(job()))
        t.start()
        t.join(30)
        assert not t.is_alive()
    recs = {r.name: r for r in ring.records()}
    for name in ("queued", "enqueue", "video"):
        assert recs[name].request == root.ctx[0], name
        assert recs[name].parent == root.ctx[1], name
    assert recs["enqueue"].thread == "worker"
    assert seen["after"] is None
    assert seen["inner"] == (root.ctx[0], recs["enqueue"].span)
    assert out == [(root.ctx[0], recs["video"].span)]


def test_the_ring_keeps_the_newest_and_says_how_far_back():
    ring = metrics.Spans(capacity=4)
    assert ring.oldest_start_ns() is None and ring.records() == []
    for i in range(6):
        ring.record(f"s{i}", 100 + 10 * i, 105 + 10 * i, frames=i)
    recs = ring.records()
    assert [r.name for r in recs] == ["s2", "s3", "s4", "s5"]
    assert ring.oldest_start_ns() == 120
    assert [r.name for r in ring.between(130, 145)] == ["s3", "s4"]
    # the totals keep what the ring dropped
    assert sum(t["count"] for t in ring.totals().values()) == 6
    assert metrics.CAPACITY >= 65536


def test_totals_and_flat_keys():
    ring = metrics.Spans()
    ring.record("vf.enqueue", 0, 2_000_000, frames=49, pad=0)
    ring.record("vf.enqueue", 0, 1_000_000, frames=37, pad=6)
    ring.record("det.fetch", 0, 500_000)
    tot = ring.totals()
    assert tot["vf.enqueue"] == {"count": 2, "seconds": 0.003,
                                 "frames": 86, "pad": 6}
    assert tot["det.fetch"] == {"count": 1, "seconds": 0.0005}
    assert ring.flat() == {"span_vf_enqueue_count": 2,
                           "span_vf_enqueue_seconds": 0.003,
                           "span_vf_enqueue_frames_total": 86,
                           "span_vf_enqueue_pad_total": 6,
                           "span_det_fetch_count": 1,
                           "span_det_fetch_seconds": 0.0005}


def test_a_late_record_of_another_thread_keeps_the_profile_whole():
    """A record stamped before the request began but added to the ring
    after its first stage (its thread stalled in between) does not cut
    the request's stages short."""
    ring = metrics.Spans()
    before = time.time_ns()
    with ring.span("analyze") as root:
        with ring.span("probe"):
            pass
        t = threading.Thread(target=lambda: ring.record(
            "late", before - 10, before))
        t.start()
        t.join(30)
        with ring.span("analyzers"):
            pass
        assert list(ring.stage_ms(root)) == ["probe", "analyzers"]


def test_many_threads_lose_no_span():
    """More threads than cores, switching often: every span is counted
    once, with a unique id, under its own thread's parent."""
    ring = metrics.Spans(capacity=1 << 15)
    n_threads, per = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(per):
                with ring.span("outer"):
                    with ring.span("inner", frames=1):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    tot = ring.totals()
    assert tot["outer"]["count"] == tot["inner"]["count"] == n_threads * per
    assert tot["inner"]["frames"] == n_threads * per
    recs = ring.records()
    assert len(recs) == 2 * n_threads * per
    assert len({r.span for r in recs}) == len(recs)
    outer = {r.span: r for r in recs if r.name == "outer"}
    for r in recs:
        if r.name == "inner":
            o = outer[r.parent]
            assert o.request == r.request and o.ident == r.ident


def _stub_window(w320, w32, device, cfg=None):
    return torch.zeros(3 * (w320.shape[0] - 1))


def test_a_30_frame_clip_records_the_video_stages(monkeypatch):
    """Host prep of the chunk, the wait for the dispatch thread, the
    window's enqueue there (37 frames: the 1-frame lead-in and the
    30 real ones bucketed, 6 of padding) and the one fetch, all under the
    caller's span."""
    config_mod.reset_config()
    monkeypatch.setattr(vf, "run_prep_window", _stub_window)
    frames = np.random.default_rng(0).integers(0, 255, (30, 36, 64, 3),
                                               np.uint8)
    t0 = time.time_ns()
    with metrics.span("analyze") as root:
        out = vf.compute_features_streaming(iter([frames]), device="cpu")
    assert out["total"] == 30
    recs = [r for r in _since(t0) if r.request == root.ctx[0]]
    assert sorted(r.name for r in recs) == ["analyze", "vf.enqueue",
                                            "vf.fetch", "vf.host_prep",
                                            "vf.queued"]
    assert _one(recs, "vf.host_prep").attrs == {"frames": 30}
    enq = _one(recs, "vf.enqueue")
    assert enq.attrs == {"frames": 37, "pad": 6}
    assert enq.thread.startswith("avd-dispatch")
    queued = _one(recs, "vf.queued")
    assert queued.thread == enq.thread and queued.end_ns <= enq.start_ns
    assert _one(recs, "vf.fetch").thread == threading.current_thread().name
    for r in recs:
        if r.name != "analyze":
            assert r.parent == root.ctx[1], r.name
    config_mod.reset_config()


@pytest.fixture
def tiny_detector(monkeypatch, tmp_path):
    for name in ("AVD_DETECTOR_CKPT", "AVD_DETECTOR_ARCH",
                 "AVD_DETECTOR_QUANT", "AVD_ATTN_FUSED",
                 "AVD_DETECTOR_EXPORTED"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AVD_DETECTOR", "1")
    monkeypatch.setenv("AVD_DETECTOR_PRESET", "small")
    monkeypatch.setattr(scoring, "_WEIGHTS_DIR", str(tmp_path))
    scoring._bundle.cache_clear()
    yield
    scoring._bundle.cache_clear()


def test_a_30_frame_detector_timeline_records_its_stages(tiny_detector):
    frames = fixtures.spliced_clip(30, 64)
    t0 = time.time_ns()
    with metrics.span("video") as root:
        det = scoring.detector_timeline(frames, device="cpu")
    assert len(det["timeline"]) == 30
    recs = [r for r in _since(t0) if r.request == root.ctx[0]]
    assert [r.name for r in recs] == ["det.resize", "det.stage",
                                      "det.forward", "det.fetch", "video"]
    assert _one(recs, "det.resize").attrs == {"frames": 30}
    assert _one(recs, "det.stage").attrs == {"frames": 30, "bucket": 32}
    assert _one(recs, "det.forward").attrs == {"frames": 30}


def test_a_train_step_records_its_phases():
    cfg = detector.make_config("small", image_size=32, width=32, depth=1,
                               heads=2)
    params = detector.init_params(0, cfg)
    opt = optim.make_optimizer(1e-3)
    step = detector.make_train_step(cfg, opt)
    state = opt.init(optim.leaves_of(params))
    x = torch.rand(4, 32, 32, 3)
    y = torch.tensor([0.0, 1.0, 0.0, 1.0])
    t0 = time.time_ns()
    params, state, loss = step(params, state, x, y)
    assert torch.isfinite(loss)
    recs = _since(t0)
    root = _one(recs, "train.step")
    kids = [r for r in recs if r.parent == root.span]
    assert [r.name for r in kids] == ["train.forward", "train.backward",
                                      "train.optim"]
    assert all(r.request == root.request for r in kids)
    assert root.parent == 0


def test_analyze_path_profile_comes_from_its_spans(monkeypatch, tmp_path):
    for name in ("AVD_DETECTOR", "AVD_STREAM", "DEBUG"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AVD_BACKEND", "oracle")
    monkeypatch.setenv("AVD_PROFILE", "1")
    config_mod.reset_config()
    path = fixtures.write_video(str(tmp_path / "v.mp4"),
                                fixtures.spliced_clip(20, 64), fps=10.0)
    t0 = time.time_ns()
    try:
        out = pipeline.analyze_path(path, device="cpu")
    finally:
        config_mod.reset_config()
    prof = out["profile"]
    assert list(prof) == ["probe", "analyzers", "fusion", "forensic"]
    recs = _since(t0)
    root = _one(recs, "analyze")
    for name, ms in prof.items():
        r = _one(recs, name)
        assert r.parent == root.span and r.request == root.request
        assert ms == round((r.end_ns - r.start_ns) / 1e6, 2)
    stage = _one(recs, "analyzers")
    for name in ("audio", "video"):
        r = _one(recs, name)
        assert r.parent == stage.span and r.request == root.request
        assert r.thread == "avd-analyzer"


def _serve(application):
    srv = http_mod.make_server(application, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


def _request(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    conn.close()
    return r.status, data


def _analyze_in_a_span(path, **_):
    with metrics.span("client.analysis", frames=4):
        return {"ok": True, "sum": float(torch.mm(torch.ones(8, 8),
                                                  torch.ones(8, 8)).sum())}


def _upload():
    b = "avdboundary123"
    body = (f"--{b}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"c.mp4\"\r\nContent-Type: application/octet-stream"
            f"\r\n\r\n").encode() + b"x" * 64 + f"\r\n--{b}--\r\n".encode()
    return body, {"Content-Type": f"multipart/form-data; boundary={b}"}


def test_metrics_route_names_every_span(monkeypatch):
    monkeypatch.delenv("DEBUG", raising=False)
    config_mod.reset_config()
    srv, port = _serve(app_mod.build_app(analyze_fn=_analyze_in_a_span,
                                         device="cpu"))
    try:
        status, _ = _request(port, "POST", "/analyze", *_upload())
        assert status == 200
        status, data = _request(port, "GET", "/metrics")
        snap = json.loads(data)["metrics"]
        assert snap["span_client_analysis_count"] >= 1
        assert snap["span_client_analysis_seconds"] > 0
        assert snap["span_client_analysis_frames_total"] == \
            4 * snap["span_client_analysis_count"]
        status, data = _request(port, "GET", "/metrics?format=prometheus")
        text = data.decode()
        assert "# TYPE avd_span_client_analysis_count counter" in text
        assert "# TYPE avd_span_client_analysis_seconds counter" in text
        assert "# TYPE avd_span_client_analysis_frames_total counter" in text
        line = [ln for ln in text.splitlines()
                if ln.startswith("avd_span_client_analysis_count ")]
        assert float(line[0].split()[1]) >= 1
    finally:
        srv.shutdown()
        config_mod.reset_config()


def test_a_client_threads_span_shows_in_the_debug_trace(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("DEBUG", "1")
    monkeypatch.setenv("AVD_TRACE_DIR", str(tmp_path))
    config_mod.reset_config()
    srv, port = _serve(app_mod.build_app(analyze_fn=_analyze_in_a_span,
                                         device="cpu"))
    try:
        assert _request(port, "POST", "/debug/trace/start")[0] == 200
        assert _request(port, "POST", "/analyze", *_upload())[0] == 200
        status, data = _request(port, "POST", "/debug/trace/stop")
        assert status == 200
        with open(json.loads(data)["trace"]) as f:
            events = json.load(f)["traceEvents"]
    finally:
        srv.shutdown()
        config_mod.reset_config()
    ours = [e for e in events if e.get("name") == "client.analysis"]
    assert ours and ours[0]["tid"] != threading.get_native_id()


def test_a_span_lands_on_the_profiler_clock():
    """Laid on the export's µs clock by the benchmark's rule, a span and a
    ``record_function`` range entered with it start and end within
    100 µs of each other."""
    from torch.profiler import record_function
    with metrics.span("clock.warm"), record_function("clock.warm.rf"):
        torch.ones(8).sum()
    sl = btrace.Slice()
    sl.start()
    sl.open()
    for _ in range(3):
        with metrics.span("clock.span"):
            with record_function("clock.range"):
                torch.ones(64).sum()
    sl.stop()
    trace = sl.digest()
    base = bspans.base_ns(trace)
    ranges = [(s, e) for s, e, who in trace.host
              if who.endswith(": clock.range")]
    recs = [r for r in metrics.SPANS.records()
            if r.name == "clock.span"][-3:]
    assert len(ranges) == len(recs) == 3
    for (s, e), r in zip(ranges, recs):
        assert abs((r.start_ns - base) / 1000 - s) < 100
        assert abs((r.end_ns - base) / 1000 - e) < 100
    # the span's own range is in the trace under its name
    assert any(who.endswith(": clock.span") for *_, who in trace.host)


def test_the_launch_check_counts_the_busiest_threads_launches():
    """``tools/torch_span_check.py``'s clock check: of the launches of
    the thread that launched most, the share inside a ``vf.enqueue``."""
    from tools import torch_span_check as check
    t0 = 5_000_000.0  # the slice's opening, µs on the export's clock
    base = time.time_ns() // (bspans.PERIOD_S * 10 ** 9) \
        * bspans.PERIOD_S * 10 ** 9
    evs = [{"ph": "X", "cat": "user_annotation", "name": btrace.SLICE,
            "ts": t0, "dur": 1000.0, "tid": 1}]
    for j, (t, tid) in enumerate([(460, 7), (500, 7), (540, 7), (720, 7),
                                  (950, 7), (20, 8)]):
        evs += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                 "ts": t0 + t, "dur": 2.0, "tid": tid,
                 "args": {"correlation": j}},
                {"ph": "X", "cat": "kernel", "name": "k", "ts": t0 + t + 5,
                 "dur": 1.0, "args": {"correlation": j}}]
    ring = metrics.Spans()
    for s, e in ((-100, 0), (450, 550), (700, 900)):
        ring.record("vf.enqueue", base + int((t0 + s) * 1000),
                    base + int((t0 + e) * 1000))
    got = check.launches_inside(btrace.Trace(evs, {}), "vf.enqueue",
                                ring=ring)
    assert got == {"thread": "thread 7", "launches": 5, "inside_pct": 80.0}
