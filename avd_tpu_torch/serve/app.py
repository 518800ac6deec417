"""HTTP route definitions — full parity with the reference surface.

Port of ``avd_tpu/serve/app.py``.  Routes (the reference's api.py:213-266):
GET / , GET /healthz , GET /readyz , catch-all OPTIONS (204), POST
/cors-test (echo), POST /analyze (multipart upload), POST /predict
(back-compat dispatcher), POST /analyze-url (form URL).  Response bodies,
error statuses (413/415/422/500) and Italian messages are preserved
byte-for-byte; /readyz additionally reports CUDA device health (the
reference only checks for ffprobe/exiftool binaries, api.py:110-116).

``build_app(device=...)`` analyzes on that device (default CUDA; it
raises when CUDA is absent unless the caller asks for the CPU).  In a
served rank group (``serve/group.py``) ``/readyz`` reports the group's
size as ``devices`` and ``/metrics`` its state under ``group``; under
``torchrun --nproc-per-node N`` rank 0 of ``main`` serves and the others
follow.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict

from avd_tpu_torch import device as device_mod
from avd_tpu_torch import pipeline
from avd_tpu_torch.config import get_config
from avd_tpu_torch.serve import batching
from avd_tpu_torch.serve.http import (App, HTTPError, Request, Response,
                                      parse_multipart)

SERVICE_NAME = "ai-video-detector"


def _ready_probe() -> Dict[str, Any]:
    """Dependency probe (api.py:110-116) + CUDA device health."""
    cfg = get_config()
    out = {
        "ffprobe": bool(shutil.which("ffprobe")),
        "exiftool": bool(shutil.which("exiftool")),
        "version": cfg.version,
        "author": "Backtato",
    }
    try:
        import torch

        from avd_tpu_torch.serve import group
        n = torch.cuda.device_count()
        leader = group.active()
        out["cuda"] = {"devices": leader.size if leader else n,
                       "kind": torch.cuda.get_device_name(0) if n else None}
    except Exception as e:
        out["cuda"] = {"devices": 0, "error": str(e)}
    return out


def _too_large_detail():
    cfg = get_config()
    return {"error": "File troppo grande",
            "limit_bytes": cfg.max_upload_bytes}


class _AdmissionGate:
    """Per-worker analysis-concurrency limit (AVD_MAX_INFLIGHT — the
    uvicorn ``--limit-concurrency`` analogue the reference stack gets for
    free).  When the worker already has ``limit`` analyses in flight,
    further analysis POSTs are shed with 503 + ``Retry-After`` *before*
    their upload is spooled to disk, so an overloaded worker spends no
    decode/spool work on requests it can't serve within the timeout.
    ``limit <= 0`` disables (reference behavior: unbounded).

    Health/metrics GETs are never shed — load balancers and the master's
    readiness logic must keep seeing the worker."""

    def __init__(self, limit: int):
        self.limit = limit
        self._n = 0
        self._lock = threading.Lock()

    def __enter__(self):
        if self.limit > 0:
            with self._lock:
                if self._n >= self.limit:
                    from avd_tpu_torch.utils.metrics import COUNTERS
                    COUNTERS.inc("requests_shed")
                    raise HTTPError(
                        503,
                        {"error": "Servizio sovraccarico, riprova",
                         "inflight_limit": self.limit},
                        headers={"Retry-After": "1"})
                self._n += 1
        return self

    def __exit__(self, *exc):
        if self.limit > 0:
            with self._lock:
                self._n -= 1
        return False


def _analyze_with_timeout(path: str, source_url=None, resolved_url=None,
                          device=None):
    """Request-level timeout (api.py:241) on a daemon thread — a stuck
    analysis must not hold the connection (or process exit) hostage."""
    cfg = get_config()
    task = pipeline._DaemonTask(pipeline.analyze_path, path, source_url,
                                resolved_url, device,
                                batching.active_batcher())
    try:
        return task.result(timeout=cfg.request_timeout_s)
    except concurrent.futures.TimeoutError:
        raise HTTPError(500, {"error": "Timeout analisi"})


class _Tracer:
    """The ``torch.profiler`` session behind /debug/trace/start|stop.

    A profiler must be stopped by the thread that started it, and requests
    arrive on arbitrary handler threads, so one owner thread per session
    starts it, waits, then stops it and exports the Chrome trace.  It
    records the operators of every thread (the analyses run on their own),
    the program's spans among them as ranges of their names
    (``utils/metrics.py``), and, on CUDA, every kernel on the card."""

    def __init__(self, device):
        self.device = device
        self._lock = threading.Lock()
        self._session = None  # (owner thread, stop event, box, path)

    def start(self, path: str) -> None:
        import torch
        from torch._C._profiler import _ExperimentalConfig
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with self._lock:
            if self._session is not None:
                raise RuntimeError("Profile has already been started. Only "
                                   "one profile may be run at a time.")
            started, stop, box = threading.Event(), threading.Event(), {}

            def owner():
                try:
                    prof = torch.profiler.profile(
                        activities=acts,
                        experimental_config=_ExperimentalConfig(
                            profile_all_threads=True))
                    prof.start()
                except Exception as e:
                    box["error"] = e
                    return
                finally:
                    started.set()
                stop.wait()
                try:
                    prof.stop()
                    prof.export_chrome_trace(path)
                except Exception as e:
                    box["error"] = e

            t = threading.Thread(target=owner, daemon=True,
                                 name="avd-trace")
            t.start()
            started.wait()
            if "error" in box:
                raise box["error"]
            self._session = (t, stop, box, path)

    def stop(self) -> str:
        """End the session; returns the Chrome trace's path."""
        with self._lock:
            if self._session is None:
                raise HTTPError(409, {"error": "No profile started"})
            t, stop, box, path = self._session
            self._session = None
        stop.set()
        t.join()
        if "error" in box:
            raise box["error"]
        return path


def build_app(analyze_fn=None, device=None) -> App:
    """Construct the route table.  ``analyze_fn`` is injectable so tests
    can stand in for the pipeline; ``device`` (default CUDA) is where the
    default one, ``pipeline.analyze_path``, runs."""
    cfg = get_config()
    dev = device_mod.pinned(device)
    app = App(allowed_origins=cfg.allowed_origins, debug=cfg.debug)
    run_analysis = analyze_fn or functools.partial(_analyze_with_timeout,
                                                   device=dev)
    gate = _AdmissionGate(cfg.max_inflight)

    @app.route("GET", "/")
    def root(req: Request) -> Response:
        return Response({"ok": True, "service": SERVICE_NAME,
                         "version": cfg.version})

    @app.route("GET", "/healthz")
    def healthz(req: Request) -> Response:
        return Response({"ok": True, "version": cfg.version})

    @app.route("GET", "/readyz")
    def readyz(req: Request) -> Response:
        return Response({"ok": True, **_ready_probe()})

    if cfg.debug:
        # DEBUG-gated torch.profiler trace control (SURVEY.md §5 tracing)
        # — capture a host/device trace of live traffic as a Chrome trace
        tracer = _Tracer(dev)

        @app.route("POST", "/debug/trace/start")
        def trace_start(req: Request) -> Response:
            trace_dir = os.getenv("AVD_TRACE_DIR",
                                  os.path.join(tempfile.gettempdir(),
                                               "avd_trace"))
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(trace_dir, f"avd_trace_{os.getpid()}_"
                                           f"{time.time_ns()}.json")
            tracer.start(path)
            return Response({"ok": True, "trace_dir": trace_dir})

        @app.route("POST", "/debug/trace/stop")
        def trace_stop(req: Request) -> Response:
            return Response({"ok": True, "trace": tracer.stop()})

    @app.route("GET", "/metrics")
    def metrics(req: Request) -> Response:
        """Process counters — beyond-reference observability
        (SURVEY.md §5: requests, frames/sec, batch occupancy) — and each
        span's ``span_<name>_count``, ``span_<name>_seconds`` and
        ``span_<name>_<attr>_total`` (``utils/metrics.py``).

        JSON by default; Prometheus text exposition (0.0.4) when the
        scraper asks for it (``?format=prometheus`` or an Accept header
        preferring text/plain), so a stock Prometheus scrape job works
        against the same path.
        """
        from avd_tpu_torch.utils.metrics import COUNTERS, SPANS
        snap = COUNTERS.snapshot()
        snap.update(SPANS.flat())
        b = batching._ACTIVE
        if b is not None:
            snap["batch_jobs_in"] = b.jobs_in
            snap["batches_formed"] = b.batches_formed
            snap["batch_fused_jobs"] = b.fused_jobs
        from avd_tpu_torch.serve import group
        if group.active() is not None:
            snap["group"] = group.active().stats()
        accept = (req.headers.get("Accept") or "")
        if (req.query.get("format") == "prometheus"
                or ("text/plain" in accept
                    and "application/json" not in accept)):
            lines = []
            for k in sorted(snap):
                v = snap[k]
                if not isinstance(v, (int, float)):
                    continue
                name = "avd_" + k
                kind = ("gauge" if k.endswith(("_s", "_per_sec_lifetime"))
                        else "counter")
                lines.append(f"# TYPE {name} {kind}")
                lines.append(f"{name} {float(v):g}")
            text = "\n".join(lines) + "\n"
            return Response(raw=text.encode(),
                            headers={"Content-Type":
                                     "text/plain; version=0.0.4"})
        return Response({"ok": True, "version": cfg.version,
                         "metrics": snap})

    @app.options_catchall
    def options(req: Request) -> Response:
        return Response(status=204)

    @app.route("POST", "/cors-test")
    def cors_test(req: Request) -> Response:
        body = req.body()
        return Response({"ok": True,
                         "echo": body.decode("utf-8", "ignore")})

    def _do_analyze(req: Request) -> Response:
        files, _ = parse_multipart(req, cfg.max_upload_bytes,
                                   _too_large_detail)
        try:
            up = files.get("file")
            if up is None:
                # the reference's 415 branch (api.py:238) is dead code:
                # FastAPI validates `file: UploadFile = File(...)` BEFORE
                # the route body, so a missing part observably yields the
                # pydantic 422 — mirror that, not the unreachable branch
                raise HTTPError(422, [{"type": "missing",
                                       "loc": ["body", "file"],
                                       "msg": "Field required",
                                       "input": None}])
            return Response(run_analysis(up.path))
        finally:
            for f in files.values():  # incl. misnamed/extra spooled parts
                f.unlink()

    def _do_analyze_url(url: str) -> Response:
        from avd_tpu_torch.ingest import url as url_resolver
        if not url:
            raise HTTPError(422, {"error": "URL mancante"})
        dl = url_resolver.resolve(url, cfg.resolver_max_bytes)
        try:
            return Response(run_analysis(dl["path"], source_url=url,
                                         resolved_url=dl.get("resolved_url")))
        finally:
            try:
                os.unlink(dl["path"])
            except OSError:
                pass

    @app.route("POST", "/analyze")
    def analyze(req: Request) -> Response:
        with gate:
            return _do_analyze(req)

    @app.route("POST", "/analyze-url")
    def analyze_url(req: Request) -> Response:
        with gate:
            files, fields = parse_multipart_or_form(req)
            for f in files.values():  # stray file parts must not leak spools
                f.unlink()
            if "url" not in fields:
                # the reference declares `url: str = Form(...)` — FastAPI
                # validates BEFORE the route body, so a MISSING field
                # observably yields the pydantic 422; the Italian
                # "URL mancante" branch (api.py:257-258) is reachable
                # only for an EMPTY-STRING url (Form accepts "" as a str)
                raise HTTPError(422, [{"type": "missing",
                                       "loc": ["body", "url"],
                                       "msg": "Field required",
                                       "input": None}])
            return _do_analyze_url(fields["url"])

    @app.route("POST", "/predict")
    def predict(req: Request) -> Response:
        """Back-compat dispatcher (api.py:247-253): file → analyze,
        url → analyze-url, neither → 422."""
        with gate:
            files, fields = parse_multipart_or_form(req)
            try:
                up = files.get("file")
                if up is not None:
                    return Response(run_analysis(up.path))
                if fields.get("url"):
                    return _do_analyze_url(fields["url"])
                raise HTTPError(422, {"error": "Nessun input",
                                      "hint": "Invia 'file' oppure 'url'."})
            finally:
                for f in files.values():
                    f.unlink()

    def parse_multipart_or_form(req: Request):
        ctype = req.headers.get("Content-Type", "")
        if "multipart/form-data" in ctype:
            return parse_multipart(req, cfg.max_upload_bytes,
                                   _too_large_detail)
        if "application/x-www-form-urlencoded" in ctype:
            from urllib.parse import parse_qs
            body = req.body().decode("utf-8", "ignore")
            # keep_blank_values: `url=` must surface as an EMPTY string
            # (Starlette form semantics) — the reference's Italian
            # "URL mancante" branch is reachable only that way; dropping
            # blanks would misreport it as a missing field (422 shape)
            return {}, {k: v[0] for k, v in
                        parse_qs(body, keep_blank_values=True).items()}
        return {}, {}

    return app


def main(argv=None) -> int:
    """Run a single-process server:
    ``python -m avd_tpu_torch.serve.app [--device cuda|cpu]``; under
    ``torchrun --nproc-per-node N`` (``WORLD_SIZE`` > 1) one served group:
    rank 0 serves, the others follow (``serve/group.join``)."""
    import argparse

    from avd_tpu_torch.serve.http import make_server
    ap = argparse.ArgumentParser(
        description="single-process AI-video analysis service")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where analyses run (default cuda)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"], default=None,
                    help="under torchrun, the group's backend (default nccl "
                         "on cuda, gloo on the CPU)")
    args = ap.parse_args(argv)
    cfg = get_config()
    device, leader = args.device, None
    if int(os.getenv("WORLD_SIZE", "1")) > 1:
        from avd_tpu_torch.serve import group
        leader = group.join(args.device, args.dist_backend)
        if leader is None:
            return 0  # a follower, stopped by its leader
        device = leader.device
    host, _, port = cfg.bind.rpartition(":")
    server = make_server(build_app(device=device), host or "0.0.0.0",
                         int(port))
    if leader is not None:
        leader.on_fail = lambda: threading.Thread(
            target=server.shutdown, daemon=True).start()
    print(f"avd_tpu_torch serving on {cfg.bind}", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    if leader is None:
        return 0
    code = group.GROUP_FAILED if leader.failed else 0
    leader.stop()
    return code


if __name__ == "__main__":
    raise SystemExit(main())
