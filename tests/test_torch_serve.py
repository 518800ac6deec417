"""The port's HTTP surface (``avd_tpu_torch.serve``) against a live
threaded server: the cases of tests/test_serve.py on the port's app with
``device="cpu"`` (route schema, CORS, multipart streaming, 413/415/422
error mapping, the neutral-fallback contract, the admission gate), the
``torch.profiler`` trace routes, and the same uploads through
``avd_tpu``'s app and the port's on the device path: the same key order
and label, |Δai_score| <= 1e-3 (tests/test_video_parity.py).  The served
partial-AI case (``test_serve.py::test_partial_ai_localization_served``)
serves the shipped ``temporal_small`` through the port's ``/analyze`` and
holds its localization to the JAX test's floors.
"""

import http.client
import io
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from avd_tpu import config as jconfig
from avd_tpu.serve import app as japp
from avd_tpu_torch import config as config_mod
from avd_tpu_torch import pipeline as pl
from avd_tpu_torch.serve import app as app_mod
from avd_tpu_torch.serve import http as http_mod
from avd_tpu_torch.serve.app import _analyze_with_timeout
from avd_tpu_torch.serve.http import HTTPError
from tests import fixtures
from tests.test_torch_file_path import assert_same_envelope

torch.set_num_threads(2)


def _serve(application):
    srv = http_mod.make_server(application, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, srv.server_address[1]


@pytest.fixture(scope="module")
def server():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVD_BACKEND", "oracle")  # host path: the routes' cases
        config_mod.reset_config()
        srv, port = _serve(app_mod.build_app(device="cpu"))
        yield port
        srv.shutdown()
    config_mod.reset_config()


def _request(port, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request(method, path, body=body, headers=headers or {})
    r = conn.getresponse()
    data = r.read()
    out_headers = dict(r.getheaders())
    conn.close()
    return r.status, out_headers, data


def _multipart(fields=None, files=None):
    boundary = "avdboundary123"
    out = io.BytesIO()
    for name, value in (fields or {}).items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{name}\"\r\n\r\n{value}\r\n".encode())
    for name, (filename, payload) in (files or {}).items():
        out.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                  f"name=\"{name}\"; filename=\"{filename}\"\r\n"
                  f"Content-Type: application/octet-stream\r\n\r\n".encode())
        out.write(payload)
        out.write(b"\r\n")
    out.write(f"--{boundary}--\r\n".encode())
    body = out.getvalue()
    return body, {"Content-Type": f"multipart/form-data; boundary={boundary}",
                  "Content-Length": str(len(body))}


def _form(body: bytes):
    return {"Content-Type": "application/x-www-form-urlencoded",
            "Content-Length": str(len(body))}


def test_root(server):
    status, _, data = _request(server, "GET", "/")
    assert status == 200
    d = json.loads(data)
    assert d["ok"] is True and d["service"] == "ai-video-detector"
    assert "version" in d


def test_healthz(server):
    status, _, data = _request(server, "GET", "/healthz")
    assert status == 200
    assert json.loads(data)["ok"] is True


def test_readyz_reports_cuda(server):
    status, _, data = _request(server, "GET", "/readyz")
    d = json.loads(data)
    assert status == 200 and d["ok"] is True
    assert d["author"] == "Backtato"
    assert "ffprobe" in d and "exiftool" in d
    assert "tpu" not in d
    assert d["cuda"] == {"devices": torch.cuda.device_count(),
                         "kind": None}  # no card here


def test_options_catchall(server):
    status, headers, _ = _request(server, "OPTIONS", "/anything/nested")
    assert status == 204
    assert "Access-Control-Allow-Origin" not in headers
    status, headers, _ = _request(server, "OPTIONS", "/anything/nested",
                                  headers={"Origin": "https://x.example"})
    assert status == 204
    assert headers.get("Access-Control-Allow-Origin") == "*"


def test_cors_preflight(server):
    status, headers, data = _request(
        server, "OPTIONS", "/analyze",
        headers={"Origin": "https://x.example",
                 "Access-Control-Request-Method": "POST",
                 "Access-Control-Request-Headers": "content-type"})
    assert status == 200 and data == b"OK"
    assert headers.get("Access-Control-Allow-Origin") == "*"
    assert "POST" in headers.get("Access-Control-Allow-Methods", "")
    assert headers.get("Access-Control-Allow-Headers") == "content-type"


def test_cors_credentialed_wildcard_echoes_origin(server):
    status, headers, _ = _request(
        server, "GET", "/healthz",
        headers={"Origin": "https://x.example", "Cookie": "sid=1"})
    assert status == 200
    assert headers.get("Access-Control-Allow-Origin") == "https://x.example"
    assert headers.get("Vary") == "Origin"


def test_head_routes_like_get_without_body(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=30)
    conn.request("HEAD", "/healthz")
    r = conn.getresponse()
    body = r.read()
    assert r.status == 200
    assert body == b""
    assert int(r.getheader("Content-Length")) > 0
    conn.close()


def test_cors_test_echo(server):
    status, _, data = _request(server, "POST", "/cors-test", body=b"ciao",
                               headers={"Content-Length": "4"})
    assert status == 200
    assert json.loads(data)["echo"] == "ciao"


def test_analyze_full_schema(server, tmp_path):
    path = fixtures.write_video(tmp_path / "n.mp4",
                                fixtures.noise_clip(30, 64), fps=30.0)
    with open(path, "rb") as f:
        body, headers = _multipart(files={"file": ("clip.mp4", f.read())})
    status, _, data = _request(server, "POST", "/analyze", body, headers)
    assert status == 200
    d = json.loads(data)
    assert list(d.keys())[:8] == ["ok", "meta", "hints", "video", "audio",
                                  "result", "timeline_binned", "peaks"]
    assert d["ok"] is True
    assert d["meta"]["width"] == 64
    assert d["meta"]["source_url"] is None
    assert set(d["result"].keys()) == {"label", "ai_score", "confidence",
                                       "reason"}
    assert d["result"]["label"] in ("real", "ai", "uncertain")
    assert d["audio"]["timeline"] == [0.5] * len(d["audio"]["timeline"])


def test_analyze_upload_too_large(monkeypatch):
    monkeypatch.setenv("MAX_UPLOAD_BYTES", "1000")
    config_mod.reset_config()
    try:
        srv, port = _serve(app_mod.build_app(device="cpu"))
        try:
            body, headers = _multipart(files={"file": ("big.mp4",
                                                       b"\x00" * 5000)})
            status, _, data = _request(port, "POST", "/analyze",
                                       body, headers)
            assert status == 413
            d = json.loads(data)
            assert d["detail"]["error"] == "File troppo grande"
            assert d["detail"]["limit_bytes"] == 1000
        finally:
            srv.shutdown()
    finally:
        monkeypatch.delenv("MAX_UPLOAD_BYTES")
        config_mod.reset_config()


def test_analyze_missing_file(server):
    body, headers = _multipart(fields={"other": "x"})
    status, _, data = _request(server, "POST", "/analyze", body, headers)
    assert status == 422
    detail = json.loads(data)["detail"]
    assert detail[0]["loc"] == ["body", "file"]
    assert detail[0]["msg"] == "Field required"


def test_predict_no_input(server):
    body, headers = _multipart(fields={})
    status, _, data = _request(server, "POST", "/predict", body, headers)
    assert status == 422
    d = json.loads(data)
    assert d["detail"]["error"] == "Nessun input"
    assert d["detail"]["hint"] == "Invia 'file' oppure 'url'."


def test_predict_with_file(server, tmp_path):
    path = fixtures.write_video(tmp_path / "s.mp4",
                                fixtures.solid_clip(16, 64), fps=30.0)
    with open(path, "rb") as f:
        body, headers = _multipart(files={"file": ("clip.mp4", f.read())})
    status, _, data = _request(server, "POST", "/predict", body, headers)
    assert status == 200
    assert json.loads(data)["ok"] is True


def test_analyze_url_disabled(server, monkeypatch):
    monkeypatch.setenv("USE_YTDLP", "0")
    config_mod.reset_config()
    try:
        body = b"url=https%3A%2F%2Fexample.com%2Fv.mp4"
        status, _, data = _request(server, "POST", "/analyze-url", body,
                                   _form(body))
        assert status == 422
        assert json.loads(data)["detail"]["error"] == "yt-dlp disabilitato"
    finally:
        monkeypatch.delenv("USE_YTDLP")
        config_mod.reset_config()


def test_analyze_url_missing_field(server):
    body = b"other=x"
    status, _, data = _request(server, "POST", "/analyze-url", body,
                               _form(body))
    assert status == 422
    detail = json.loads(data)["detail"]
    assert detail[0]["loc"] == ["body", "url"]
    assert detail[0]["msg"] == "Field required"


def test_analyze_url_empty_string(server):
    body = b"url="
    status, _, data = _request(server, "POST", "/analyze-url", body,
                               _form(body))
    assert status == 422
    assert json.loads(data)["detail"]["error"] == "URL mancante"


def test_unknown_route_404(server):
    status, _, _ = _request(server, "GET", "/nope")
    assert status == 404


def test_request_timeout_returns_500(monkeypatch):
    """A stuck analysis yields the timeout error without wedging the
    worker (daemon-thread timeout in serve.app._analyze_with_timeout)."""
    monkeypatch.setenv("REQUEST_TIMEOUT_S", "1")
    config_mod.reset_config()
    monkeypatch.setattr(pl, "analyze_path", lambda *a, **k: time.sleep(30))
    t0 = time.time()
    try:
        with pytest.raises(HTTPError) as ei:
            _analyze_with_timeout("/tmp/x.mp4", device="cpu")
        assert ei.value.status == 500
        assert ei.value.detail["error"] == "Timeout analisi"
        assert time.time() - t0 < 5  # did not wait for the sleeper
    finally:
        config_mod.reset_config()


def test_corrupt_upload_gets_neutral_result(server):
    body, headers = _multipart(files={"file": ("junk.mp4",
                                               b"not a video" * 100)})
    status, _, data = _request(server, "POST", "/analyze", body, headers)
    assert status == 200
    d = json.loads(data)
    assert d["ok"] is True
    assert d["result"]["label"] == "uncertain"
    assert d["video"]["timeline"] in ([], [0.5])


def _chunked_encode(body: bytes, chunk: int = 7777) -> bytes:
    out = io.BytesIO()
    for i in range(0, len(body), chunk):
        piece = body[i:i + chunk]
        out.write(f"{len(piece):x}\r\n".encode())
        out.write(piece)
        out.write(b"\r\n")
    out.write(b"0\r\n\r\n")
    return out.getvalue()


def _read_all(s) -> bytes:
    resp = b""
    while True:
        got = s.recv(65536)
        if not got:
            return resp
        resp += got


def _request_chunked(port, method, path, body, headers):
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    try:
        head = [f"{method} {path} HTTP/1.1", "Host: 127.0.0.1",
                "Transfer-Encoding: chunked", "Connection: close"]
        for k, v in headers.items():
            if k.lower() != "content-length":
                head.append(f"{k}: {v}")
        s.sendall(("\r\n".join(head) + "\r\n\r\n").encode())
        s.sendall(_chunked_encode(body))
        resp = _read_all(s)
    finally:
        s.close()
    head_raw, _, payload = resp.partition(b"\r\n\r\n")
    return int(head_raw.split(b" ", 2)[1]), payload


def test_chunked_multipart_upload(server, tmp_path):
    path = fixtures.write_video(tmp_path / "chunked.mp4",
                                fixtures.spliced_clip(60, 64), fps=30.0)
    with open(path, "rb") as f:
        body, headers = _multipart(files={"file": ("c.mp4", f.read())})
    status, data = _request_chunked(server, "POST", "/analyze", body,
                                    headers)
    assert status == 200
    out = json.loads(data)
    assert out["ok"] is True
    assert out["result"]["label"] in ("real", "ai", "uncertain")


def test_expect_100_continue_flow(server, tmp_path):
    path = fixtures.write_video(tmp_path / "e.mp4",
                                fixtures.solid_clip(16, 64), fps=30.0)
    with open(path, "rb") as f:
        body, headers = _multipart(files={"file": ("clip.mp4", f.read())})
    s = socket.create_connection(("127.0.0.1", server), timeout=60)
    try:
        head = ["POST /analyze HTTP/1.1", "Host: 127.0.0.1",
                "Expect: 100-continue", "Connection: close"]
        for k, v in headers.items():
            head.append(f"{k}: {v}")
        s.sendall(("\r\n".join(head) + "\r\n\r\n").encode())
        interim = b""
        while b"\r\n\r\n" not in interim:
            got = s.recv(4096)
            assert got, "connection closed before the interim response"
            interim += got
        assert interim.startswith(b"HTTP/1.1 100 Continue"), interim[:80]
        s.sendall(body)
        resp = _read_all(s)
    finally:
        s.close()
    head_raw, _, data = resp.partition(b"\r\n\r\n")
    assert head_raw.startswith(b"HTTP/1.1 200"), head_raw[:80]
    length = int(dict(line.split(b": ", 1)
                      for line in head_raw.split(b"\r\n")[1:])
                 [b"Content-Length"])
    assert json.loads(data[:length])["ok"] is True


def test_expect_no_interim_when_body_unread(server):
    body = b"x" * 1024
    s = socket.create_connection(("127.0.0.1", server), timeout=60)
    try:
        s.sendall(("POST /no-such-route HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                   "Expect: 100-continue\r\n"
                   f"Content-Length: {len(body)}\r\nConnection: close"
                   "\r\n\r\n").encode())
        resp = b""
        while b"\r\n\r\n" not in resp:
            got = s.recv(4096)
            assert got, "connection closed before any response"
            resp += got
        assert resp.startswith(b"HTTP/1.1 404"), resp[:80]
        assert b"100 Continue" not in resp
        s.sendall(body)  # late body: the post-response drain eats it
        resp += _read_all(s)
        assert b"100 Continue" not in resp
    finally:
        s.close()


def test_chunked_cors_echo(server):
    body = b"x" * 300000
    status, data = _request_chunked(
        server, "POST", "/cors-test", body,
        {"Content-Type": "application/octet-stream"})
    assert status == 200
    out = json.loads(data)
    assert out["ok"] is True and len(out["echo"]) == len(body)


def test_keep_alive_reuses_connection(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=60)
    try:
        for _ in range(3):
            conn.request("GET", "/healthz")
            r = conn.getresponse()
            assert r.status == 200
            r.read()
        sock_id = id(conn.sock)
        conn.request("GET", "/healthz")
        conn.getresponse().read()
        assert id(conn.sock) == sock_id
    finally:
        conn.close()


def test_chunked_framing_error_closes_connection(server):
    conn = http.client.HTTPConnection("127.0.0.1", server, timeout=30)
    conn.putrequest("POST", "/cors-test")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.putheader("Content-Type", "text/plain")
    conn.endheaders()
    conn.send(b"zz\r\ngarbage\r\n")
    r = conn.getresponse()
    assert r.status == 400
    assert (r.getheader("Connection") or "").lower() == "close"
    conn.close()


def test_multipart_boundary_with_trailing_params(server, tmp_path):
    path = fixtures.write_video(tmp_path / "b.mp4",
                                fixtures.solid_clip(16, 64), fps=30.0)
    with open(path, "rb") as f:
        body, headers = _multipart(files={"file": ("b.mp4", f.read())})
    headers["Content-Type"] += "; charset=utf-8"
    status, _, data = _request(server, "POST", "/analyze", body, headers)
    assert status == 200
    assert json.loads(data)["ok"] is True


def test_server_close_waits_for_inflight_requests():
    srv = http_mod.make_server(http_mod.App(), "127.0.0.1", 0)
    srv.drain_timeout = 10.0
    srv.request_began()          # simulate a request in flight
    t0 = time.time()
    done = threading.Event()

    def finish():
        time.sleep(0.5)
        srv.request_done()
        done.set()

    threading.Thread(target=finish, daemon=True).start()
    srv.server_close()           # must block until request_done fires
    assert done.is_set()
    assert time.time() - t0 >= 0.45
    assert srv.draining is True


def test_admission_gate_sheds_503(monkeypatch):
    monkeypatch.setenv("AVD_MAX_INFLIGHT", "1")
    monkeypatch.setenv("AVD_BACKEND", "oracle")
    config_mod.reset_config()
    started, release = threading.Event(), threading.Event()

    def slow_analyze(path, source_url=None, resolved_url=None):
        started.set()
        assert release.wait(20)
        return {"ok": True, "result": {"label": "real"}}

    srv, port = _serve(app_mod.build_app(analyze_fn=slow_analyze,
                                         device="cpu"))
    body, headers = _multipart(files={"file": ("c.mp4", b"x" * 2048)})
    first = {}
    t = threading.Thread(target=lambda: first.setdefault(
        "out", _request(port, "POST", "/analyze", body, headers)),
        daemon=True)
    try:
        t.start()
        assert started.wait(10)
        status, shed_headers, data = _request(port, "POST", "/analyze",
                                              body, headers)
        assert status == 503
        detail = json.loads(data)["detail"]
        assert detail["error"] == "Servizio sovraccarico, riprova"
        assert detail["inflight_limit"] == 1
        assert shed_headers.get("Retry-After") == "1"
        form = b"url=http%3A%2F%2Fx%2Fv.mp4"
        status, _, _ = _request(port, "POST", "/analyze-url", form,
                                _form(form))
        assert status == 503
        status, _, data = _request(port, "GET", "/healthz")
        assert status == 200 and json.loads(data)["ok"] is True
        status, _, data = _request(port, "GET", "/metrics")
        assert json.loads(data)["metrics"]["requests_shed"] >= 2
        release.set()
        t.join(10)
        assert not t.is_alive()
        assert first["out"][0] == 200
        status, _, _ = _request(port, "POST", "/analyze", body, headers)
        assert status == 200
    finally:
        release.set()
        srv.shutdown()
        config_mod.reset_config()


# ---------------------------------------------------------------------------
# the port's own: device, metrics, trace routes
# ---------------------------------------------------------------------------

def test_build_app_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app_mod.build_app()
    seen = []
    monkeypatch.setattr(pl, "analyze_path",
                        lambda path, s, r, device, batcher:
                        seen.append((device, batcher)) or {})
    _analyze_with_timeout("/tmp/x.mp4", device=torch.device("cpu"))
    assert seen == [(torch.device("cpu"), None)]  # AVD_BATCH_WINDOW_MS=0


def test_metrics_prometheus_exposition(server):
    status, headers, data = _request(server, "GET",
                                     "/metrics?format=prometheus")
    assert status == 200
    assert headers["Content-Type"] == "text/plain; version=0.0.4"
    text = data.decode()
    assert "# TYPE avd_requests counter" in text


def test_trace_routes_write_a_chrome_trace(monkeypatch, tmp_path):
    """DEBUG=1: /debug/trace/start and /stop around a request write a
    Chrome trace of it (the profiler is owned by one thread; requests run
    on others); a second start is refused and a stop with no start
    answers 409, as avd_tpu's jax.profiler routes do."""
    monkeypatch.setenv("DEBUG", "1")
    monkeypatch.setenv("AVD_TRACE_DIR", str(tmp_path))
    config_mod.reset_config()
    srv, port = _serve(app_mod.build_app(
        analyze_fn=lambda path, **_: {"ok": True, "sum": float(
            torch.mm(torch.ones(8, 8), torch.ones(8, 8)).sum())},
        device="cpu"))
    try:
        status, _, data = _request(port, "POST", "/debug/trace/stop")
        assert status == 409
        assert json.loads(data)["detail"]["error"] == "No profile started"
        status, _, data = _request(port, "POST", "/debug/trace/start")
        assert status == 200
        assert json.loads(data)["trace_dir"] == str(tmp_path)
        status, _, _ = _request(port, "POST", "/debug/trace/start")
        assert status == 500
        body, headers = _multipart(files={"file": ("c.mp4", b"x" * 64)})
        status, _, _ = _request(port, "POST", "/analyze", body, headers)
        assert status == 200
        status, _, data = _request(port, "POST", "/debug/trace/stop")
        assert status == 200
        trace = json.loads(data)["trace"]
        assert os.path.dirname(trace) == str(tmp_path)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        assert any(e.get("name") == "aten::mm" for e in events)
        status, _, _ = _request(port, "POST", "/debug/trace/stop")
        assert status == 409
    finally:
        srv.shutdown()
        config_mod.reset_config()


def test_trace_routes_absent_without_debug(server):
    status, _, _ = _request(server, "POST", "/debug/trace/start")
    assert status == 404


# ---------------------------------------------------------------------------
# parity: the same uploads through avd_tpu's app and the port's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_apps():
    """avd_tpu's app (JAX on the CPU) and the port's (device="cpu"), both
    on the device path (no AVD_BACKEND)."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("AVD_BACKEND", "AVD_DETECTOR", "AVD_BATCH_WINDOW_MS",
                     "DEBUG", "AVD_PROFILE"):
            mp.delenv(name, raising=False)
        config_mod.reset_config()
        jconfig.reset_config()
        ours, ours_port = _serve(app_mod.build_app(device="cpu"))
        ref, ref_port = _serve(japp.build_app())
        yield ours_port, ref_port
        ours.shutdown()
        ref.shutdown()
    config_mod.reset_config()
    jconfig.reset_config()


@pytest.mark.parametrize("kind", ["mp4", "wav"])
def test_upload_matches_avd_tpu_app(both_apps, tmp_path, kind):
    if kind == "mp4":
        path = fixtures.write_video(tmp_path / "s.mp4",
                                    fixtures.spliced_clip(60, 64), fps=30.0)
    else:
        path = fixtures.write_wav(tmp_path / "a.wav",
                                  fixtures.speechy_wav(3.0))
    with open(path, "rb") as f:
        body, headers = _multipart(files={"file": (f"u.{kind}", f.read())})
    got = []
    for port in both_apps:
        status, _, data = _request(port, "POST", "/analyze", body, headers)
        assert status == 200
        got.append(json.loads(data))
    ours, ref = got
    assert_same_envelope(ours, ref)
    assert abs(ours["result"]["ai_score"] - ref["result"]["ai_score"]) \
        <= 1e-3
    if kind == "mp4":
        assert "video_error" not in ours["hints"]
        assert ours["video"]["summary"]["flow_mean"] > 0
    else:
        assert "audio_error" not in ours["hints"]


def test_upload_windows_go_through_the_batcher(monkeypatch, tmp_path):
    """With AVD_BATCH_WINDOW_MS > 0 the app hands the process batcher to
    ``analyze_path``: every window of a served upload runs there through
    ``submit_prep``, and the envelope equals the in-process one."""
    from avd_tpu_torch.ops import video_features
    from avd_tpu_torch.serve import batching
    for name in ("AVD_BACKEND", "AVD_DETECTOR", "DEBUG", "AVD_PROFILE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AVD_BATCH_WINDOW_MS", "20")
    monkeypatch.setattr(video_features, "_DEFAULT_CHUNK", 4)
    config_mod.reset_config()
    batching.reset_active()
    path = fixtures.write_video(tmp_path / "s.mp4",
                                fixtures.spliced_clip(40, 64), fps=4.0)
    try:
        # as served: JSON drops the in-process timeline aliasing
        ref = json.loads(json.dumps(pl.analyze_path(str(path),
                                                    device="cpu")))
        srv, port = _serve(app_mod.build_app(device="cpu"))
        with open(path, "rb") as f:
            body, headers = _multipart(files={"file": ("u.mp4", f.read())})
        status, _, data = _request(port, "POST", "/analyze", body, headers)
        srv.shutdown()
        assert status == 200
        got = json.loads(data)
        b = batching._ACTIVE
        assert b is not None and b.jobs_in >= 2
    finally:
        batching.reset_active()
        config_mod.reset_config()
    assert_same_envelope(got, ref)
    assert got["result"] == ref["result"]
    assert got["video"]["timeline"] == pytest.approx(
        ref["video"]["timeline"], rel=2e-5, abs=1e-5)


def test_partial_ai_localization_served(tmp_path, monkeypatch):
    """tests/test_serve.py:587 on the port's app: a real→AI spliced clip
    (the blobs frames of ``avd_tpu.models.train``) served with the shipped
    temporal detector; its detector timeline localizes the splice (IoU
    floor 0.6), and the fused timeline and peaks split at it."""
    from avd_tpu.models import train as train_mod
    from avd_tpu_torch.models import scoring

    # 64 camera-like frames, AI-like from frame 20 (not aligned to the
    # 32-frame scoring window); at 2 fps only the first `duration`
    # sampled frames reach the fused timeline
    rng = np.random.default_rng(11)
    size, n, splice = 64, 64, 20
    frames = np.stack([
        np.clip(train_mod._frame_blobs(rng, size, ai_like=(i >= splice)),
                0, 1) for i in range(n)])
    clip = (frames * 255).astype(np.uint8)[..., ::-1]  # RGB→BGR
    path = fixtures.write_video(tmp_path / "spliced_ai.mp4", clip, fps=2.0)

    monkeypatch.setenv("AVD_BACKEND", "oracle")
    monkeypatch.setenv("AVD_DETECTOR", "1")
    monkeypatch.setenv("AVD_DETECTOR_ARCH", "temporal")
    monkeypatch.setenv("AVD_DETECTOR_BLEND", "1")  # timeline == detector
    for name in ("AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT",
                 "AVD_DETECTOR_QUANT", "AVD_ATTN_FUSED",
                 "AVD_TEMPORAL_WINDOW"):
        monkeypatch.delenv(name, raising=False)
    config_mod.reset_config()
    scoring._bundle.cache_clear()
    srv, port = _serve(app_mod.build_app(device="cpu"))
    try:
        with open(path, "rb") as f:
            payload = f.read()
        body, headers = _multipart(files={"file": ("s.mp4", payload)})
        status, _, data = _request(port, "POST", "/analyze", body, headers)
        assert status == 200
        env = json.loads(data)
        det = env["video"].get("detector")
        assert det and "temporal_small" in det["weights"], env["video"]
        t = np.asarray(det["timeline"], float)
        m = len(t)
        assert m >= 16, f"expected ~2 fps sampling of a 32 s clip, got {m}"

        true_ai = np.zeros(m, bool)
        true_ai[int(round(splice / n * m)):] = True
        pred_ai = t > 0.5
        iou = (true_ai & pred_ai).sum() / max(1, (true_ai | pred_ai).sum())
        assert iou >= 0.6, (iou, t.round(2).tolist())

        fused_len = len(env["video"]["timeline"])
        assert splice < fused_len <= m
        binned = np.asarray(env["timeline_binned"], float)
        b_split = int(round(splice / fused_len * len(binned)))
        assert binned[b_split:].mean() - binned[:b_split].mean() > 0.15, \
            binned.tolist()
        high_peaks = [i for i in env["peaks"] if i < fused_len
                      and t[i] > 0.5]
        low_peaks = [i for i in env["peaks"] if i < fused_len
                     and t[i] <= 0.5]
        assert low_peaks and all(i < splice for i in low_peaks), \
            (env["peaks"], t[:fused_len])
        assert all(i >= splice for i in high_peaks), (env["peaks"], t)
    finally:
        srv.shutdown()
        config_mod.reset_config()
        scoring._bundle.cache_clear()
