"""The port's client (``avd_tpu_torch.client``) against a live server of
the port's app on ``device="cpu"``: the cases of tests/test_client.py
(typed results, streamed multipart uploads, error mapping, retries, the
CLI), plus the client against ``avd_tpu``'s own service."""

import io
import json
import threading

import pytest

from avd_tpu import config as jconfig
from avd_tpu.serve import app as japp
from avd_tpu_torch import client as client_mod
from avd_tpu_torch import config as config_mod
from avd_tpu_torch.client import APIError, AnalysisResult, Client, ClientError
from avd_tpu_torch.serve import app as app_mod
from avd_tpu_torch.serve import http as http_mod
from tests import fixtures


@pytest.fixture(scope="module")
def server():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AVD_BACKEND", "oracle")  # host path: no device work
        config_mod.reset_config()
        jconfig.reset_config()
        srv = http_mod.make_server(app_mod.build_app(device="cpu"),
                                   "127.0.0.1", 0)
        port = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        yield port
        srv.shutdown()
    config_mod.reset_config()
    jconfig.reset_config()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("client") / "grad.mp4"
    fixtures.write_video(str(path), fixtures.gradient_clip(n=30, size=96))
    return str(path)


def test_health_ready_info(server):
    c = Client(f"http://127.0.0.1:{server}")
    assert c.health()["ok"] is True
    ready = c.ready()
    assert ready["ok"] is True and "cuda" in ready
    info = c.info()
    assert info["service"] == "ai-video-detector"
    m = c.metrics()
    assert m["ok"] is True and isinstance(m["metrics"], dict)


def test_wait_ready_immediate(server):
    c = Client(f"http://127.0.0.1:{server}")
    assert c.wait_ready(timeout_s=10)["ok"] is True


def test_analyze_path_typed_result(server, clip):
    c = Client(f"http://127.0.0.1:{server}")
    res = c.analyze(clip)
    assert isinstance(res, AnalysisResult)
    assert res.ok is True
    assert res.label in ("real", "ai", "uncertain")
    assert 0.0 <= res.ai_score <= 1.0
    assert 0.0 <= res.confidence <= 1.0
    assert isinstance(res.timeline, list) and res.timeline
    assert isinstance(res.peaks, list)
    assert res.meta.get("width") == 96
    # raw carries the full reference envelope in order
    assert list(res.raw)[:6] == ["ok", "meta", "hints", "video", "audio",
                                 "result"]


def test_analyze_file_object(server, clip):
    c = Client(f"http://127.0.0.1:{server}")
    with open(clip, "rb") as fh:
        res = c.analyze(fh, filename="clip.mp4")
        # the client must not close a caller-owned handle
        assert not fh.closed
    assert res.ok is True


def test_predict_with_file(server, clip):
    c = Client(f"http://127.0.0.1:{server}")
    res = c.predict(clip)
    assert res.ok is True and res.label in ("real", "ai", "uncertain")


def test_predict_neither_raises(server):
    c = Client(f"http://127.0.0.1:{server}")
    with pytest.raises(ValueError):
        c.predict()


def test_api_error_maps_status_and_detail(server):
    # /predict with neither file nor url → the reference's 422 (api.py:253)
    c = Client(f"http://127.0.0.1:{server}")
    with pytest.raises(APIError) as ei:
        c._post_form("/predict", {})
    assert ei.value.status == 422
    # the reference wraps HTTPException payloads under "detail"
    # (FastAPI convention, preserved by serve/http.py)
    assert "error" in ei.value.detail.get("detail", ei.value.detail)


def test_api_error_on_unknown_route(server):
    c = Client(f"http://127.0.0.1:{server}")
    with pytest.raises(APIError) as ei:
        c._get("/no-such-route")
    assert ei.value.status == 404


def test_connection_refused_retries_then_raises():
    c = Client("http://127.0.0.1:1", timeout=0.5, retries=1,
               backoff_s=0.01)
    with pytest.raises(ClientError):
        c.health()


def test_base_url_forms():
    c = Client("http://example.com:8123")
    assert (c.host, c.port) == ("example.com", 8123)
    c = Client("example.com:8123")
    assert (c.host, c.port) == ("example.com", 8123)
    c = Client("http://example.com")
    assert (c.host, c.port) == ("example.com", 80)
    with pytest.raises(ValueError):
        Client("https://example.com")


def test_base_url_ipv6_and_userinfo():
    c = Client("http://[::1]:8123")
    assert (c.host, c.port) == ("::1", 8123)
    c = Client("http://user@example.com:8123")
    assert (c.host, c.port) == ("example.com", 8123)
    with pytest.raises(ValueError):
        Client("http://example.com:notaport")


def test_disposition_filename_escaped():
    # a hostile filename must not inject headers or break the frame
    fh = io.BytesIO(b"data")
    s = client_mod._MultipartStream({}, ("file", 'a "b"\r\n.mp4', fh, 4))
    pre = s._preamble()
    assert b'filename="a %22b%22%0D%0A.mp4"' in pre
    # no raw CR/LF/quote survives inside the parameter value
    start = pre.index(b'filename="') + len(b'filename="')
    end = pre.index(b'"', start)
    assert b"\r" not in pre[start:end] and b"\n" not in pre[start:end]


def test_post_retries_connection_setup(server):
    # the documented POST contract: connection-setup failures retry
    # (the request was never received).  Bind a port, release it, and
    # start the real server there only after a delay — the client's
    # first connect is refused, a later retry lands, and the request
    # completes (as an APIError, proving it reached the app).
    import socket
    import time as _time

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    application = app_mod.build_app(device="cpu")
    srv_box = {}

    def later():
        _time.sleep(0.7)
        srv = http_mod.make_server(application, "127.0.0.1", port)
        srv_box["srv"] = srv
        srv.serve_forever()

    t = threading.Thread(target=later, daemon=True)
    t.start()
    try:
        c = Client(f"http://127.0.0.1:{port}", timeout=10,
                   retries=8, backoff_s=0.2)
        with pytest.raises(APIError) as ei:
            c._post_form("/predict", {})
        assert ei.value.status == 422
    finally:
        deadline = _time.time() + 10
        while "srv" not in srv_box and _time.time() < deadline:
            _time.sleep(0.05)
        if "srv" in srv_box:
            srv_box["srv"].shutdown()


def test_multipart_stream_content_length_exact():
    payload = b"x" * (3 * (1 << 20) + 17)  # spans multiple chunks
    fh = io.BytesIO(payload)
    s = client_mod._MultipartStream({"k": "v"},
                                    ("file", "a.bin", fh, len(payload)))
    chunks = list(s.chunks())
    assert sum(len(c) for c in chunks) == s.content_length
    body = b"".join(chunks)
    assert payload in body and b'name="k"' in body


def test_result_wrapper_defaults():
    r = AnalysisResult({})
    assert r.ok is False and r.ai_score == 0.0 and r.label == ""
    assert r.timeline == [] and r.forensic is None


def test_analyze_url_without_resolver(server):
    # USE_YTDLP defaults off and the direct-link fallback rejects a
    # non-fetchable URL — either way the client surfaces an APIError with
    # the Italian detail, never a transport error.
    c = Client(f"http://127.0.0.1:{server}", timeout=30)
    with pytest.raises(APIError) as ei:
        c.analyze_url("http://127.0.0.1:9/nope.mp4")
    assert ei.value.status in (413, 415, 422, 500)


def test_json_contract_roundtrip(server, clip):
    """The typed accessors agree with the raw JSON the service sent."""
    c = Client(f"http://127.0.0.1:{server}")
    res = c.analyze(clip)
    raw = json.loads(json.dumps(res.raw))
    assert res.ai_score == raw["result"]["ai_score"]
    assert res.timeline == raw["timeline_binned"]


def test_analyze_many_order_and_error_isolation(server, clip, tmp_path):
    """Concurrent fan-out: order preserved, per-file failures returned
    (not raised), good files still analyzed."""
    missing = str(tmp_path / "missing.mp4")
    c = Client(f"http://127.0.0.1:{server}")
    out = c.analyze_many([clip, missing, clip], workers=3)
    assert [p for p, _ in out] == [clip, missing, clip]
    assert isinstance(out[0][1], AnalysisResult) and out[0][1].ok
    assert isinstance(out[1][1], Exception)
    assert isinstance(out[2][1], AnalysisResult)
    assert out[0][1].ai_score == out[2][1].ai_score


def _json_tail(out: str):
    """Parse the CLI's JSON from captured stdout, skipping the
    in-process server's access-log lines (stdout by design, mirroring
    gunicorn's accesslog='-')."""
    return json.loads(out[out.index("{"):])


def test_cli_health_and_single(server, clip, capsys):
    base = f"127.0.0.1:{server}"
    assert client_mod.main([base, "health"]) == 0
    assert _json_tail(capsys.readouterr().out)["ok"] is True
    assert client_mod.main([base, "analyze", clip]) == 0
    env = _json_tail(capsys.readouterr().out)
    assert env["ok"] is True and "result" in env


def test_cli_batch_jsonl_mixed(server, clip, tmp_path, capsys):
    missing = str(tmp_path / "gone.mp4")
    base = f"127.0.0.1:{server}"
    rc = client_mod.main([base, "analyze", clip, missing,
                          "--jsonl", "--workers", "2"])
    assert rc == 1  # one failure recorded
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()
             if l.startswith("{")]
    assert [l["path"] for l in lines] == [clip, missing]
    assert "response" in lines[0] and "error" in lines[1]


def test_cli_transport_error_exit_code():
    assert client_mod.main(["127.0.0.1:1", "--timeout", "0.5",
                            "health"]) == 1


def test_client_speaks_to_avd_tpu_service(server, clip):
    """The port's client against ``avd_tpu``'s app: the same envelope
    keys and label as from the port's app (both on the host path)."""
    srv = http_mod.make_server(japp.build_app(), "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        ref = Client(f"http://127.0.0.1:{srv.server_address[1]}")
        assert "tpu" in ref.ready()
        theirs = ref.analyze(clip)
    finally:
        srv.shutdown()
    ours = Client(f"http://127.0.0.1:{server}").analyze(clip)
    assert list(ours.raw) == list(theirs.raw)
    assert ours.label == theirs.label
    assert abs(ours.ai_score - theirs.ai_score) <= 1e-3
