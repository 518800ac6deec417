"""The port's URL resolver (``avd_tpu_torch.ingest.url``): the cases of
tests/test_url_resolver.py — the native direct-link download (served from
localhost, no egress), size caps, error mapping (api.py:172-210
semantics), the yt-dlp branch through an injected fake module — on the
port's app with ``device="cpu"``, plus the same outcomes as ``avd_tpu``'s
resolver."""

import functools
import http.server
import json
import os
import threading

import pytest

from avd_tpu import config as jconfig
from avd_tpu.ingest import url as jurl
from avd_tpu_torch import config as config_mod
from avd_tpu_torch.ingest import url as url_mod
from avd_tpu_torch.serve import app as app_mod
from avd_tpu_torch.serve import http as http_mod
from avd_tpu_torch.serve.http import BodyStream, HTTPError, Request
from tests import fixtures
from tests.test_torch_serve import _request


@pytest.fixture(scope="module")
def file_server(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    clip = fixtures.noise_clip(30, 64)
    fixtures.write_video(root / "clip.mp4", clip, fps=30.0)
    (root / "big.bin").write_bytes(b"\x00" * 300_000)

    handler = functools.partial(http.server.SimpleHTTPRequestHandler,
                                directory=str(root))
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield f"http://127.0.0.1:{srv.server_address[1]}"
    srv.shutdown()


def test_direct_download(file_server):
    out = url_mod.resolve(f"{file_server}/clip.mp4", 10_000_000)
    try:
        assert os.path.getsize(out["path"]) > 1000
        assert out["resolved_url"].endswith("/clip.mp4")
        assert out["path"].endswith(".mp4")
    finally:
        os.unlink(out["path"])


def test_direct_download_too_large(file_server):
    with pytest.raises(HTTPError) as ei:
        url_mod.resolve(f"{file_server}/big.bin", 100_000)
    assert ei.value.status == 413
    assert ei.value.detail["error"] == "File troppo grande dal provider"


def test_unsupported_scheme():
    with pytest.raises(HTTPError) as ei:
        url_mod.resolve("ftp://example.com/x.mp4", 1000)
    assert ei.value.status == 415
    assert ei.value.detail["error"] == "URL non supportato"


def test_connection_refused_maps_to_415():
    with pytest.raises(HTTPError) as ei:
        url_mod.resolve("http://127.0.0.1:1/x.mp4", 1000)
    assert ei.value.status == 415


def test_gate_disabled(monkeypatch):
    monkeypatch.setenv("USE_YTDLP", "0")
    config_mod.reset_config()
    try:
        with pytest.raises(HTTPError) as ei:
            url_mod.resolve("http://example.com/x.mp4", 1000)
        assert ei.value.status == 422
        assert ei.value.detail["error"] == "yt-dlp disabilitato"
    finally:
        monkeypatch.delenv("USE_YTDLP")
        config_mod.reset_config()


def test_end_to_end_analyze_url(file_server, monkeypatch):
    """POST /analyze-url with a local direct link → full analysis JSON."""
    monkeypatch.setenv("AVD_BACKEND", "oracle")
    config_mod.reset_config()
    try:
        srv = http_mod.make_server(app_mod.build_app(device="cpu"),
                                   "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            body = f"url={file_server}/clip.mp4".encode()
            status, _, data = _request(
                srv.server_address[1], "POST", "/analyze-url", body,
                {"Content-Type": "application/x-www-form-urlencoded",
                 "Content-Length": str(len(body))})
            assert status == 200
            d = json.loads(data)
            assert d["ok"] is True
            assert d["meta"]["source_url"].endswith("/clip.mp4")
            assert d["meta"]["resolved_url"].endswith("/clip.mp4")
            assert d["result"]["label"] in ("real", "ai", "uncertain")
        finally:
            srv.shutdown()
    finally:
        monkeypatch.delenv("AVD_BACKEND")
        config_mod.reset_config()


def test_cors_origin_restriction(monkeypatch):
    monkeypatch.setenv("ALLOWED_ORIGINS",
                       "https://app.example.com,https://b.example.com")
    config_mod.reset_config()
    try:
        application = app_mod.build_app(device="cpu")
        req = Request("GET", "/healthz", {}, {
            "Origin": "https://app.example.com"}, BodyStream(None, 0))
        resp = application.dispatch(req)
        assert resp.headers["Access-Control-Allow-Origin"] == \
            "https://app.example.com"
        assert resp.headers.get("Vary") == "Origin"
        req = Request("GET", "/healthz", {}, {
            "Origin": "https://evil.example.com"}, BodyStream(None, 0))
        resp = application.dispatch(req)
        # disallowed origin: the header is OMITTED (Starlette
        # CORSMiddleware behavior in the reference), never another origin
        assert "Access-Control-Allow-Origin" not in resp.headers
    finally:
        monkeypatch.delenv("ALLOWED_ORIGINS")
        config_mod.reset_config()


# ---------------------------------------------------------------------------
# The REAL yt-dlp branch (ingest/url.py::_ytdlp_download) via an injected
# fake module — yt-dlp is not installed in this image, so without
# injection the branch never executes (reference: api.py:172-210).
# ---------------------------------------------------------------------------

def _install_fake_ytdlp(monkeypatch, extract):
    """Install a minimal yt_dlp into sys.modules; returns the dict where
    the fake captures the opts/url it was driven with."""
    import sys
    import types

    captured = {}
    mod = types.ModuleType("yt_dlp")
    utils = types.ModuleType("yt_dlp.utils")

    class DownloadError(Exception):
        pass

    utils.DownloadError = DownloadError
    mod.utils = utils

    class YoutubeDL:
        def __init__(self, opts):
            captured["opts"] = opts

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def extract_info(self, url, download=True):
            captured["url"] = url
            captured["download"] = download
            return extract(url)

    mod.YoutubeDL = YoutubeDL
    monkeypatch.setitem(sys.modules, "yt_dlp", mod)
    monkeypatch.setitem(sys.modules, "yt_dlp.utils", utils)
    return captured, DownloadError


def test_ytdlp_download_success_and_opts(monkeypatch):
    """The download path builds the reference's yt-dlp options
    (api.py:178-191): outtmpl to a temp .mp4, max_filesize from the
    caller, the RESOLVER_UA user agent, best A/V format — and returns
    the resolved URL from extract_info."""
    monkeypatch.setenv("RESOLVER_UA", "avd-test-agent/1.0")
    config_mod.reset_config()
    captured, _ = _install_fake_ytdlp(
        monkeypatch, lambda url: {"url": "https://cdn.example/v.mp4",
                                  "webpage_url": url})
    out = url_mod.resolve("https://video.example/watch?v=1", 12_345)
    try:
        assert out["resolved_url"] == "https://cdn.example/v.mp4"
        assert captured["download"] is True
        opts = captured["opts"]
        assert opts["outtmpl"] == out["path"]
        assert out["path"].endswith(".mp4")
        assert opts["max_filesize"] == 12_345
        assert opts["user_agent"] == "avd-test-agent/1.0"
        assert opts["http_headers"]["User-Agent"] == "avd-test-agent/1.0"
        assert opts["format"] == "bv*+ba/best"
        assert opts["noplaylist"] is True
    finally:
        os.unlink(out["path"])
        config_mod.reset_config()


@pytest.mark.parametrize("msg,status,error_it", [
    ("This video requires login to view", 415,
     "Contenuto protetto da login / cookies"),
    ("ERROR: Unsupported URL: https://x", 415, "URL non supportato"),
    ("File is larger than max-filesize / too large", 413,
     "File troppo grande dal provider"),
    ("HTTP Error 429: rate limited", 415, "Errore di download"),
])
def test_ytdlp_download_error_mapping(monkeypatch, msg, status, error_it):
    """DownloadError strings map to the reference's 415/413 Italian
    hints (api.py:196-206), and the temp file is cleaned up."""
    def raise_dl(url):
        raise DownloadError(msg)

    captured, DownloadError = _install_fake_ytdlp(monkeypatch, raise_dl)
    with pytest.raises(HTTPError) as ei:
        url_mod.resolve("https://video.example/x", 999)
    assert ei.value.status == status
    assert ei.value.detail["error"] == error_it
    if status == 413:
        assert ei.value.detail["limit_bytes"] == 999
    assert not os.path.exists(captured["opts"]["outtmpl"])


def test_ytdlp_unexpected_exception_maps_to_415(monkeypatch):
    def boom(url):
        raise RuntimeError("socket reset")

    captured, _ = _install_fake_ytdlp(monkeypatch, boom)
    with pytest.raises(HTTPError) as ei:
        url_mod.resolve("https://video.example/x", 999)
    assert ei.value.status == 415
    assert ei.value.detail["error"] == "Impossibile scaricare il video"
    assert "socket reset" in ei.value.detail["exception"]
    assert not os.path.exists(captured["opts"]["outtmpl"])


@pytest.mark.parametrize("case", ["ok", "too_large", "ftp", "refused"])
def test_outcomes_match_avd_tpu(file_server, case):
    """The same URL through both resolvers: the same status and detail,
    or the same downloaded bytes."""
    url, cap = {"ok": (f"{file_server}/clip.mp4", 10_000_000),
                "too_large": (f"{file_server}/big.bin", 100_000),
                "ftp": ("ftp://example.com/x.mp4", 1000),
                "refused": ("http://127.0.0.1:1/x.mp4", 1000)}[case]
    jconfig.reset_config()
    got = []
    for resolve in (url_mod.resolve, jurl.resolve):
        try:
            out = resolve(url, cap)
        except Exception as e:
            got.append((type(e).__name__, e.status, e.detail))
            continue
        with open(out["path"], "rb") as f:
            got.append((out["resolved_url"], f.read()))
        os.unlink(out["path"])
    assert got[0] == got[1]
    jconfig.reset_config()
