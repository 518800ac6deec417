"""Minimal HTTP server framework (stdlib only).

Port of ``avd_tpu/serve/http.py``, the same code.

Provides what the reference gets from FastAPI (api.py:29-37,213-266):
routing, CORS middleware, JSON responses, HTTPException-style error
shortcuts, and — the part that matters for large uploads — a *streaming*
multipart/form-data parser that spools file parts to disk in 1 MiB chunks
with a hard size cap, mirroring ``_save_upload_to_tmp`` (api.py:91-108).
"""

from __future__ import annotations

import json
import os
import socketserver
import tempfile
import threading
import traceback
from http.server import BaseHTTPRequestHandler
from typing import Any, Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse


class HTTPError(Exception):
    """FastAPI-HTTPException equivalent: status + JSON detail
    (+ optional response headers, e.g. Retry-After on a 503)."""

    def __init__(self, status: int, detail: Any,
                 headers: Optional[Dict[str, str]] = None):
        super().__init__(str(detail))
        self.status = status
        self.detail = detail
        self.headers = headers or {}


class UploadedFile:
    """A multipart file part spooled to a temp file."""

    def __init__(self, filename: str, path: str, size: int):
        self.filename = filename
        self.path = path
        self.size = size

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except OSError:
            pass


class BodyStream:
    """Unified request-body reader.

    Handles both framings the reference accepts through uvicorn
    (api.py:91-108 reads UploadFile regardless of transfer encoding):

    * ``Content-Length``: plain bounded reads;
    * ``Transfer-Encoding: chunked``: de-framed transparently (hex size
      line, chunk payload, CRLF, zero-chunk + optional trailers).

    ``read(n)`` returns up to n payload bytes, b"" at end-of-body;
    ``finished`` tells the keep-alive layer whether the body was fully
    consumed (an unconsumed body forces Connection: close so the next
    pipelined request doesn't parse leftover bytes)."""

    def __init__(self, rfile, content_length: int = 0,
                 chunked: bool = False):
        self._rfile = rfile
        self._chunked = chunked
        self._remaining = content_length
        self._chunk_left = 0
        self.finished = (content_length <= 0) and not chunked
        # set on a framing error: the body length is unknowable, so the
        # connection must be closed even though reads have stopped
        self.broken = False
        # `Expect: 100-continue` hook (RFC 9110 §10.1.1): set by the
        # handler to a callable that writes the interim `100 Continue`
        # response.  Fired lazily on the FIRST body read — the uvicorn
        # behavior the reference inherits: a request rejected before its
        # body is touched (413 precheck, 503 shed) gets the final status
        # directly, while curl's default large-upload flow (send Expect,
        # stall up to 1 s for the interim response) proceeds immediately.
        self.on_first_read = None

    def read(self, n: int) -> bytes:
        if self.on_first_read is not None:
            cb, self.on_first_read = self.on_first_read, None
            cb()
        if self.finished or n <= 0:
            return b""
        if self._chunked:
            return self._read_chunked(n)
        take = min(n, self._remaining)
        data = self._rfile.read(take)
        self._remaining -= len(data)
        if self._remaining <= 0 or not data:
            if not data and self._remaining > 0:
                self.broken = True  # EOF before Content-Length delivered
            self.finished = True
        return data

    def _read_chunked(self, n: int) -> bytes:
        if self._chunk_left == 0:
            line = self._rfile.readline(1024)
            if not line:
                # connection EOF where a chunk-size line was due: the
                # upload is TRUNCATED, not complete — treating it as the
                # final zero chunk would spend a full analysis pass on a
                # half-written file
                self.finished = True
                self.broken = True
                raise HTTPError(400, {"error": "framing chunked non valido"})
            try:
                size = int(line.split(b";")[0].strip() or b"0", 16)
            except ValueError:
                self.finished = True
                self.broken = True
                raise HTTPError(400, {"error": "framing chunked non valido"})
            if size == 0:
                while True:  # consume optional trailers up to blank line
                    t = self._rfile.readline(1024)
                    if t in (b"\r\n", b"\n", b""):
                        break
                self.finished = True
                return b""
            self._chunk_left = size
        take = min(n, self._chunk_left)
        data = self._rfile.read(take)
        self._chunk_left -= len(data)
        if self._chunk_left == 0:
            self._rfile.read(2)  # chunk-terminating CRLF
        if not data:
            self.finished = True
            self.broken = True  # EOF inside a declared chunk
        return data

    def drain(self, cap: int = 64 * 1024 * 1024) -> bool:
        """Consume the rest of the body (keep-alive hygiene); returns
        False when more than ``cap`` bytes remained (caller closes)."""
        spent = 0
        while not self.finished:
            chunk = self.read(_CHUNK)
            if not chunk:
                break
            spent += len(chunk)
            if spent > cap:
                return False
        return True


class Request:
    def __init__(self, method: str, path: str, query: Dict[str, str],
                 headers, body_stream: "BodyStream"):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers
        self._stream = body_stream
        self._body: Optional[bytes] = None

    @property
    def stream(self) -> "BodyStream":
        return self._stream

    def body(self) -> bytes:
        """Full body, like Starlette's request.body() (api.py:231)."""
        if self._body is None:
            parts = []
            while True:
                chunk = self._stream.read(_CHUNK)
                if not chunk:
                    break
                parts.append(chunk)
            self._body = b"".join(parts)
        return self._body


_CHUNK = 1024 * 1024  # 1 MiB spool chunks (api.py:96)


def parse_multipart(req: Request, max_file_bytes: int,
                    too_large_detail: Callable[[], Any]):
    """Stream a multipart/form-data body.

    Returns (files: {name: UploadedFile}, fields: {name: str}).  File parts
    stream to NamedTemporaryFiles in 1 MiB chunks; exceeding
    ``max_file_bytes`` raises HTTPError 413 with the reference's Italian
    detail (api.py:101-102) after cleaning up the spool file.
    """
    ctype = req.headers.get("Content-Type", "")
    if "multipart/form-data" not in ctype or "boundary=" not in ctype:
        raise HTTPError(422, {"error": "Content-Type multipart/form-data richiesto"})
    # boundary may not be the last Content-Type parameter (RFC 2046)
    boundary = ctype.split("boundary=", 1)[1].split(";", 1)[0] \
        .strip().strip('"')
    delim = b"--" + boundary.encode()

    stream = req.stream
    buf = b""
    files: Dict[str, UploadedFile] = {}
    fields: Dict[str, str] = {}

    def fill(n: int = _CHUNK) -> bool:
        nonlocal buf
        chunk = stream.read(n)
        if not chunk:
            return False
        buf += chunk
        return True

    # scan to the first boundary.  The preamble is discardable (RFC 2046)
    # — keep only a possible partial-delimiter tail so a body that never
    # contains the boundary can't buffer itself into worker OOM.
    while delim not in buf:
        if len(buf) > len(delim):
            buf = buf[-(len(delim) - 1):]
        if not fill():
            break
    if delim not in buf:
        raise HTTPError(422, {"error": "Corpo multipart non valido"})
    buf = buf.split(delim, 1)[1]

    try:
        while True:
            # boundary suffix: "--" = end, CRLF = next part
            while len(buf) < 2 and fill():
                pass
            if buf.startswith(b"--"):
                break
            buf = buf.lstrip(b"\r\n")
            # headers — a part whose header block never terminates is
            # malformed, and letting the scan keep buffering would hold
            # the whole body in RAM
            while b"\r\n\r\n" not in buf and fill():
                if len(buf) > 64 * 1024:
                    raise HTTPError(422,
                                    {"error": "Corpo multipart non valido"})
            if b"\r\n\r\n" not in buf:
                break
            raw_hdr, buf = buf.split(b"\r\n\r\n", 1)
            disp: Dict[str, str] = {}
            for line in raw_hdr.decode("latin-1").split("\r\n"):
                if ":" not in line:
                    continue
                k, v = line.split(":", 1)
                if k.strip().lower() == "content-disposition":
                    for item in v.split(";"):
                        item = item.strip()
                        if "=" in item:
                            ik, iv = item.split("=", 1)
                            disp[ik.strip()] = iv.strip().strip('"')
            name = disp.get("name", "")
            filename = disp.get("filename")

            marker = b"\r\n" + delim
            if filename is not None:
                suffix = os.path.splitext(filename)[1] or ".bin"
                tmp = tempfile.NamedTemporaryFile(delete=False, suffix=suffix)
                size = 0
                try:
                    while True:
                        idx = buf.find(marker)
                        if idx >= 0:
                            tmp.write(buf[:idx])
                            size += idx
                            if size > max_file_bytes:
                                raise HTTPError(413, too_large_detail())
                            buf = buf[idx + len(marker):]
                            break
                        # keep a marker-sized tail to avoid splitting it
                        emit = buf[:-len(marker)] if len(buf) > len(marker) \
                            else b""
                        tmp.write(emit)
                        size += len(emit)
                        if size > max_file_bytes:
                            raise HTTPError(413, too_large_detail())
                        buf = buf[len(emit):]
                        if not fill():
                            # EOF before the part's closing boundary: the
                            # upload is truncated — reject rather than
                            # spend an analysis pass on a half-written file
                            raise HTTPError(
                                400, {"error": "Corpo multipart non valido"})
                    tmp.close()
                except BaseException:
                    tmp.close()
                    try:
                        os.unlink(tmp.name)
                    except OSError:
                        pass
                    raise
                files[name] = UploadedFile(filename, tmp.name, size)
            else:
                # fields buffer in memory — apply the same size cap so a
                # giant filename-less part can't OOM the worker
                while marker not in buf and fill():
                    if len(buf) > max_file_bytes:
                        raise HTTPError(413, too_large_detail())
                idx = buf.find(marker)
                if idx < 0:  # EOF before the closing boundary: truncated
                    raise HTTPError(
                        400, {"error": "Corpo multipart non valido"})
                value, buf = buf[:idx], buf[idx + len(marker):]
                fields[name] = value.decode("utf-8", "ignore")
    except HTTPError:
        for f in files.values():
            f.unlink()
        raise
    return files, fields


class Response:
    def __init__(self, content: Any = None, status: int = 200,
                 headers: Optional[Dict[str, str]] = None,
                 raw: Optional[bytes] = None):
        self.status = status
        self.headers = headers or {}
        if raw is not None:
            self.body = raw
        elif content is None:
            self.body = b""
        else:
            # byte-compatible with the reference's Starlette JSONResponse
            # (compact separators, raw UTF-8 — api.py responses)
            self.body = json.dumps(content, ensure_ascii=False,
                                   separators=(",", ":")).encode("utf-8")
            self.headers.setdefault("Content-Type", "application/json")


class App:
    """Route table + CORS + error handling."""

    def __init__(self, allowed_origins: str = "*", debug: bool = False):
        self._routes: Dict[Tuple[str, str], Callable] = {}
        self._options_handler: Optional[Callable] = None
        self.allowed_origins = [o.strip() for o in allowed_origins.split(",")
                                if o.strip()] or ["*"]
        self.debug = debug

    def route(self, method: str, path: str):
        def deco(fn):
            self._routes[(method.upper(), path)] = fn
            return fn
        return deco

    def options_catchall(self, fn):
        self._options_handler = fn
        return fn

    _ALL_METHODS = "DELETE, GET, HEAD, OPTIONS, PATCH, POST, PUT"

    def _cors_headers(self, origin: Optional[str],
                      has_cookie: bool) -> Dict[str, str]:
        """Simple-response CORS headers, mirroring the reference's
        Starlette CORSMiddleware (api.py:31-37, allow_credentials=True):
        nothing without an Origin; wildcard sends ``*`` except for
        credentialed (cookie-carrying) requests, which get the origin
        echoed; a non-wildcard list echoes allowed origins and omits the
        header for disallowed ones."""
        if not origin:
            return {}
        out = {"Access-Control-Allow-Credentials": "true"}
        if "*" in self.allowed_origins:
            if has_cookie:
                out["Access-Control-Allow-Origin"] = origin
                out["Vary"] = "Origin"
            else:
                out["Access-Control-Allow-Origin"] = "*"
        elif origin in self.allowed_origins:
            out["Access-Control-Allow-Origin"] = origin
            out["Vary"] = "Origin"
        return out

    def _preflight(self, req: Request, origin: str) -> Response:
        """CORS preflight (OPTIONS + Origin + Access-Control-Request-
        Method), intercepted before routing like CORSMiddleware."""
        headers = {"Access-Control-Allow-Credentials": "true",
                   "Access-Control-Allow-Methods": self._ALL_METHODS,
                   "Access-Control-Max-Age": "600"}
        req_headers = req.headers.get("Access-Control-Request-Headers")
        if req_headers:
            headers["Access-Control-Allow-Headers"] = req_headers
        if "*" in self.allowed_origins:
            headers["Access-Control-Allow-Origin"] = "*"
        elif origin in self.allowed_origins:
            headers["Access-Control-Allow-Origin"] = origin
            headers["Vary"] = "Origin"
        else:
            return Response(raw=b"Disallowed CORS origin", status=400,
                            headers={"Content-Type": "text/plain"})
        return Response(raw=b"OK", status=200, headers={
            "Content-Type": "text/plain", **headers})

    def dispatch(self, req: Request) -> Response:
        origin = req.headers.get("Origin")
        if (req.method == "OPTIONS" and origin
                and req.headers.get("Access-Control-Request-Method")):
            return self._preflight(req, origin)
        cors = self._cors_headers(origin,
                                  bool(req.headers.get("Cookie")))
        try:
            if req.method == "OPTIONS":
                resp = (self._options_handler(req) if self._options_handler
                        else Response(status=204))
            else:
                handler = self._routes.get((req.method, req.path))
                if handler is None:
                    if any(p == req.path for _, p in self._routes):
                        # path exists under another method (FastAPI: 405)
                        resp = Response({"detail": "Method Not Allowed"},
                                        status=405)
                    else:
                        resp = Response({"detail": "Not Found"}, status=404)
                else:
                    resp = handler(req)
        except HTTPError as e:
            resp = Response({"detail": e.detail}, status=e.status,
                            headers=dict(e.headers))
        except Exception as e:
            # global exception handler (api.py:269-280)
            if self.debug:
                resp = Response({"ok": False, "detail": {
                    "error": str(e),
                    "exception": e.__class__.__name__,
                    "traceback": traceback.format_exc(),
                }}, status=500)
            else:
                resp = Response(
                    {"ok": False,
                     "detail": {"error": "Internal server error"}},
                    status=500)
        resp.headers.update(cors)
        return resp


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    app: App = None  # set by make_server

    def handle_expect_100(self):
        # Defer the interim `100 Continue`: the stdlib default sends it
        # EAGERLY right after the headers, but uvicorn (the behavior the
        # reference exposes) sends it lazily when the app first reads
        # the body — a request rejected body-unread gets the final
        # status directly.  _handle_inner arms BodyStream.on_first_read
        # with the actual send; returning True proceeds to the handler.
        return True

    def _handle(self):
        began = getattr(self.server, "request_began", None)
        if began:
            began()
        try:
            self._handle_inner()
        finally:
            done = getattr(self.server, "request_done", None)
            if done:
                done()

    def _handle_inner(self):
        parsed = urlparse(self.path)
        query = {k: v[0] for k, v in parse_qs(parsed.query).items()}
        chunked = "chunked" in (
            self.headers.get("Transfer-Encoding") or "").lower()
        length = 0 if chunked else int(
            self.headers.get("Content-Length") or 0)
        body = BodyStream(self.rfile, content_length=length,
                          chunked=chunked)
        # `Expect: 100-continue` (RFC 9110): HTTP/1.1 clients (curl's
        # default on large uploads — exactly this service's workload)
        # send the header and wait for the interim response before
        # transmitting the body.  Arm the lazy hook; BodyStream fires it
        # on the first actual body read (see BodyStream.on_first_read).
        if (self.request_version >= "HTTP/1.1"
                and "100-continue" in
                (self.headers.get("Expect") or "").lower()):
            def _send_continue():
                try:
                    self.wfile.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass
            body.on_first_read = _send_continue
        # HEAD routes like GET (Starlette auto-adds HEAD to GET routes)
        # but must not carry a body (RFC 9110)
        is_head = self.command == "HEAD"
        method = "GET" if is_head else self.command
        req = Request(method, parsed.path, query, self.headers, body)
        resp = self.app.dispatch(req)
        # the final response supersedes the interim one: a route that
        # never read the body must not emit `100 Continue` during the
        # post-response keep-alive drain below
        body.on_first_read = None
        # keep-alive hygiene: the next pipelined request must not parse
        # leftover body bytes.  An unconsumed or broken body closes the
        # connection; the response goes out FIRST so an early 413/400
        # isn't delayed behind draining a slow multi-MB upload.
        if body.broken or not body.finished:
            self.close_connection = True
            resp.headers["Connection"] = "close"
        if getattr(self.server, "draining", False):
            self.close_connection = True
            resp.headers.setdefault("Connection", "close")
        try:
            self.send_response(resp.status)
            for k, v in resp.headers.items():
                self.send_header(k, v)
            self.send_header("Content-Length", str(len(resp.body)))
            self.end_headers()
            if resp.body and not is_head:
                self.wfile.write(resp.body)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionResetError):
            pass
        # bounded best-effort drain AFTER the response is on the wire, so
        # the client sees it before any RST from closing with unread data
        if not body.broken and not body.finished:
            try:
                body.drain()
            except Exception:
                pass

    do_GET = do_POST = do_PUT = do_DELETE = do_OPTIONS = do_HEAD = _handle

    def log_message(self, fmt, *args):  # access log to stdout
        print(f'{self.address_string()} - "{fmt % args}"', flush=True)


class ThreadingHTTPServer(socketserver.ThreadingMixIn,
                          socketserver.TCPServer):
    daemon_threads = True
    allow_reuse_address = True
    # socketserver's default listen backlog is 5; a burst of concurrent
    # clients overflows the accept queue and the kernel RSTs the excess
    # mid-request (observed as client-side ECONNRESET under the stress
    # suite).  The reference's uvicorn listens with backlog 2048.
    request_queue_size = 2048
    # Drain: daemon handler threads are NOT tracked by socketserver's
    # _Threads (it skips daemons), so server_close() alone would return
    # with requests still in flight and a worker's sys.exit would kill
    # them mid-analysis.  We count in-flight REQUESTS (not connections —
    # an idle keep-alive connection must not block retirement) and wait
    # them out, telling handlers to stop keeping alive meanwhile.
    drain_timeout: float = 30.0

    def __init__(self, *args, **kwargs):
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        self._idle = threading.Event()
        self._idle.set()
        self.draining = False
        super().__init__(*args, **kwargs)

    def request_began(self) -> None:
        with self._inflight_lock:
            self._inflight += 1
            self._idle.clear()

    def request_done(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1
            if self._inflight <= 0:
                self._idle.set()

    def server_close(self):
        self.draining = True
        super().server_close()
        self._idle.wait(self.drain_timeout)


def make_server(app: App, host: str, port: int,
                reuse_port: bool = False) -> ThreadingHTTPServer:
    import socket as _socket

    handler = type("BoundHandler", (_Handler,), {"app": app})

    class _Server(ThreadingHTTPServer):
        def server_bind(self):
            if reuse_port and hasattr(_socket, "SO_REUSEPORT"):
                # pre-fork workers all bind the same port (master.py)
                self.socket.setsockopt(_socket.SOL_SOCKET,
                                       _socket.SO_REUSEPORT, 1)
            super().server_bind()

    return _Server((host, port), handler)
