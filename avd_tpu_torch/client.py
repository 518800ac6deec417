"""Python client for the avd_tpu_torch HTTP service (stdlib-only).

Port of ``avd_tpu/client.py``; it speaks to either package's service.

The reference exposes its service over bare HTTP and documents curl
invocations only (the reference's README.md:9-24); this module gives
framework users a typed client for the same surface — the upload routes
(`POST /analyze`, `/predict`, api.py:235-253), the URL route
(`POST /analyze-url`, api.py:255-266) and the health/metrics endpoints —
so switching a reference deployment to the port needs no hand-rolled
multipart code.

No third-party dependencies: multipart bodies are framed by hand and
sent over ``http.client`` with a streaming file reader (uploads are never
buffered whole in memory).

Example::

    from avd_tpu_torch.client import Client
    c = Client("http://127.0.0.1:8000")
    res = c.analyze("clip.mp4")
    print(res.label, res.ai_score, res.confidence)
"""

from __future__ import annotations

import http.client
import io
import json
import os
import time
import urllib.parse
import uuid
from dataclasses import dataclass, field
from typing import Any, BinaryIO, Dict, Iterator, Optional, Tuple

_CHUNK = 1 << 20  # streaming upload chunk (matches the server's 1 MiB spool)


def _quote_disposition(value: str) -> str:
    """Escape a Content-Disposition parameter value (RFC 7578 §4.2:
    percent-encode CR/LF/double-quote so a hostile filename can't inject
    headers or break the multipart frame)."""
    return (value.replace("%", "%25").replace("\r", "%0D")
            .replace("\n", "%0A").replace('"', "%22"))


class ClientError(Exception):
    """Transport-level failure (connection refused, timeout, bad JSON)."""


class APIError(ClientError):
    """Non-2xx response from the service, carrying the decoded detail —
    e.g. the 413 ``{"error": "File troppo grande", "limit_bytes": …}``
    contract from api.py:101-102."""

    def __init__(self, status: int, detail: Any,
                 retry_after: Optional[float] = None):
        self.status = status
        self.detail = detail
        # parsed Retry-After header on load-shed 503s (serve/app.py)
        self.retry_after = retry_after
        super().__init__(f"HTTP {status}: {detail}")


@dataclass
class AnalysisResult:
    """Typed view over the reference-shaped response envelope
    (api.py:151-166).  ``raw`` always holds the full JSON dict."""

    raw: Dict[str, Any]

    @property
    def ok(self) -> bool:
        return bool(self.raw.get("ok"))

    @property
    def result(self) -> Dict[str, Any]:
        return self.raw.get("result") or {}

    @property
    def ai_score(self) -> float:
        return float(self.result.get("ai_score", 0.0))

    @property
    def confidence(self) -> float:
        return float(self.result.get("confidence", 0.0))

    @property
    def label(self) -> str:
        return str(self.result.get("label", ""))

    @property
    def reason(self) -> str:
        return str(self.result.get("reason", ""))

    @property
    def timeline(self) -> list:
        return list(self.raw.get("timeline_binned") or [])

    @property
    def peaks(self) -> list:
        return list(self.raw.get("peaks") or [])

    @property
    def meta(self) -> Dict[str, Any]:
        return self.raw.get("meta") or {}

    @property
    def hints(self) -> Dict[str, Any]:
        return self.raw.get("hints") or {}

    @property
    def forensic(self) -> Optional[Dict[str, Any]]:
        return self.raw.get("forensic")


class _MultipartStream:
    """Iterator of body chunks for one file part + optional form fields,
    with a precomputed Content-Length so keep-alive framing stays exact."""

    def __init__(self, fields: Dict[str, str],
                 file_part: Optional[Tuple[str, str, BinaryIO, int]]):
        self.boundary = "avdclient" + uuid.uuid4().hex
        self._fields = fields
        self._file = file_part  # (name, filename, fh, size)

    def _preamble(self) -> bytes:
        out = io.BytesIO()
        for name, value in self._fields.items():
            out.write(
                f"--{self.boundary}\r\nContent-Disposition: form-data; "
                f"name=\"{_quote_disposition(name)}\"\r\n\r\n"
                f"{value}\r\n".encode())
        if self._file is not None:
            name, filename, _, _ = self._file
            out.write(
                f"--{self.boundary}\r\nContent-Disposition: form-data; "
                f"name=\"{_quote_disposition(name)}\"; "
                f"filename=\"{_quote_disposition(filename)}\"\r\n"
                f"Content-Type: application/octet-stream\r\n\r\n".encode())
        return out.getvalue()

    def _epilogue(self) -> bytes:
        tail = b"\r\n" if self._file is not None else b""
        return tail + f"--{self.boundary}--\r\n".encode()

    @property
    def content_length(self) -> int:
        n = len(self._preamble()) + len(self._epilogue())
        if self._file is not None:
            n += self._file[3]
        return n

    def chunks(self) -> Iterator[bytes]:
        yield self._preamble()
        if self._file is not None:
            fh = self._file[2]
            while True:
                chunk = fh.read(_CHUNK)
                if not chunk:
                    break
                yield chunk
        yield self._epilogue()


class Client:
    """Synchronous client for one avd_tpu, avd_tpu_torch (or reference)
    service instance.

    ``retries`` applies to idempotent GETs and to connection-setup
    failures on POSTs (the request was never received); a POST whose
    body started flowing is never retried automatically — analysis is
    expensive and the caller should decide.
    """

    def __init__(self, base_url: str = "http://127.0.0.1:8000",
                 timeout: float = 300.0, retries: int = 2,
                 backoff_s: float = 0.5):
        if "://" not in base_url:  # tolerate bare "host:port"
            base_url = "http://" + base_url
        u = urllib.parse.urlsplit(base_url)
        if u.scheme != "http":
            raise ValueError(f"unsupported scheme: {u.scheme!r} "
                             "(the service speaks plain HTTP; run TLS "
                             "termination in front, as the reference's "
                             "Render deployment does)")
        try:
            port = u.port  # handles IPv6 literals and userinfo correctly
        except ValueError:
            raise ValueError(f"invalid port in base URL: {base_url!r}")
        self.host = u.hostname or "127.0.0.1"
        self.port = port or 80
        self.prefix = u.path.rstrip("/")
        self.timeout = timeout
        self.retries = max(0, retries)
        self.backoff_s = backoff_s

    # -- transport ---------------------------------------------------------

    def _connect(self) -> http.client.HTTPConnection:
        return http.client.HTTPConnection(self.host, self.port,
                                          timeout=self.timeout)

    def _connect_retry(self, what: str) -> http.client.HTTPConnection:
        """Establish the TCP connection with the retry/backoff policy.

        Used by the POST paths: a connection-setup failure means the
        request was never received, so retrying is safe (e.g. the brief
        SO_REUSEPORT blackhole while a worker rolls); once connected,
        failures are NOT retried — the analysis may already be running.
        """
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            conn = self._connect()
            try:
                conn.connect()
                return conn
            except OSError as e:
                conn.close()
                last = e
                if attempt < self.retries:
                    time.sleep(self.backoff_s * (2 ** attempt))
        raise ClientError(f"{what}: connect failed: {last}")

    def _decode(self, resp) -> Any:
        data = resp.read()
        ctype = resp.getheader("Content-Type", "")
        if "application/json" in ctype:
            try:
                return json.loads(data)
            except ValueError as e:
                raise ClientError(f"invalid JSON from service: {e}")
        return data.decode("utf-8", "ignore")

    def _finish(self, resp) -> Any:
        body = self._decode(resp)
        if not (200 <= resp.status < 300):
            ra = None
            try:
                h = resp.getheader("Retry-After")
                ra = float(h) if h else None
            except (ValueError, TypeError):
                pass
            raise APIError(resp.status, body, retry_after=ra)
        return body

    def _get(self, path: str) -> Any:
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                conn = self._connect()
                try:
                    conn.request("GET", self.prefix + path)
                    return self._finish(conn.getresponse())
                finally:
                    conn.close()
            except APIError:
                raise
            except (OSError, http.client.HTTPException) as e:
                last = e
                if attempt < self.retries:
                    time.sleep(self.backoff_s * (2 ** attempt))
        raise ClientError(f"GET {path} failed: {last!r}")

    def _post_stream(self, path: str, stream: _MultipartStream) -> Any:
        conn = self._connect_retry(f"POST {path}")
        try:
            conn.putrequest("POST", self.prefix + path)
            conn.putheader("Content-Type",
                           f"multipart/form-data; boundary={stream.boundary}")
            conn.putheader("Content-Length", str(stream.content_length))
            conn.endheaders()
            try:
                for chunk in stream.chunks():
                    conn.send(chunk)
            except OSError as send_err:
                # the server may have ANSWERED early and closed its read
                # side (413 after the size cap, 503 load shed) — surface
                # that definitive response instead of masking it as a
                # transport error (the APIError(413) contract above)
                try:
                    return self._finish(conn.getresponse())
                except APIError:
                    raise
                except Exception:
                    raise send_err
            return self._finish(conn.getresponse())
        except APIError:
            raise
        except (OSError, http.client.HTTPException) as e:
            raise ClientError(f"POST {path} failed: {e!r}")
        finally:
            conn.close()

    def _post_form(self, path: str, fields: Dict[str, str]) -> Any:
        body = urllib.parse.urlencode(fields).encode()
        conn = self._connect_retry(f"POST {path}")
        try:
            conn.request("POST", self.prefix + path, body=body, headers={
                "Content-Type": "application/x-www-form-urlencoded"})
            return self._finish(conn.getresponse())
        except APIError:
            raise
        except (OSError, http.client.HTTPException) as e:
            raise ClientError(f"POST {path} failed: {e!r}")
        finally:
            conn.close()

    # -- service endpoints --------------------------------------------------

    def health(self) -> Dict[str, Any]:
        """GET /healthz (api.py:217-219)."""
        return self._get("/healthz")

    def ready(self) -> Dict[str, Any]:
        """GET /readyz — dependency + device health."""
        return self._get("/readyz")

    def info(self) -> Dict[str, Any]:
        """GET / — service name + version (api.py:213-215)."""
        return self._get("/")

    def metrics(self) -> Dict[str, Any]:
        """GET /metrics — process counters (an addition to the reference)."""
        return self._get("/metrics")

    def wait_ready(self, timeout_s: float = 600.0,
                   poll_s: float = 2.0) -> Dict[str, Any]:
        """Poll /readyz until it answers ok (worker boot + device warmup
        can take minutes on a cold compile cache)."""
        deadline = time.monotonic() + timeout_s
        last: Optional[Exception] = None
        while time.monotonic() < deadline:
            try:
                out = self.ready()
                if out.get("ok"):
                    return out
            except ClientError as e:
                last = e
            time.sleep(poll_s)
        raise ClientError(f"service not ready after {timeout_s:.0f}s: {last}")

    def analyze(self, path_or_file, filename: Optional[str] = None,
                ) -> AnalysisResult:
        """POST /analyze with a streamed multipart upload (api.py:235-245).

        Accepts a filesystem path or an open binary file object (the
        latter must be seekable so Content-Length can be computed).
        """
        fh, name, size, close = self._open(path_or_file, filename)
        try:
            stream = _MultipartStream({}, ("file", name, fh, size))
            return AnalysisResult(self._post_stream("/analyze", stream))
        finally:
            if close:
                fh.close()

    def analyze_url(self, url: str) -> AnalysisResult:
        """POST /analyze-url (api.py:255-266)."""
        return AnalysisResult(self._post_form("/analyze-url", {"url": url}))

    def predict(self, path_or_file=None, url: Optional[str] = None,
                filename: Optional[str] = None) -> AnalysisResult:
        """POST /predict — the back-compat dispatcher (api.py:247-253)."""
        if path_or_file is not None:
            fh, name, size, close = self._open(path_or_file, filename)
            try:
                fields = {"url": url} if url else {}
                stream = _MultipartStream(fields, ("file", name, fh, size))
                return AnalysisResult(self._post_stream("/predict", stream))
            finally:
                if close:
                    fh.close()
        if url:
            return AnalysisResult(self._post_form("/predict", {"url": url}))
        raise ValueError("predict() needs a file or a url")

    def analyze_many(self, paths, workers: int = 4,
                     shed_retry_s: float = 60.0):
        """Concurrent fan-out over ``paths`` (order preserved): returns a
        list of ``(path, AnalysisResult | Exception)``.

        Each call uses its own connection, so ``workers`` uploads run in
        parallel; on the server side concurrent requests land in the
        cross-request batcher (serve/batching.py) and share stacked
        device programs — client fan-out and server batching compose.
        That composition includes LOAD SHEDDING: a 503 + Retry-After
        (AVD_MAX_INFLIGHT, shed before the upload is spooled — safe to
        retry) is retried for up to ``shed_retry_s`` seconds per file
        instead of being recorded as a failure.  Other per-file failures
        are returned, not raised, so one bad clip doesn't abort a sweep.
        """
        import concurrent.futures as cf

        paths = list(paths)
        out = [None] * len(paths)

        def one(i: int) -> None:
            budget = max(0.0, shed_retry_s)
            while True:
                try:
                    out[i] = (paths[i], self.analyze(paths[i]))
                    return
                except APIError as e:
                    if e.status == 503 and budget > 0:
                        wait = min(e.retry_after or 1.0, budget)
                        time.sleep(wait)
                        budget -= wait
                        continue
                    out[i] = (paths[i], e)
                    return
                except Exception as e:  # recorded per-file
                    out[i] = (paths[i], e)
                    return

        with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
            list(ex.map(one, range(len(paths))))
        return out

    @staticmethod
    def _open(path_or_file, filename: Optional[str]
              ) -> Tuple[BinaryIO, str, int, bool]:
        if isinstance(path_or_file, (str, os.PathLike)):
            fh = open(path_or_file, "rb")
            name = filename or os.path.basename(str(path_or_file))
            size = os.fstat(fh.fileno()).st_size
            return fh, name, size, True
        fh = path_or_file
        pos = fh.tell()
        fh.seek(0, os.SEEK_END)
        size = fh.tell() - pos
        fh.seek(pos)
        return fh, filename or "upload.bin", size, False


def main(argv=None) -> int:
    """``avd-client`` — drive a (remote) avd_tpu_torch, avd_tpu or
    reference service.

    Subcommands mirror the service surface: ``health`` / ``ready`` /
    ``metrics`` / ``analyze PATH... [--jsonl] [--workers N]`` /
    ``analyze-url URL``.  ``analyze`` with several paths (or a
    directory) streams one ``{"path", "response"|"error"}`` JSON line
    per clip — the remote twin of ``avd-analyze --jsonl``.
    """
    import argparse
    import sys

    ap = argparse.ArgumentParser(
        prog="avd-client",
        description="client for an avd_tpu_torch, avd_tpu (or reference) "
                    "service")
    ap.add_argument("base_url", help="service base URL, e.g. host:8000")
    ap.add_argument("--timeout", type=float, default=300.0)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("health", "ready", "metrics", "info"):
        sub.add_parser(name)
    sub.add_parser("wait-ready").add_argument(
        "--wait-timeout", type=float, default=600.0)
    an = sub.add_parser("analyze")
    an.add_argument("paths", nargs="+", metavar="path",
                    help="files or directories (scanned one level)")
    an.add_argument("--jsonl", action="store_true",
                    help="one {path, response|error} JSON object per line")
    an.add_argument("--workers", type=int, default=4,
                    help="concurrent uploads in batch mode (default 4)")
    an.add_argument("--indent", type=int, default=None,
                    help="pretty-print the single-input envelope "
                         "(incompatible with --jsonl, which is always "
                         "compact one-object-per-line)")
    au = sub.add_parser("analyze-url")
    au.add_argument("url")
    au.add_argument("--indent", type=int, default=None)
    args = ap.parse_args(argv)

    c = Client(args.base_url, timeout=args.timeout)
    try:
        if args.cmd in ("health", "ready", "metrics", "info"):
            out = {"health": c.health, "ready": c.ready,
                   "metrics": c.metrics, "info": c.info}[args.cmd]()
            json.dump(out, sys.stdout, indent=2)
            sys.stdout.write("\n")
            return 0
        if args.cmd == "wait-ready":
            json.dump(c.wait_ready(args.wait_timeout), sys.stdout, indent=2)
            sys.stdout.write("\n")
            return 0
        if args.cmd == "analyze-url":
            json.dump(c.analyze_url(args.url).raw, sys.stdout,
                      indent=args.indent)
            sys.stdout.write("\n")
            return 0
    except ClientError as e:
        print(str(e), file=sys.stderr)
        return 1

    # analyze
    from avd_tpu_torch.analyze import _expand
    files = list(_expand(args.paths))
    if not files:
        print("no analyzable files found", file=sys.stderr)
        return 2
    if len(files) > 1 and not args.jsonl:
        ap.error("multiple inputs need --jsonl")
    if args.jsonl and args.indent is not None:
        ap.error("--indent does not apply to --jsonl "
                 "(output is compact one-object-per-line)")

    if not args.jsonl:
        try:
            res = c.analyze(files[0])
        except ClientError as e:
            print(str(e), file=sys.stderr)
            return 1
        json.dump(res.raw, sys.stdout, indent=args.indent)
        sys.stdout.write("\n")
        return 0

    from avd_tpu_torch.analyze import emit_jsonl
    pairs = ((path, res if isinstance(res, Exception) else res.raw)
             for path, res in c.analyze_many(files, workers=args.workers))
    return 0 if emit_jsonl(pairs) == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
