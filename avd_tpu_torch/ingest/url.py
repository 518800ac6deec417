"""Remote-URL resolution for /analyze-url.

Port of ``avd_tpu/ingest/url.py``.  Contract from the reference's
api.py:172-210: yt-dlp download to a temp .mp4, gated by USE_YTDLP (422
when disabled), DownloadError strings mapped to HTTP 415/413 with the
reference's Italian user hints, custom UA from RESOLVER_UA,
``max_filesize`` enforcing RESOLVER_MAX_BYTES.

When yt-dlp is not installed (neither serving image has it), direct
HTTP(S) media links are fetched natively with urllib under the same size
cap and error mapping, so the endpoint keeps working for the direct-link
case (BASELINE.json config #4).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict

from avd_tpu_torch.config import get_config
from avd_tpu_torch.serve.http import HTTPError


def _ytdlp_available() -> bool:
    try:
        import yt_dlp  # noqa: F401
        return True
    except ImportError:
        return False


def _map_download_error(msg: str, max_bytes: int) -> HTTPError:
    """DownloadError → HTTP status with Italian hints (api.py:196-206)."""
    msg = msg.lower()
    if "login" in msg or "private" in msg or "cookies" in msg:
        return HTTPError(415, {
            "error": "Contenuto protetto da login / cookies",
            "hint": "Usa 'Carica file' o 'Registra 10s'."})
    if "unsupported url" in msg:
        return HTTPError(415, {
            "error": "URL non supportato",
            "hint": "Prova con un link diretto o carica il file."})
    if "filesize" in msg or "too large" in msg:
        return HTTPError(413, {
            "error": "File troppo grande dal provider",
            "limit_bytes": max_bytes})
    return HTTPError(415, {
        "error": "Errore di download",
        "hint": "Rate limit o blocco. Riprova o carica il file."})


def _ytdlp_download(url: str, max_bytes: int) -> Dict[str, Any]:
    import yt_dlp
    cfg = get_config()
    tmp = tempfile.NamedTemporaryFile(delete=False, suffix=".mp4")
    tmp.close()
    opts = {
        "outtmpl": tmp.name,
        "quiet": True,
        "no_warnings": True,
        "noplaylist": True,
        "retries": 1,
        "user_agent": cfg.resolver_ua,
        "http_headers": {"User-Agent": cfg.resolver_ua},
        "format": "bv*+ba/best",
        "max_filesize": max_bytes,
        "nocheckcertificate": True,
        "geo_bypass": True,
        "overwrites": True,
    }
    try:
        with yt_dlp.YoutubeDL(opts) as ydl:
            info = ydl.extract_info(url, download=True)
            return {"path": tmp.name,
                    "resolved_url": (info.get("url")
                                     or info.get("webpage_url") or url)}
    except yt_dlp.utils.DownloadError as e:
        _cleanup(tmp.name)
        raise _map_download_error(str(e), max_bytes) from e
    except Exception as e:
        _cleanup(tmp.name)
        raise HTTPError(415, {"error": "Impossibile scaricare il video",
                              "exception": str(e)}) from e


def _direct_download(url: str, max_bytes: int) -> Dict[str, Any]:
    """Native fallback: stream a direct media link with the size cap."""
    import urllib.error
    import urllib.request

    cfg = get_config()
    if not url.lower().startswith(("http://", "https://")):
        raise _map_download_error("unsupported url", max_bytes)
    suffix = os.path.splitext(url.split("?")[0])[1] or ".mp4"
    tmp = tempfile.NamedTemporaryFile(delete=False, suffix=suffix)
    req = urllib.request.Request(url,
                                 headers={"User-Agent": cfg.resolver_ua})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            size = 0
            with tmp as f:
                while True:
                    chunk = r.read(1024 * 1024)
                    if not chunk:
                        break
                    size += len(chunk)
                    if size > max_bytes:
                        raise _map_download_error("filesize", max_bytes)
                    f.write(chunk)
            return {"path": tmp.name, "resolved_url": r.geturl()}
    except HTTPError:
        _cleanup(tmp.name)
        raise
    except urllib.error.URLError as e:
        _cleanup(tmp.name)
        raise _map_download_error(str(e), max_bytes) from e
    except Exception as e:
        _cleanup(tmp.name)
        raise HTTPError(415, {"error": "Impossibile scaricare il video",
                              "exception": str(e)}) from e


def _cleanup(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def resolve(url: str, max_bytes: int) -> Dict[str, Any]:
    """Download a remote URL → {"path", "resolved_url"}; HTTPError on
    failure.  yt-dlp gate per USE_YTDLP (api.py:173-174)."""
    cfg = get_config()
    if not cfg.use_ytdlp:
        raise HTTPError(422, {"error": "yt-dlp disabilitato",
                              "hint": "Abilita USE_YTDLP=1"})
    if _ytdlp_available():
        return _ytdlp_download(url, max_bytes)
    return _direct_download(url, max_bytes)
