"""Minimal ISO-BMFF (MP4/MOV) box scanner.

The port's copy of ``avd_tpu/ingest/bmff.py``.  The reference shells out
to ``exiftool`` for forensic metadata (reference app/analyzers/meta.py:5).  exiftool is not guaranteed to be
installed where this framework runs, so we parse the container natively:
walk the box tree, collect box types, pull QuickTime ``udta`` maker/model
atoms and the ``keys``/``ilst`` metadata pairs, and detect C2PA/JUMBF
provenance boxes structurally (the reference only does a substring scan of
exiftool output, meta.py:11-16 — a structural scan is strictly stronger).

Pure Python, stdlib only, bounded work: the scanner never reads media
payload, only box headers and small metadata boxes.
"""

from __future__ import annotations

import io
import struct
from typing import Any, Dict, List, Optional, Tuple

# Container boxes worth descending into.
_CONTAINERS = {
    b"moov", b"trak", b"mdia", b"minf", b"stbl", b"udta", b"edts",
    b"mvex", b"moof", b"traf", b"ilst", b"jumb",
}
# `meta` is a FullBox (4-byte version/flags before children) in MP4,
# but a plain container in some QuickTime files; handled specially.
_META = b"meta"

# C2PA stores its manifest in a top-level `uuid` box with this UUID
# (C2PA spec §"Embedding manifests into BMFF-based assets").
_C2PA_UUID = bytes.fromhex("d8fec3d61b0e483c92975828877ec481")

# QuickTime udta international-text atoms for device identity.
_UDTA_KEYS = {
    b"\xa9mak": "QuickTime:Make",
    b"\xa9mod": "QuickTime:Model",
    b"\xa9swr": "QuickTime:Software",
    b"\xa9too": "QuickTime:Encoder",
    b"\xa9day": "QuickTime:CreateDate",
}
# com.apple.quicktime keys → exiftool-style names (meta/keys/ilst route).
_QT_KEYS = {
    "com.apple.quicktime.make": "QuickTime:Make",
    "com.apple.quicktime.model": "QuickTime:Model",
    "com.apple.quicktime.software": "QuickTime:Software",
    "com.apple.quicktime.creationdate": "QuickTime:CreateDate",
}

_MAX_METADATA_BOX = 1 << 20  # never slurp boxes larger than 1 MiB
_MAX_DEPTH = 12


def _read_box_header(f, end: int) -> Optional[Tuple[bytes, int, int]]:
    """Return (type, payload_start, payload_end) or None at end/corruption."""
    pos = f.tell()
    if pos + 8 > end:
        return None
    hdr = f.read(8)
    if len(hdr) < 8:
        return None
    size = struct.unpack(">I", hdr[:4])[0]
    btype = hdr[4:8]
    payload_start = pos + 8
    if size == 1:
        large = f.read(8)
        if len(large) < 8:
            return None
        size = struct.unpack(">Q", large)[0]
        payload_start = pos + 16
    elif size == 0:
        size = end - pos  # box extends to end of enclosing scope
    if size < 8 or pos + size > end:
        return None
    return btype, payload_start, pos + size


class _Scan:
    def __init__(self) -> None:
        self.box_types: List[str] = []
        self.tags: Dict[str, Any] = {}
        self.c2pa = False
        self.jumbf = False
        self._qt_key_names: List[str] = []


def _parse_udta_text(payload: bytes) -> Optional[str]:
    """QuickTime international text atom: 2-byte size, 2-byte lang, text."""
    if len(payload) >= 4:
        tlen = struct.unpack(">H", payload[:2])[0]
        text = payload[4:4 + tlen]
        try:
            return text.decode("utf-8", "replace").strip("\x00") or None
        except Exception:
            return None
    return None


def _parse_keys(payload: bytes, scan: _Scan) -> None:
    """moov/meta/keys box: table of namespaced key names (indexed from 1)."""
    if len(payload) < 8:
        return
    count = struct.unpack(">I", payload[4:8])[0]
    off = 8
    names = []
    for _ in range(min(count, 256)):
        if off + 8 > len(payload):
            break
        ksize = struct.unpack(">I", payload[off:off + 4])[0]
        if ksize < 8 or off + ksize > len(payload):
            break
        names.append(payload[off + 8:off + ksize].decode("utf-8", "replace"))
        off += ksize
    scan._qt_key_names = names


def _parse_ilst_entry(index: int, payload: bytes, scan: _Scan) -> None:
    """moov/meta/ilst child: index-keyed item holding a `data` atom."""
    if index - 1 >= len(scan._qt_key_names) or index <= 0:
        return
    name = scan._qt_key_names[index - 1]
    mapped = _QT_KEYS.get(name)
    if mapped is None:
        return
    # payload contains one or more sub-atoms; find `data`.
    off = 0
    while off + 8 <= len(payload):
        size = struct.unpack(">I", payload[off:off + 4])[0]
        btype = payload[off + 4:off + 8]
        if size < 8 or off + size > len(payload):
            break
        if btype == b"data" and size >= 16:
            value = payload[off + 16:off + size]
            scan.tags[mapped] = value.decode("utf-8", "replace").strip("\x00")
            return
        off += size


def _walk(f, start: int, end: int, scan: _Scan, depth: int,
          in_ilst: bool = False) -> None:
    if depth > _MAX_DEPTH:
        return
    f.seek(start)
    while True:
        pos = f.tell()
        if pos >= end:
            break
        hdr = _read_box_header(f, end)
        if hdr is None:
            break
        btype, payload_start, box_end = hdr
        scan.box_types.append(btype.decode("latin-1"))

        if btype == b"jumb":
            scan.jumbf = True
        if btype == b"uuid":
            f.seek(payload_start)
            uuid = f.read(16)
            if uuid == _C2PA_UUID:
                scan.c2pa = True
        elif in_ilst:
            index = struct.unpack(">I", btype)[0]
            size = box_end - payload_start
            if 0 < size <= _MAX_METADATA_BOX:
                f.seek(payload_start)
                _parse_ilst_entry(index, f.read(size), scan)
        elif btype in _UDTA_KEYS:
            size = box_end - payload_start
            if 0 < size <= _MAX_METADATA_BOX:
                f.seek(payload_start)
                text = _parse_udta_text(f.read(size))
                if text:
                    scan.tags[_UDTA_KEYS[btype]] = text
        elif btype == b"keys":
            size = box_end - payload_start
            if 0 < size <= _MAX_METADATA_BOX:
                f.seek(payload_start)
                _parse_keys(f.read(size), scan)
        elif btype == _META:
            # FullBox in MP4 (4-byte version/flags), plain container in MOV.
            f.seek(payload_start)
            peek = f.read(8)
            child_start = payload_start
            if len(peek) == 8 and peek[4:8] not in (
                    b"hdlr", b"keys", b"ilst"):
                child_start = payload_start + 4
            _walk(f, child_start, box_end, scan, depth + 1)
        elif btype in _CONTAINERS:
            _walk(f, payload_start, box_end, scan, depth + 1,
                  in_ilst=(btype == b"ilst"))
        f.seek(box_end)


def scan_file(path: str) -> Dict[str, Any]:
    """Scan an ISO-BMFF file; returns box types, tags, provenance flags.

    Non-BMFF files yield empty results rather than raising.
    """
    scan = _Scan()
    try:
        with open(path, "rb") as f:
            f.seek(0, io.SEEK_END)
            end = f.tell()
            _walk(f, 0, end, scan, 0)
    except OSError:
        pass
    return {
        "box_types": scan.box_types,
        "tags": scan.tags,
        "c2pa_uuid": scan.c2pa,
        "jumbf": scan.jumbf,
    }
