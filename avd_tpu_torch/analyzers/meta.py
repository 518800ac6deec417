"""Forensic metadata summary (active path).

The port's copy of ``avd_tpu/analyzers/meta.py``.  Contract from the
reference's app/analyzers/meta.py: ``forensic_summary``
returns ``{"c2pa": {"present": bool}, "exif_quick": {Make/Model keys}}``.

Backends, tried in order:
1. ``exiftool`` subprocess (the reference's only backend, meta.py:5) when the
   binary is installed — 20 s timeout, ``-json -struct -G1`` flags preserved.
2. Native ISO-BMFF scan (``avd_tpu_torch.ingest.bmff``) — no external binary; C2PA
   detection is structural (uuid/jumb boxes) rather than the reference's
   substring scan, plus the same substring heuristic over the collected tags
   for parity (meta.py:11-16).
"""

from __future__ import annotations

import json
import shutil
import subprocess
from typing import Any, Dict, Optional

from avd_tpu_torch.ingest import bmff

_DEVICE_KEYS = ("QuickTime:Make", "QuickTime:Model", "EXIF:Make", "EXIF:Model")

_EXIFTOOL_TIMEOUT_S = 20


def _exiftool_available() -> bool:
    return shutil.which("exiftool") is not None


def exiftool_json(path: str) -> Dict[str, Any]:
    """Run exiftool, returning the first record or {} (meta.py:3-9)."""
    try:
        out = subprocess.check_output(
            ["exiftool", "-json", "-struct", "-G1", path],
            text=True, stderr=subprocess.DEVNULL, timeout=_EXIFTOOL_TIMEOUT_S,
        )
        data = json.loads(out or "[]")
        return data[0] if isinstance(data, list) and data else {}
    except Exception:
        return {}


def native_json(path: str) -> Dict[str, Any]:
    """exiftool-shaped record from the native BMFF scanner."""
    scan = bmff.scan_file(path)
    record: Dict[str, Any] = dict(scan["tags"])
    if scan["c2pa_uuid"]:
        record["JUMBF:C2PAManifest"] = "present"
    if scan["jumbf"]:
        record["JUMBF:JUMBF"] = "present"
    return record


def c2pa_present(exif: Dict[str, Any]) -> bool:
    """Substring heuristic over the serialized record (meta.py:11-16)."""
    try:
        t = json.dumps(exif).lower()
    except Exception:
        return False
    return ("c2pa" in t) or ("jumbf" in t) or ("manifest" in t and "claim" in t)


def detect_device(exif: Dict[str, Any]) -> Optional[str]:
    """First Make/Model value, if any (meta.py:18-22)."""
    for k in _DEVICE_KEYS:
        v = exif.get(k)
        if v:
            return str(v)
    return None


def forensic_summary(path: str) -> Dict[str, Any]:
    """Active forensic summary attached to responses (meta.py:24-29,
    called from api.py:164)."""
    ex = exiftool_json(path) if _exiftool_available() else native_json(path)
    return {
        "c2pa": {"present": c2pa_present(ex)},
        "exif_quick": {k: ex.get(k) for k in _DEVICE_KEYS if k in ex},
    }
