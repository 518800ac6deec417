"""Forensic analyzer — dead code parity module.

The port's copy of ``avd_tpu/analyzers/forensic.py``.  The reference
ships ``app/analyzers/forensic.py``, a near-duplicate of ``meta.py`` whose
``analyze()`` is imported by the package (__init__.py:6) but never called
from the API path (only ``meta.forensic_summary`` is, api.py:164).  The
module and its shape are kept, unused status included, so that the package
surface matches the reference.
"""

from __future__ import annotations

from typing import Any, Dict

from avd_tpu_torch.analyzers import meta as _meta

# Same backends as the active module.
exiftool_json = _meta.exiftool_json
c2pa_present_from_exif = _meta.c2pa_present


def analyze(path: str) -> Dict[str, Any]:
    """Light EXIF dump + C2PA flag (reference forensic.py:27-32)."""
    ex = (_meta.exiftool_json(path) if _meta._exiftool_available()
          else _meta.native_json(path))
    return {
        "exif": {
            "has_data": bool(ex),
            "subset": {k: ex.get(k) for k in list(ex.keys())[:30]},
        },
        "c2pa": {"present": c2pa_present_from_exif(ex)},
    }
