"""Container-level heuristic hints.

Behavioral contract from reference app/analyzers/heuristics_v2.py:
bits-per-pixel from probed metadata, a four-class compression bucket, a
video-signal flag, and ``dup_avg`` hard-coded to 0.0.

``dup_avg == 0.0`` is *deliberately preserved dead*: in the reference the
fusion dup penalty (fusion.py:46, ``dup > 0.2``) can therefore never fire.
Reproducing the snapshot means reproducing that, not "fixing" it.
"""

from __future__ import annotations

from typing import Any, Dict

# Compression classes by bits-per-pixel ceiling (heuristics_v2.py:9-12).
_COMPRESSION_BUCKETS = (
    (0.04, "very_heavy"),
    (0.08, "heavy"),
    (0.15, "normal"),
)


def bits_per_pixel(width: int, height: int, fps: float, bit_rate: int) -> float:
    """``bit_rate / (w*h*fps)`` with a 1.0 floor on the denominator
    (heuristics_v2.py:7-8)."""
    pixels_per_sec = (width * height * fps) if width and height and fps else 0.0
    return float(bit_rate) / max(1.0, pixels_per_sec)


def classify_compression(bpp: float) -> str:
    for ceiling, name in _COMPRESSION_BUCKETS:
        if bpp <= ceiling:
            return name
    return "light"


def compute_hints(meta: Dict[str, Any], path: str) -> Dict[str, Any]:
    """Build the hints dict consumed by fusion (heuristics_v2.py:1-18).

    ``path`` is accepted for signature parity but unused, as in the
    reference.
    """
    width = meta.get("width") or 0
    height = meta.get("height") or 0
    fps = meta.get("fps") or 0.0
    bit_rate = meta.get("bit_rate") or 0

    bpp = bits_per_pixel(width, height, fps, bit_rate)
    return {
        "w": width,
        "h": height,
        "fps": fps,
        "br": bit_rate,
        "bpp": round(bpp, 5),
        "compression": classify_compression(bpp),
        "video_has_signal": (width * height) > 0 and fps > 0,
        # Dead in the reference snapshot (heuristics_v2.py:18) — kept dead.
        "dup_avg": 0.0,
    }
