"""The envelope's schema check, frozen: a copy of the port's
``schema.validate`` (the reference's key order, two-decimal rounding,
label vocabulary, timeline ranges and peak indices), so a later change to
the program's schema module does not change what a run accepts."""

from __future__ import annotations

from typing import Any, Dict

ENVELOPE_KEYS = ["ok", "meta", "hints", "video", "audio", "result",
                 "timeline_binned", "peaks"]  # + optional "forensic"

LABELS = ("real", "ai", "uncertain")

META_KEYS = {"width", "height", "fps", "duration", "bit_rate", "vcodec",
             "acodec", "format_name", "source_url", "resolved_url"}

RESULT_KEYS = ["label", "ai_score", "confidence", "reason"]


class SchemaError(AssertionError):
    pass


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise SchemaError(msg)


def validate(resp: Dict[str, Any]) -> None:
    """Raise SchemaError unless ``resp`` honors the reference contract.

    Structural surprises (wrong types, missing keys, nulls) surface as
    SchemaError too — not bare TypeError/AttributeError — so callers get
    the single documented exception for every invalid response.
    """
    try:
        _validate(resp)
    except SchemaError:
        raise
    except (TypeError, ValueError, AttributeError, KeyError,
            IndexError) as e:
        raise SchemaError(
            f"malformed response: {type(e).__name__}: {e}") from e


def _validate(resp: Dict[str, Any]) -> None:
    keys = list(resp.keys())
    _check(keys[:8] == ENVELOPE_KEYS,
           f"envelope key order {keys[:8]} != {ENVELOPE_KEYS}")
    extra = set(keys[8:]) - {"forensic", "forensic_error", "profile"}
    _check(not extra, f"unexpected envelope keys {extra}")
    _check(resp["ok"] is True, "ok must be True on success")

    _check(META_KEYS <= set(resp["meta"].keys()),
           f"meta missing {META_KEYS - set(resp['meta'])}")

    result = resp["result"]
    _check(list(result.keys()) == RESULT_KEYS,
           f"result keys {list(result.keys())}")
    _check(result["label"] in LABELS, f"label {result['label']}")
    for f in ("ai_score", "confidence"):
        _check(result[f] == round(result[f], 2),
               f"{f} not rounded to 2 decimals: {result[f]}")
    _check(0.0 <= result["ai_score"] <= 1.0, "ai_score out of range")
    _check(0.10 <= result["confidence"] <= 0.99,
           "confidence outside [0.10, 0.99]")

    for name in ("timeline_binned",):
        t = resp[name]
        _check(isinstance(t, list), f"{name} not a list")
        _check(all(0.0 <= x <= 1.0 for x in t), f"{name} out of [0,1]")

    v = resp["video"]
    _check({"timeline", "summary", "timeline_ai"} <= set(v.keys()),
           "video block incomplete")
    a = resp["audio"]
    _check({"scores", "flags_audio", "timeline"} <= set(a.keys()),
           "audio block incomplete")
    peaks = resp["peaks"]
    tl = len(resp["timeline_binned"])
    # The reference's fused timeline is never empty (fusion.py:19
    # `L = max(len(a_t), len(v_t), 1)`), so an empty binned timeline is a
    # contract violation, and every peak must index a real bin.
    _check(tl >= 1, "timeline_binned empty")
    _check(all(isinstance(i, int) and 0 <= i < tl for i in peaks),
           "peaks outside timeline range")

    if "forensic" in resp:
        f = resp["forensic"]
        _check(set(f.keys()) == {"c2pa", "exif_quick"}, "forensic keys")
        _check(isinstance(f["c2pa"]["present"], bool), "c2pa.present type")


def is_valid(resp: Dict[str, Any]) -> bool:
    try:
        validate(resp)
        return True
    except SchemaError:
        return False
