"""The port's forensic metadata (``avd_tpu_torch.analyzers.meta``,
``analyzers.forensic``, ``ingest.bmff``) against ``avd_tpu``'s, on the
cases of tests/test_meta_forensic.py: the BMFF scan, the forensic summary,
the C2PA substring heuristic, device priority, the dead ``forensic``
module, and the exiftool subprocess backend driven by a stub on ``PATH``.

Every case runs both packages on the same bytes (and the same stub) and
holds the port's result equal (``==``) to ``avd_tpu``'s, beside the JAX
file's own assertions.
"""

import os
import stat
import struct
import time

import numpy as np
import pytest

from avd_tpu.analyzers import forensic as jforensic
from avd_tpu.analyzers import meta as jmeta
from avd_tpu.ingest import bmff as jbmff
from avd_tpu_torch.analyzers import forensic, meta
from avd_tpu_torch.ingest import bmff
from tests import fixtures

C2PA_UUID = bytes.fromhex("d8fec3d61b0e483c92975828877ec481")


def _box(btype: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + btype + payload


def _udta_text(tag: bytes, text: bytes) -> bytes:
    return _box(tag, struct.pack(">HH", len(text), 0) + text)


def _write(path, data: bytes) -> str:
    path.write_bytes(data)
    return str(path)


# The files of the JAX suite, each made in tmp_path.
_FILES = {
    "udta_make_model": lambda d: _write(
        d / "m.mp4", _box(b"ftyp", b"isom\x00\x00\x00\x01isom")
        + _box(b"moov", _box(b"udta", _udta_text(b"\xa9mak", b"Apple")
                             + _udta_text(b"\xa9mod", b"iPhone 15 Pro")))),
    "c2pa_uuid": lambda d: _write(
        d / "c.mp4", _box(b"ftyp", b"isom\x00\x00\x00\x01")
        + _box(b"uuid", C2PA_UUID + b"\x00" * 8)),
    "udta_make": lambda d: _write(
        d / "v.mp4", _box(b"ftyp", b"isom")
        + _box(b"moov", _box(b"udta", _udta_text(b"\xa9mak", b"Canon")))),
    "c2pa_uuid_only": lambda d: _write(
        d / "u.mp4", _box(b"uuid", C2PA_UUID + b"\x00" * 16)),
    "ftyp_only": lambda d: _write(d / "f.mp4", _box(b"ftyp", b"isom")),
    "garbage": lambda d: _write(
        d / "g.bin", np.random.default_rng(0).bytes(4096)),
    "cv2_mp4": lambda d: fixtures.write_video(
        d / "s.mp4", fixtures.solid_clip(10, 64)),
}


def _both(fn_port, fn_jax, *args):
    """(port's result, avd_tpu's result) of the same call."""
    return fn_port(*args), fn_jax(*args)


@pytest.mark.parametrize("name", sorted(_FILES))
def test_scan_summary_and_dead_module_equal_avd_tpu(tmp_path, name):
    """The scan dict (``tags``, ``c2pa_uuid``, ``box_types``...), the
    forensic summary and ``forensic.analyze`` of each file equal
    ``avd_tpu``'s; the scan never raises (the garbage file included)."""
    path = _FILES[name](tmp_path)
    scan, jscan = _both(bmff.scan_file, jbmff.scan_file, path)
    assert scan == jscan
    assert isinstance(scan["box_types"], list)
    assert set(scan) >= {"tags", "c2pa_uuid", "box_types"}
    summary, jsummary = _both(meta.forensic_summary, jmeta.forensic_summary,
                              path)
    assert summary == jsummary
    assert set(summary) == {"c2pa", "exif_quick"}
    assert isinstance(summary["c2pa"]["present"], bool)
    dead, jdead = _both(forensic.analyze, jforensic.analyze, path)
    assert dead == jdead
    assert set(dead) == {"exif", "c2pa"}
    assert "has_data" in dead["exif"] and "subset" in dead["exif"]


def test_bmff_scan_udta_make_model(tmp_path):
    path = _FILES["udta_make_model"](tmp_path)
    scan, jscan = _both(bmff.scan_file, jbmff.scan_file, path)
    assert scan == jscan
    assert scan["tags"]["QuickTime:Make"] == "Apple"
    assert scan["tags"]["QuickTime:Model"] == "iPhone 15 Pro"
    assert not scan["c2pa_uuid"]


def test_bmff_scan_c2pa_uuid(tmp_path):
    path = _FILES["c2pa_uuid"](tmp_path)
    scan, jscan = _both(bmff.scan_file, jbmff.scan_file, path)
    assert scan == jscan
    assert scan["c2pa_uuid"]


def test_forensic_summary_shape(tmp_path):
    path = _FILES["udta_make"](tmp_path)
    out, jout = _both(meta.forensic_summary, jmeta.forensic_summary, path)
    assert out == jout
    assert set(out.keys()) == {"c2pa", "exif_quick"}
    assert isinstance(out["c2pa"]["present"], bool)
    assert out["exif_quick"].get("QuickTime:Make") == "Canon"


def test_forensic_summary_c2pa_positive(tmp_path):
    path = _FILES["c2pa_uuid_only"](tmp_path)
    out, jout = _both(meta.forensic_summary, jmeta.forensic_summary, path)
    assert out == jout
    assert out["c2pa"]["present"] is True


# Reference behavior (meta.py:11-16): substring scan of the record.
_C2PA_RECORDS = [
    ({"X": "contains c2pa data"}, True),
    ({"X": "jumbf box"}, True),
    ({"m": "manifest", "c": "claim"}, True),
    ({"X": "plain video"}, False),
]


@pytest.mark.parametrize("record,want", _C2PA_RECORDS,
                         ids=[str(i) for i in range(len(_C2PA_RECORDS))])
def test_c2pa_substring_heuristic(record, want):
    got, jgot = _both(meta.c2pa_present, jmeta.c2pa_present, record)
    assert got == jgot
    assert got is want


_DEVICE_RECORDS = [
    ({"EXIF:Make": "Sony", "QuickTime:Make": "Apple"}, "Apple"),
    ({}, None),
]


@pytest.mark.parametrize("record,want", _DEVICE_RECORDS,
                         ids=["priority", "empty"])
def test_detect_device_priority(record, want):
    got, jgot = _both(meta.detect_device, jmeta.detect_device, record)
    assert got == jgot == want


def test_dead_forensic_module_shape(tmp_path):
    """forensic.analyze keeps the reference's dead-module contract
    (forensic.py:27-32)."""
    path = _FILES["ftyp_only"](tmp_path)
    out, jout = _both(forensic.analyze, jforensic.analyze, path)
    assert out == jout
    assert set(out.keys()) == {"exif", "c2pa"}
    assert "has_data" in out["exif"] and "subset" in out["exif"]


def test_scan_garbage_file(tmp_path):
    path = _FILES["garbage"](tmp_path)
    scan, jscan = _both(bmff.scan_file, jbmff.scan_file, path)  # no raise
    assert scan == jscan
    assert isinstance(scan["box_types"], list)


def test_real_cv2_mp4_scans(tmp_path):
    path = _FILES["cv2_mp4"](tmp_path)
    scan, jscan = _both(bmff.scan_file, jbmff.scan_file, path)
    assert scan == jscan
    assert "moov" in scan["box_types"]
    out, jout = _both(meta.forensic_summary, jmeta.forensic_summary, path)
    assert out == jout
    assert out["c2pa"]["present"] is False


# ---------------------------------------------------------------------------
# exiftool subprocess backend (reference meta.py:3-9): the binary is not in
# this image, so a stub executable on PATH drives the branch, for both
# packages with the same stub.

_EXIFTOOL_STUB = """#!/bin/sh
printf '%s\\n' "$@" > "{argv_log}"
cat << 'JSON'
[{{"SourceFile": "clip.mp4",
   "QuickTime:Make": "Apple", "QuickTime:Model": "iPhone 15 Pro",
   "JUMBF:C2PAManifest": {{"Claim": "c2pa.manifest"}}}}]
JSON
"""


def _install_stub(tmp_path, monkeypatch, script: str):
    exe = tmp_path / "exiftool"
    exe.write_text(script)
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}"
                               f"{os.environ.get('PATH', '')}")
    return exe


def test_exiftool_backend_end_to_end(tmp_path, monkeypatch):
    """With a (fake) exiftool on PATH, forensic_summary routes through
    the subprocess backend: -json -struct -G1 flags, first-record parse,
    Make/Model device keys, and the substring C2PA heuristic."""
    argv_log = tmp_path / "argv.txt"
    _install_stub(tmp_path, monkeypatch,
                  _EXIFTOOL_STUB.format(argv_log=argv_log))
    clip = tmp_path / "clip.mp4"
    clip.write_bytes(b"\x00" * 16)

    outs = {}
    for name, mod in (("port", meta), ("avd_tpu", jmeta)):
        argv_log.unlink(missing_ok=True)
        assert mod._exiftool_available()
        outs[name] = mod.forensic_summary(str(clip))
        # flags preserved exactly (reference meta.py:5)
        assert argv_log.read_text().split("\n")[:4] == \
            ["-json", "-struct", "-G1", str(clip)], name
        assert mod.exiftool_json(str(clip))["SourceFile"] == "clip.mp4"
    out = outs["port"]
    assert out == outs["avd_tpu"]
    assert out["exif_quick"]["QuickTime:Make"] == "Apple"
    assert out["exif_quick"]["QuickTime:Model"] == "iPhone 15 Pro"
    assert out["c2pa"]["present"] is True  # substring scan on the record
    assert meta.exiftool_json(str(clip)) == jmeta.exiftool_json(str(clip))
    assert forensic.analyze(str(clip)) == jforensic.analyze(str(clip))


def test_exiftool_timeout_returns_empty(tmp_path, monkeypatch):
    """A hung exiftool is bounded by the 20 s timeout (reference
    meta.py:5-9 catches everything → {}); patched short to keep CI fast."""
    _install_stub(tmp_path, monkeypatch, "#!/bin/sh\nsleep 30\n")
    for mod in (meta, jmeta):
        assert mod._EXIFTOOL_TIMEOUT_S == 20  # reference contract value
        monkeypatch.setattr(mod, "_EXIFTOOL_TIMEOUT_S", 0.5)
        t = time.perf_counter()
        assert mod.exiftool_json(str(tmp_path / "x.mp4")) == {}
        assert time.perf_counter() - t < 10


@pytest.mark.parametrize("printed", ["not json", "[]"])
def test_exiftool_malformed_output_returns_empty(tmp_path, monkeypatch,
                                                 printed):
    _install_stub(tmp_path, monkeypatch, f"#!/bin/sh\necho '{printed}'\n")
    got, jgot = _both(meta.exiftool_json, jmeta.exiftool_json,
                      str(tmp_path / "x.mp4"))
    assert got == jgot == {}


def test_exiftool_no_device_no_c2pa(tmp_path, monkeypatch):
    """Subprocess backend with a clean record: no device, no C2PA."""
    _install_stub(tmp_path, monkeypatch,
                  "#!/bin/sh\necho '[{\"File:FileSize\": \"1 kB\"}]'\n")
    out, jout = _both(meta.forensic_summary, jmeta.forensic_summary,
                      str(tmp_path / "x.mp4"))
    assert out == jout == {"c2pa": {"present": False}, "exif_quick": {}}


@pytest.mark.parametrize("sub", ["ai", "real"])
def test_corpus_clip_forensic_equals_avd_tpu_and_the_card_check(sub):
    """The committed corpus clips that ``chip_smoke.py`` phase 35 serves:
    their forensic summary and BMFF scan through the native route equal
    ``avd_tpu``'s and the values the card's host is held to."""
    import chip_smoke
    clip = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "corpus_v1", sub, "clip_00_crf23.mp4")
    scan, jscan = _both(bmff.scan_file, jbmff.scan_file, clip)
    assert scan == jscan
    assert scan["box_types"] == chip_smoke.REAL_CLIP_BOXES
    assert not scan["tags"] and not scan["c2pa_uuid"]
    out, jout = _both(meta.forensic_summary, jmeta.forensic_summary, clip)
    assert out == jout == chip_smoke.REAL_CLIP_FORENSIC
