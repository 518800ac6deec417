"""Seeded byte-level fuzz of the port's own untrusted-input parsers.

The cases of ``tests/test_fuzz.py`` against ``avd_tpu_torch``'s copies:
the ISO-BMFF scanner (``ingest/bmff.py``), multipart and chunked framing
and the JSON response bytes (``serve/http.py``), and the C WAV parser of
the host runtime (``avd_wav_info`` in ``native/src/avd_native.cc``, in a
subprocess so a memory-safety crash fails the test instead of killing
pytest).  Random and structure-aware mutated inputs must give clean typed
errors or a benign parse: never a hang, unbounded memory, a leaked spool
file or a crash.
"""

import glob
import io
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest

from avd_tpu_torch.ingest import bmff
from avd_tpu_torch.serve import http as ahttp

SEED = 1234


# ---------------------------------------------------------------------------
# ISO-BMFF structural scanner
# ---------------------------------------------------------------------------

def _scan_bytes(tmp_path, data: bytes):
    p = tmp_path / "fuzz.mp4"
    p.write_bytes(data)
    out = bmff.scan_file(str(p))
    assert isinstance(out, dict)
    return out


def test_bmff_random_bytes(tmp_path):
    rng = np.random.default_rng(SEED)
    for n in (0, 1, 7, 8, 16, 100, 4096):
        _scan_bytes(tmp_path, rng.integers(0, 256, n, dtype=np.uint8)
                    .tobytes())


def test_bmff_mutated_valid_boxes(tmp_path):
    rng = np.random.default_rng(SEED + 1)
    base = (
        b"\x00\x00\x00\x18ftypisom\x00\x00\x02\x00isomiso2"
        b"\x00\x00\x00\x10moov\x00\x00\x00\x08udta"
    )
    for _ in range(200):
        data = bytearray(base)
        for _ in range(rng.integers(1, 6)):
            data[rng.integers(0, len(data))] = rng.integers(0, 256)
        _scan_bytes(tmp_path, bytes(data))


def test_bmff_adversarial_sizes(tmp_path):
    cases = [
        b"\x00\x00\x00\x01moov" + b"\x00" * 8,        # 64-bit size, short
        b"\xff\xff\xff\xffmoov",                       # huge declared size
        b"\x00\x00\x00\x00moov" + b"A" * 64,           # size 0 = to-EOF
        b"\x00\x00\x00\x07free",                       # size < header
        (b"\x00\x00\x00\x10moov" * 1000),              # sibling spam
    ]
    # deep nesting: each box claims to contain the next
    nest = b"A" * 8
    for _ in range(200):
        nest = (len(nest) + 8).to_bytes(4, "big") + b"moov" + nest
    cases.append(nest)
    for data in cases:
        _scan_bytes(tmp_path, data)


# ---------------------------------------------------------------------------
# multipart/form-data + chunked transfer framing
# ---------------------------------------------------------------------------

def _mp_request(body: bytes, ctype: str) -> ahttp.Request:
    stream = ahttp.BodyStream(io.BytesIO(body), content_length=len(body))
    return ahttp.Request("POST", "/analyze", {},
                         {"Content-Type": ctype}, stream)


def _valid_multipart():
    b = "fuzzboundary42"
    body = (
        f"--{b}\r\n"
        'Content-Disposition: form-data; name="file"; filename="c.mp4"\r\n'
        "Content-Type: video/mp4\r\n\r\n").encode() + b"DATA" * 100 + \
        f"\r\n--{b}\r\n".encode() + \
        b'Content-Disposition: form-data; name="note"\r\n\r\nhello\r\n' + \
        f"--{b}--\r\n".encode()
    return body, f"multipart/form-data; boundary={b}"


def _spool_count() -> int:
    return len(glob.glob(os.path.join(tempfile.gettempdir(), "tmp*")))


def test_multipart_valid_roundtrip():
    body, ctype = _valid_multipart()
    files, fields = ahttp.parse_multipart(
        _mp_request(body, ctype), 10 ** 6, lambda: {"detail": "x"})
    try:
        assert fields.get("note") == "hello"
        assert files["file"].size == 400
    finally:
        for f in files.values():
            f.unlink()


def test_multipart_mutation_fuzz():
    """Random byte mutations: either a clean parse or HTTPError — never a
    different exception, a hang, or a leaked spool file."""
    rng = np.random.default_rng(SEED + 2)
    base, ctype = _valid_multipart()
    before = _spool_count()
    for i in range(300):
        data = bytearray(base)
        for _ in range(rng.integers(1, 8)):
            op = rng.integers(0, 3)
            pos = int(rng.integers(0, len(data))) if len(data) else 0
            if op == 0 and data:
                data[pos] = rng.integers(0, 256)
            elif op == 1 and data:
                del data[pos]
            else:
                data.insert(pos, int(rng.integers(0, 256)))
        try:
            files, _ = ahttp.parse_multipart(
                _mp_request(bytes(data), ctype), 10 ** 6,
                lambda: {"detail": "x"})
            for f in files.values():
                f.unlink()
        except ahttp.HTTPError:
            pass  # typed rejection is the contract
    assert _spool_count() <= before + 2  # no systematic spool leak


def test_multipart_truncation_sweep():
    body, ctype = _valid_multipart()
    for cut in range(0, len(body), 13):
        try:
            files, _ = ahttp.parse_multipart(
                _mp_request(body[:cut], ctype), 10 ** 6,
                lambda: {"detail": "x"})
            for f in files.values():
                f.unlink()
        except ahttp.HTTPError:
            pass


def test_chunked_framing_fuzz():
    """Random chunked bodies: BodyStream.read must terminate with data,
    b'', or HTTPError(400) — and flag broken framing for the keep-alive
    layer instead of desyncing."""
    rng = np.random.default_rng(SEED + 3)
    for _ in range(300):
        n = int(rng.integers(0, 200))
        raw = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        # bias toward plausible framing so the parser gets deep
        if rng.random() < 0.5:
            payload = raw[:int(rng.integers(0, max(1, n)))]
            raw = (b"%x\r\n" % len(payload)) + payload + b"\r\n" + raw
        stream = ahttp.BodyStream(io.BytesIO(raw), chunked=True)
        got = 0
        try:
            for _ in range(10_000):  # hard stop >> any real iteration count
                chunk = stream.read(4096)
                if not chunk:
                    break
                got += len(chunk)
            else:
                pytest.fail("chunked reader failed to terminate")
        except ahttp.HTTPError as e:
            assert e.status == 400
            assert stream.broken
        assert got <= len(raw)


# ---------------------------------------------------------------------------
# native C WAV parser (memory safety — isolated in a subprocess so a
# segfault fails the test instead of killing the pytest process)
# ---------------------------------------------------------------------------

_WAV_FUZZ_SCRIPT = r"""
import sys
import numpy as np
sys.path.insert(0, {repo!r})
from avd_tpu_torch import native
import io, wave

native.lib()  # builds the host runtime (g++) on first use

# a small valid WAV to mutate
buf = io.BytesIO()
w = wave.open(buf, "wb")
w.setnchannels(2); w.setsampwidth(2); w.setframerate(8000)
w.writeframes(np.zeros(256, np.int16).tobytes())
w.close()
base = bytearray(buf.getvalue())

rng = np.random.default_rng(99)
for i in range(2000):
    data = bytearray(base)
    for _ in range(rng.integers(1, 10)):
        op = rng.integers(0, 3)
        pos = int(rng.integers(0, len(data))) if len(data) else 0
        if op == 0 and data:
            data[pos] = rng.integers(0, 256)
        elif op == 1 and data:
            data = data[:pos]  # truncate
        else:
            data.insert(pos, int(rng.integers(0, 256)))
    native.wav_decode_mono(bytes(data))   # None or (arr, sr); must not crash
# pure random blobs too
for n in (0, 1, 11, 44, 45, 100, 4096):
    native.wav_decode_mono(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
print("OK")
"""


def test_native_wav_parser_fuzz(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "wav_fuzz.py"
    script.write_text(_WAV_FUZZ_SCRIPT.replace("{repo!r}", repr(repo)))
    proc = subprocess.run([sys.executable, str(script)],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, \
        f"WAV fuzz script died (rc={proc.returncode}, likely a memory-" \
        f"safety bug in avd_wav_info/decode): {proc.stderr[-2000:]}"
    assert proc.stdout.strip() == "OK"


# ---------------------------------------------------------------------------
# review-hardening regressions: truncation and unbounded-buffering guards
# ---------------------------------------------------------------------------

def test_truncated_chunked_upload_is_broken_not_complete():
    """Connection EOF where a chunk-size line was due must mark the body
    BROKEN (HTTPError 400), not parse as the final zero chunk — a
    half-written upload must never get a full analysis pass."""
    payload = b"X" * 100
    raw = (b"%x\r\n" % len(payload)) + payload + b"\r\n"  # then EOF
    stream = ahttp.BodyStream(io.BytesIO(raw), chunked=True)
    assert stream.read(4096) == payload
    with pytest.raises(ahttp.HTTPError) as e:
        stream.read(4096)
    assert e.value.status == 400
    assert stream.broken


def test_truncated_multipart_file_rejected():
    """EOF before a file part's closing boundary → 400, spool unlinked."""
    b = "bnd"
    body = (f"--{b}\r\n"
            'Content-Disposition: form-data; name="file"; '
            'filename="c.mp4"\r\n\r\n').encode() + b"DATA" * 100  # no close
    with pytest.raises(ahttp.HTTPError) as e:
        ahttp.parse_multipart(
            _mp_request(body, f"multipart/form-data; boundary={b}"),
            10 ** 6, lambda: {"detail": "x"})
    assert e.value.status == 400


def test_multipart_preamble_cannot_buffer_unbounded():
    """A body that never contains the boundary must fail with bounded
    memory (the preamble scan keeps only a partial-delimiter tail)."""
    class _Counting(io.BytesIO):
        pass

    body = b"A" * (8 * 1024 * 1024)  # 8 MiB of non-boundary preamble
    req = _mp_request(body, "multipart/form-data; boundary=never")
    import tracemalloc
    tracemalloc.start()
    with pytest.raises(ahttp.HTTPError) as e:
        ahttp.parse_multipart(req, 10 ** 6, lambda: {"detail": "x"})
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    assert e.value.status == 422
    assert peak < 6 * 1024 * 1024, peak  # well under the 8 MiB body


def test_multipart_unterminated_headers_rejected():
    b = "bnd"
    body = (f"--{b}\r\n").encode() + b"H: " + b"v" * (2 * 1024 * 1024)
    with pytest.raises(ahttp.HTTPError) as e:
        ahttp.parse_multipart(
            _mp_request(body, f"multipart/form-data; boundary={b}"),
            10 ** 8, lambda: {"detail": "x"})
    assert e.value.status in (400, 422)


def test_json_response_bytes_match_fastapi():
    """Response bodies must be byte-compatible with Starlette's
    JSONResponse: compact separators, raw UTF-8."""
    r = ahttp.Response({"ok": True, "msg": "qualità"})
    assert r.body == '{"ok":true,"msg":"qualità"}'.encode("utf-8")
