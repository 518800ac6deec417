"""The port's CLI (``python -m avd_tpu_torch.analyze``) against
``avd_tpu.analyze``: the cases of tests/test_cli_batch.py, run with
``--device cpu``, printing what the JAX package's CLI prints on the same
files — exactly under ``AVD_BACKEND=oracle`` (the host loops of both
packages), within the envelope tolerances of tests/test_torch_file_path.py
on the device path.
"""

import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest

from avd_tpu import analyze as jcli
from avd_tpu_torch import analyze as cli
from tests import fixtures
from tests.test_torch_file_path import assert_same_envelope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def oracle_backend(monkeypatch):
    monkeypatch.setenv("AVD_BACKEND", "oracle")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    fixtures.write_video(str(d / "a.mp4"),
                         fixtures.gradient_clip(n=20, size=96))
    fixtures.write_video(str(d / "b.mp4"),
                         fixtures.solid_clip(n=20, size=96))
    (d / "notes.txt").write_text("not a video")
    return d


def _run(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def _both(argv):
    rc, out = _run(cli.main, argv + ["--device", "cpu"])
    jrc, jout = _run(jcli.main, argv)
    return rc, out, jrc, jout


def test_single_clip_json(clips):
    rc, out, jrc, jout = _both([str(clips / "a.mp4")])
    assert rc == jrc == 0
    assert out == jout
    env = json.loads(out)
    assert env["ok"] is True
    assert list(env)[:6] == ["ok", "meta", "hints", "video", "audio",
                             "result"]


def test_indent(clips):
    rc, out, jrc, jout = _both([str(clips / "b.mp4"), "--indent", "2"])
    assert rc == jrc == 0 and out == jout and "\n  " in out


def test_directory_batch_jsonl(clips):
    rc, out, jrc, jout = _both([str(clips), "--jsonl"])
    assert rc == jrc == 0
    assert out == jout
    lines = [json.loads(x) for x in out.splitlines()]
    assert [os.path.basename(x["path"]) for x in lines] == ["a.mp4", "b.mp4"]
    for x in lines:
        assert x["response"]["ok"] is True
        assert x["response"]["result"]["label"] in ("real", "ai", "uncertain")


def test_batch_records_failures_and_continues(clips, tmp_path):
    bad = tmp_path / "broken.mp4"
    bad.write_bytes(b"\x00" * 64)  # undecodable
    rc, out, jrc, jout = _both([str(bad), str(clips / "a.mp4"), "--jsonl"])
    assert rc == jrc == 0
    assert out == jout
    lines = [json.loads(x) for x in out.splitlines()]
    assert len(lines) == 2 and all("response" in x for x in lines)


def test_multiple_inputs_require_jsonl(clips):
    with pytest.raises(SystemExit):
        cli.main([str(clips / "a.mp4"), str(clips / "b.mp4"), "--device",
                  "cpu"])


def test_indent_and_jsonl_conflict(clips):
    with pytest.raises(SystemExit):
        cli.main([str(clips / "a.mp4"), "--jsonl", "--indent", "2"])


def test_no_files_found(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    assert cli.main([str(empty), "--jsonl", "--device", "cpu"]) == \
        jcli.main([str(empty), "--jsonl"]) == 2


def test_default_device_is_cuda(clips, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([str(clips / "a.mp4")])


def test_device_path_through_the_module_entry(clips, monkeypatch):
    """``python -m avd_tpu_torch.analyze`` in a fresh interpreter on the
    device path (``--backend jax`` over the fixture's oracle setting)."""
    monkeypatch.delenv("AVD_BACKEND")
    r = subprocess.run([sys.executable, "-m", "avd_tpu_torch.analyze",
                        str(clips / "a.mp4"), "--device", "cpu",
                        "--backend", "jax"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    ours = json.loads(r.stdout)
    rc, jout = _run(jcli.main, [str(clips / "a.mp4"), "--backend", "jax"])
    assert rc == 0
    assert_same_envelope(ours, json.loads(jout))
