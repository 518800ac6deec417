"""``ops/kernels/_build``: the library path follows the source, the headers
and the flags, and processes building together run each nvcc once.  No
nvcc is needed: only the digest is computed, or a stub stands in."""

import os
import subprocess
import sys

import pytest

from avd_tpu_torch.ops.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    (tmp_path / "alpha.cu").write_text('#include "frag.cuh"\nint a;\n')
    (tmp_path / "beta.cu").write_text("int b;\n")
    (tmp_path / "frag.cuh").write_text("// fragments\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    return tmp_path


def test_lib_path_changes_when_a_header_does(csrc):
    first = _build.lib_path("alpha")
    assert first == _build.lib_path("alpha")
    assert os.path.dirname(first) == _build.BUILD_DIR
    assert os.path.basename(first).startswith("libalpha-")
    (csrc / "frag.cuh").write_text("// fragments, edited\n")
    edited = _build.lib_path("alpha")
    assert edited != first
    (csrc / "frag.cuh").write_text("// fragments\n")
    assert _build.lib_path("alpha") == first


def test_lib_path_covers_every_header_for_every_source(csrc):
    """A source that includes no header rebuilds too: the digest does not
    parse includes, it takes every ``csrc/*.cuh``."""
    before = {n: _build.lib_path(n) for n in ("alpha", "beta")}
    (csrc / "more.cuh").write_text("// a second header\n")
    after = {n: _build.lib_path(n) for n in ("alpha", "beta")}
    assert all(before[n] != after[n] for n in before)
    assert after["alpha"] != after["beta"]


def test_lib_path_changes_with_the_source_and_the_flags(csrc, monkeypatch):
    first = _build.lib_path("beta")
    (csrc / "beta.cu").write_text("int b2;\n")
    assert _build.lib_path("beta") != first
    (csrc / "beta.cu").write_text("int b;\n")
    assert _build.lib_path("beta") == first
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-g",))
    assert _build.lib_path("beta") != first


def test_a_renamed_header_is_another_build(csrc):
    first = _build.lib_path("alpha")
    os.rename(csrc / "frag.cuh", csrc / "frag2.cuh")
    assert _build.lib_path("alpha") != first


def test_the_port_ships_the_headers_its_sources_include():
    """Every ``#include "x.cuh"`` of a shipped source names a file in
    ``csrc``, and every source in ``SOURCES`` exists."""
    for name in _build.SOURCES:
        path = os.path.join(_build.CSRC, f"{name}.cu")
        assert os.path.exists(path)
        with open(path) as f:
            for line in f:
                if line.startswith('#include "'):
                    header = line.split('"')[1]
                    assert os.path.exists(os.path.join(_build.CSRC, header))


_BUILD_ALL = r"""
import sys
from avd_tpu_torch.ops.kernels import _build
_build.BUILD_DIR = sys.argv[1]
_build.build_all()
"""


def test_two_processes_run_each_nvcc_once(tmp_path):
    """Two processes that start ``build_all`` together on a fresh build
    directory (the serving workers of a fresh tree) compile each source
    once: the second waits on ``BUILD_DIR/.lock`` and finds the libraries
    built.  ``nvcc`` is a stub on PATH that sleeps, writes its ``-o`` file
    and logs it."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    log = tmp_path / "nvcc.log"
    stub = bindir / "nvcc"
    stub.write_text(
        "#!/bin/sh\nout=''\nwhile [ $# -gt 0 ]; do\n"
        "  if [ \"$1\" = -o ]; then out=\"$2\"; shift; fi\n  shift\ndone\n"
        f"sleep 1\necho \"$out\" >> '{log}'\necho stub > \"$out\"\n")
    stub.chmod(0o755)
    build = tmp_path / "build"
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_ALL, str(build)],
                              env=env, cwd=repo) for _ in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    compiled = [os.path.basename(x) for x in log.read_text().split()]
    assert len(compiled) == len(_build.SOURCES)
    assert sorted(c.split("-")[0] for c in compiled) == \
        sorted(f"lib{n}" for n in _build.SOURCES)
    want = {os.path.basename(_build.lib_path(n)) for n in _build.SOURCES}
    assert set(os.listdir(build)) == want | {".lock"}
