"""Packaging of the port: what an installed ``avd_tpu_torch`` carries, and
where it builds its native libraries when its own directory is read-only.

The port's counterpart of ``tests/test_packaging.py``'s data and
read-only cases:

* setuptools' package-data resolution for this ``pyproject.toml`` (the
  file list ``build_py`` copies into a wheel) holds every file under
  ``avd_tpu_torch/models/weights/`` and ``avd_tpu_torch/native/src/``,
  and the CUDA sources;
* with the checkout's build directory unwritable, the host runtime is
  built by g++ into the per-user cache (``AVD_NATIVE_CACHE``) and loads;
* the nvcc module's choice of directory, as a pure function (no nvcc
  here).
"""

import ctypes
import os

import pytest

from avd_tpu_torch.native import _build as host_build
from avd_tpu_torch.ops.kernels import _build as kernel_build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _files_under(*parts):
    root = os.path.join(REPO, *parts)
    return {os.path.relpath(os.path.join(d, f), REPO)
            for d, _, files in os.walk(root) for f in files
            if "__pycache__" not in d}


@pytest.fixture(scope="module")
def wheel_files(tmp_path_factory):
    """Every data file ``build_py`` puts in a wheel, relative to the
    repo."""
    from setuptools.config.pyprojecttoml import apply_configuration
    from setuptools.dist import Distribution
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        dist = apply_configuration(Distribution(), "pyproject.toml")
        # package-data alone, without the MANIFEST scan (which runs
        # egg_info and writes into the checkout)
        dist.include_package_data = False
        cmd = dist.get_command_obj("build_py")
        cmd.build_lib = str(tmp_path_factory.mktemp("wheel_lib"))
        cmd.ensure_finalized()
        out = set()
        for _pkg, src_dir, _build_dir, names in cmd.data_files:
            out |= {os.path.normpath(os.path.join(src_dir, n)) for n in names}
        return out
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("where", [
    ("avd_tpu_torch", "models", "weights"),
    ("avd_tpu_torch", "native", "src"),
    ("avd_tpu_torch", "csrc"),
])
def test_wheel_carries_the_ports_data(wheel_files, where):
    want = {f for f in _files_under(*where) if not f.endswith(".so")}
    assert want, where
    missing = sorted(want - wheel_files)
    assert missing == []


def test_wheel_carries_every_shipped_checkpoint(wheel_files):
    for fam in ("detector_full", "detector_small", "moe_small",
                "cnn_small", "temporal_small"):
        for name in ("params.npz", "train_meta.json", "calibration.json"):
            assert os.path.join("avd_tpu_torch", "models", "weights", fam,
                                name) in wheel_files, (fam, name)


def test_build_dir_prefers_the_checkout(tmp_path, monkeypatch):
    monkeypatch.setenv("AVD_NATIVE_CACHE", str(tmp_path / "cache"))
    preferred = str(tmp_path / "repo" / "build" / "x")
    assert host_build.choose_build_dir(preferred, "host") == preferred


@pytest.mark.parametrize("env", [True, False])
def test_build_dir_falls_back_to_the_user_cache(tmp_path, monkeypatch, env):
    home = tmp_path / "home"
    monkeypatch.setenv("HOME", str(home))
    if env:
        monkeypatch.setenv("AVD_NATIVE_CACHE", str(tmp_path / "cache"))
        root = tmp_path / "cache"
    else:
        monkeypatch.delenv("AVD_NATIVE_CACHE", raising=False)
        root = home / ".cache" / "avd_tpu_torch"
    got = host_build.choose_build_dir("/nowhere/build", "host",
                                      writable=lambda p: False)
    assert got == str(root / "host")


def test_writable_walks_up_to_an_existing_directory(tmp_path, monkeypatch):
    assert host_build._writable(str(tmp_path / "a" / "b" / "c"))
    monkeypatch.setattr(os, "access", lambda p, m: False)
    assert not host_build._writable(str(tmp_path / "a" / "b" / "c"))


def test_nvcc_build_dir_follows_the_rule(tmp_path, monkeypatch):
    """The kernels' directory is ``BUILD_DIR`` when it can be written and
    ``$AVD_NATIVE_CACHE/kernels`` when not; the library's name (its digest
    of sources and flags) is the same in both."""
    monkeypatch.setenv("AVD_NATIVE_CACHE", str(tmp_path / "cache"))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", str(tmp_path / "ro"))
    assert kernel_build.build_dir() == str(tmp_path / "ro")
    here = kernel_build.lib_path("warp")
    monkeypatch.setattr(host_build, "_writable", lambda p: False)
    assert kernel_build.build_dir() == str(tmp_path / "cache" / "kernels")
    there = kernel_build.lib_path("warp")
    assert os.path.dirname(there) == str(tmp_path / "cache" / "kernels")
    assert os.path.basename(there) == os.path.basename(here)


def test_read_only_package_builds_the_host_runtime_in_the_cache(
        tmp_path, monkeypatch):
    """The package's build directory unwritable: g++ builds
    ``avd_native.cc`` into the per-user cache, and the library loads."""
    ro = tmp_path / "site-packages" / "build" / "avd_tpu_torch_host"
    monkeypatch.setattr(host_build, "BUILD_DIR", str(ro))
    monkeypatch.setenv("AVD_NATIVE_CACHE", str(tmp_path / "cache"))
    real = host_build._writable
    monkeypatch.setattr(host_build, "_writable", lambda p: False if str(
        p).startswith(str(ro)) else real(p))
    path = host_build.build()
    assert os.path.dirname(path) == str(tmp_path / "cache" / "host")
    assert not ro.exists()
    lib = ctypes.CDLL(path)
    assert hasattr(lib, "avd_bgr_to_gray_u8")
