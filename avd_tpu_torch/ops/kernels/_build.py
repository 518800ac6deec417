"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/avd_tpu_torch_kernels/lib<name>-<digest>.so`` under the
checkout, at first use (where that cannot be written, into the per-user
cache ``$AVD_NATIVE_CACHE/kernels``, default
``~/.cache/avd_tpu_torch/kernels``: ``build_dir``); the digest covers the
source, every header
``csrc/*.cuh`` and the flags, so an edited source or header rebuilds and
an unchanged one loads the cached library.  ``build_all`` starts one nvcc
per source at once and waits for all; what nvcc printed (``-Xptxas -v``:
registers, shared memory and spills of each kernel) stays in
``BUILD_LOGS``.  Builds hold an exclusive lock on ``.lock`` in the build
directory, so
processes that start together on a fresh tree (the serving workers) run
each nvcc once: the others wait and load what it wrote.
Nothing here runs at import time: the CPU tests import every module on a
machine with no nvcc.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from avd_tpu_torch.native import _build as host_build

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "avd_tpu_torch_kernels")
SOURCES = ("warp", "blur_solve", "flow_iter", "attention")

# --fmad=false: the kernels keep the plain versions' rounding (no fused
# multiply-add contraction), so a near-singular 2×2 solve does not turn a
# last-bit difference into a visible one.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

BUILD_LOGS: dict = {}  # source name → nvcc's output of the build in this run
_lock = threading.Lock()
_libs: dict = {}


def build_dir() -> str:
    """``BUILD_DIR``, or the per-user cache where it cannot be written
    (``native/_build.choose_build_dir``)."""
    return host_build.choose_build_dir(BUILD_DIR, "kernels")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: put the CUDA toolkit on PATH or "
                       "set CUDA_HOME")


def lib_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    for path in [os.path.join(CSRC, f"{name}.cu")] + headers:
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(build_dir(), f"lib{name}-{digest.hexdigest()[:12]}.so")


@contextlib.contextmanager
def _build_lock():
    """Exclusive across processes; the kernel drops it if one dies."""
    where = build_dir()
    os.makedirs(where, exist_ok=True)
    with open(os.path.join(where, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        yield


def _start(name: str):
    """Start nvcc for one source; None when its library is already built
    (checked under ``_build_lock``: another process may have built it
    while this one waited)."""
    out = lib_path(name)
    if os.path.exists(out):
        return None
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    BUILD_LOGS[name] = log
    os.replace(tmp, out)  # atomic: a cut build never leaves a partial .so


def build_all(names=SOURCES) -> float:
    """Build every source in parallel (one nvcc each); returns seconds."""
    t0 = time.perf_counter()
    with _lock, _build_lock():
        started = [(n, _start(n)) for n in names]
        for n, s in started:
            _finish(n, s)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` (built on first use)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                if not os.path.exists(lib_path(name)):
                    with _build_lock():
                        _finish(name, _start(name))
                lib = ctypes.CDLL(lib_path(name))
                _libs[name] = lib
    return lib


def check_cuda(x, name: str, dtypes=None) -> None:
    """Wrapper-side input contract shared by the kernels: on a CUDA
    device, contiguous, of one of ``dtypes`` (default float32 alone)."""
    import torch
    dtypes = dtypes or (torch.float32,)
    if x.device.type != "cuda":
        raise ValueError(f"{name} must lie on a CUDA device, not {x.device}")
    if x.dtype not in dtypes:
        want = " or ".join(str(d).replace("torch.", "") for d in dtypes)
        raise TypeError(f"{name} must be {want}, not {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
