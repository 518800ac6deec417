"""Build the port's C++ host libraries with g++ and load them with ctypes.

``src/avd_native.cc`` (the host runtime) compiles, at first use, into
``build/avd_tpu_torch_host/libavd_native-<digest>.so`` under the checkout;
``src/avd_decode.cc`` (the libav* decoder, ``decode.py``) beside it with
``DECODE_FLAGS`` and ``DECODE_LIBS``.  Where the checkout's ``build/``
cannot be written (an installed package in a read-only site-packages),
builds go to a per-user cache instead (``choose_build_dir``:
``$AVD_NATIVE_CACHE/host``, default ``~/.cache/avd_tpu_torch/host``).
The digest covers the source, the flags and the host CPU's feature flags
(``-march=native`` makes a library for the machine that built it, so a
build directory copied to another machine rebuilds instead of loading
instructions that machine may lack).  g++ writes to a per-process temp
file that ``os.replace`` moves into place, under an exclusive file lock:
concurrent processes (test workers) build once, and a cut build never
leaves a partial library.  A failed compile raises with g++'s output.
Nothing here runs at import time.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(_PKG, "native", "src", "avd_native.cc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build",
                         "avd_tpu_torch_host")
# the JAX package's flags (avd_tpu/native/__init__.py)
FLAGS = ("-O3", "-march=native", "-funroll-loops", "-fPIC", "-std=c++17",
         "-pthread", "-shared")
# the decoder's flags and libraries, the JAX package's
# (avd_tpu/native/decode.py)
DECODE_SRC = os.path.join(_PKG, "native", "src", "avd_decode.cc")
DECODE_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
DECODE_LIBS = ("-lavformat", "-lavcodec", "-lavutil", "-lswscale",
               "-lswresample")

BUILD_INFO: dict = {}  # what the last compile in this process took and said


def _writable(path: str) -> bool:
    """``path``, or its nearest existing ancestor, is a directory this
    process may write into."""
    while not os.path.exists(path):
        parent = os.path.dirname(path)
        if parent == path:
            return False
        path = parent
    return os.path.isdir(path) and os.access(path, os.W_OK)


def choose_build_dir(preferred: str, sub: str, writable=None) -> str:
    """``preferred`` (the checkout's build directory) when it can be
    written, else ``sub`` under the per-user cache: ``$AVD_NATIVE_CACHE``,
    default ``~/.cache/avd_tpu_torch``.  Library names carry a digest of
    the sources' content and the flags, never an mtime: a wheel's files
    keep the build machine's archive times, so a cache keyed by mtime
    would go on loading an older library after an upgrade."""
    if (writable or _writable)(preferred):
        return preferred
    root = os.getenv("AVD_NATIVE_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "avd_tpu_torch")
    return os.path.join(root, sub)


def default_build_dir() -> str:
    """Where this process builds the host libraries (``BUILD_DIR`` or the
    per-user cache)."""
    return choose_build_dir(BUILD_DIR, "host")


def gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the port's host runtime "
                           "(avd_tpu_torch/native) is built with it at "
                           "first use; set AVD_NATIVE=0 to run the numpy "
                           "plain versions instead")
    return found


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def lib_path(src: str = SRC, build_dir: str | None = None, flags=None,
             libs=()) -> str:
    """Where the library of ``src`` built with ``flags`` (default
    ``FLAGS``) and ``libs`` lives (in ``build_dir``, default
    ``default_build_dir()``)."""
    flags = FLAGS if flags is None else flags
    build_dir = build_dir or default_build_dir()
    digest = hashlib.sha256(" ".join(flags + libs).encode() + b"\0"
                            + _cpu_flags())
    with open(src, "rb") as f:
        digest.update(f.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build(src: str = SRC, build_dir: str | None = None, flags=None,
          libs=()) -> str:
    """The library built from ``src`` (compiled now unless it exists)."""
    flags = FLAGS if flags is None else flags
    build_dir = build_dir or default_build_dir()
    out = lib_path(src, build_dir, flags, libs)
    if os.path.exists(out):
        return out
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if os.path.exists(out):  # another process built it meanwhile
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [gxx(), *flags, "-o", tmp, src, *libs]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"g++ failed for {os.path.basename(src)} (exit "
                    f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=out,
                          command=" ".join(cmd))
    return out


def version() -> str:
    """The first line of ``g++ --version``."""
    r = subprocess.run([gxx(), "--version"], capture_output=True, text=True,
                       timeout=60)
    return r.stdout.splitlines()[0] if r.stdout else r.stderr.strip()
