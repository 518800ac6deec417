"""The dispatch stage of the port's video path (``ops/video_features.
_dispatch_pool``, one ``avd-dispatch`` thread) and the thread-safe launch
counters of the kernel wrappers (``ops/kernels/_launches.py``), on the CPU.

A clip of 29 frames at 64×96 with the chunk patched to 8 makes three
full windows and a tail.  Through the dispatch thread the features equal
the inline order (each window enqueued on the calling thread) exactly,
and ``avd_tpu``'s ``compute_features_streaming`` at the flow contract of
tests/test_pallas_blur_solve.py:108-111 (means rtol 1e-4, variances rtol
1e-3; duplicates and textures exact).
"""

import concurrent.futures
import os
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from avd_tpu.ops import video_features as jvf
from avd_tpu_torch import config as config_mod
from avd_tpu_torch.ops import video_features as tvf
from avd_tpu_torch.ops.kernels import _launches, attention, blur_solve
from avd_tpu_torch.ops.kernels import flow_iter, warp

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHUNK = 8
N_FRAMES = 3 * CHUNK + 5  # three full windows and a tail
N_WINDOWS = 4


def _box(a, r):
    """Box mean of radius ``r`` over the first two axes (edges clipped)."""
    for axis in (0, 1):
        c = np.cumsum(np.pad(a, [(r + 1, r) if i == axis else (0, 0)
                                 for i in range(a.ndim)], mode="edge"),
                      axis=axis)
        a = (np.take(c, np.arange(2 * r + 1, c.shape[axis]), axis=axis)
             - np.take(c, np.arange(0, c.shape[axis] - 2 * r - 1),
                       axis=axis)) / (2 * r + 1)
    return a


@pytest.fixture(scope="module")
def frames():
    """A (1, 2) px/frame pan over smooth seeded noise, 64×96 BGR, with
    one repeated frame (a duplicate pair)."""
    rng = np.random.default_rng(13)
    base = _box(rng.uniform(0, 255, (64 + N_FRAMES, 96 + 2 * N_FRAMES, 3)),
                3)
    base = np.clip((base - base.mean()) * 4 + 128, 0, 255).astype(np.uint8)
    out = np.stack([base[k:k + 64, 2 * k:2 * k + 96]
                    for k in range(N_FRAMES)])
    out[10] = out[9]
    return out


class _InlinePool:
    """The inline order: each ``submit`` runs at once on the caller."""

    def submit(self, fn, *args):
        f = concurrent.futures.Future()
        try:
            f.set_result(fn(*args))
        except Exception as e:  # the future carries it, as a pool's does
            f.set_exception(e)
        return f


class _NoPool:
    """A pool that must not be asked for work."""

    def submit(self, *args):
        raise AssertionError("a window was submitted to the dispatch pool")


_POOL = tvf._dispatch_pool  # the real one, also while a test patches it


def _drop_pool():
    if _POOL.cache_info().currsize:
        _POOL().shutdown(wait=True)
    _POOL.cache_clear()


@pytest.fixture
def env(monkeypatch):
    for name in ("AVD_DISPATCH_WORKERS", "AVD_PREP", "AVD_CHANGE_GATE",
                 "AVD_BATCH_WINDOW_MS", "AVD_PALLAS_ITER", "AVD_FLOW_BF16"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(tvf, "_DEFAULT_CHUNK", CHUNK)
    config_mod.reset_config()
    _drop_pool()
    yield monkeypatch
    _drop_pool()
    config_mod.reset_config()


def _chunks(frames, k=5):
    return (frames[i:i + k] for i in range(0, len(frames), k))


def _run(entry, frames, batcher=None):
    if entry == "streaming":
        return tvf.compute_features_streaming(_chunks(frames), device="cpu",
                                              batcher=batcher)
    return tvf.compute_features(frames, device="cpu")


def _inline(env, entry, frames):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tvf, "_dispatch_pool", lambda: _InlinePool())
        return _run(entry, frames)


def _record_threads(env):
    """Wrap ``run_prep_window``: the names of the threads that ran it."""
    names = []
    orig = tvf.run_prep_window

    def rec(*args, **kw):
        names.append(threading.current_thread().name)
        return orig(*args, **kw)

    env.setattr(tvf, "run_prep_window", rec)
    return names


@pytest.mark.parametrize("entry", ["streaming", "batch"])
def test_dispatch_equals_the_inline_order(env, frames, entry):
    ref = _inline(env, entry, frames)
    names = _record_threads(env)
    out = _run(entry, frames)
    assert out == ref
    assert out["total"] == N_FRAMES and out["dup"] >= 1
    assert len(names) == N_WINDOWS
    assert len(set(names)) == 1 and names[0].startswith("avd-dispatch"), \
        names


def test_dispatch_matches_avd_tpu(env, frames):
    env.setattr(jvf, "_DEFAULT_CHUNK", CHUNK)
    ref = jvf.compute_features_streaming(_chunks(frames))
    out = _run("streaming", frames)
    assert out["total"] == ref["total"] == N_FRAMES
    assert out["dup"] == ref["dup"]
    assert out["textures"] == ref["textures"]
    # The duplicate pair (frames 9, 10) has no motion: both packages leave
    # a residual |flow| of about 3e-4 px there (measured 3.41e-4 against
    # 2.81e-4, the same in the inline order), rounding that no relative
    # bound holds.  It is held to 1e-3 px on both sides; every moving
    # pair to the flow contract.
    means, ref_means = (np.asarray(f["flow_means"]) for f in (out, ref))
    still = ref_means < 1e-2
    assert still.tolist() == [i == 9 for i in range(N_FRAMES - 1)]
    assert np.abs(means[still]).max() < 1e-3
    assert np.abs(ref_means[still]).max() < 1e-3
    np.testing.assert_allclose(means[~still], ref_means[~still],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(np.asarray(out["flow_vars"])[~still],
                               np.asarray(ref["flow_vars"])[~still],
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(out["timeline_ai"], ref["timeline_ai"],
                               atol=1e-4)


def test_windows_are_enqueued_one_at_a_time(env, frames):
    """One window is enqueued at a time, also with two callers streaming
    at once (two requests of a serving worker): concurrent enqueues hand
    the interpreter lock to each other on every torch call."""
    orig = tvf.run_prep_window
    lock = threading.Lock()
    active, most = [0], [0]

    def counted(*args, **kw):
        with lock:
            active[0] += 1
            most[0] = max(most[0], active[0])
        try:
            threading.Event().wait(0.05)  # room for a second enqueuer
            return orig(*args, **kw)
        finally:
            with lock:
                active[0] -= 1

    env.setattr(tvf, "run_prep_window", counted)
    with concurrent.futures.ThreadPoolExecutor(2) as callers:
        outs = list(callers.map(lambda _: _run("streaming", frames), "ab"))
    assert [o["total"] for o in outs] == [N_FRAMES, N_FRAMES]
    assert outs[0] == outs[1]
    assert most[0] == 1


class _ReversedPool:
    """Threads whose futures finish last window first: window i waits
    until window i+1 has finished."""

    def __init__(self):
        self.pool = concurrent.futures.ThreadPoolExecutor(N_WINDOWS)
        self.done = [threading.Event() for _ in range(N_WINDOWS)]
        self.order = []
        self.submitted = 0

    def submit(self, fn, *args):
        i = self.submitted
        self.submitted += 1

        def job():
            if i + 1 < N_WINDOWS and not self.done[i + 1].wait(120):
                raise TimeoutError(f"window {i + 1} never finished")
            try:
                return fn(*args)
            finally:
                self.order.append(i)
                self.done[i].set()

        return self.pool.submit(job)


def test_out_of_order_futures_give_the_same_features(env, frames):
    ref = _inline(env, "streaming", frames)
    pool = _ReversedPool()
    env.setattr(tvf, "_dispatch_pool", lambda: pool)
    try:
        assert _run("streaming", frames) == ref
    finally:
        pool.pool.shutdown(wait=True)
    assert pool.order == [3, 2, 1, 0]


def test_a_dispatch_thread_exception_reaches_the_caller(env, frames):
    orig = tvf.run_prep_window
    lock = threading.Lock()
    ran, finished = [], []

    def failing(*args, **kw):
        with lock:
            ran.append(threading.current_thread().name)
            k = len(ran)
        try:
            if k == 2:
                raise RuntimeError("kernel launch failed on window 2")
            return orig(*args, **kw)
        finally:
            with lock:
                finished.append(k)

    env.setattr(tvf, "run_prep_window", failing)
    for entry in ("streaming", "batch"):
        ran.clear()
        finished.clear()
        with pytest.raises(RuntimeError, match="failed on window 2"):
            _run(entry, frames)
        # every window of the call had finished when the error came out
        assert sorted(finished) == list(range(1, N_WINDOWS + 1))
        assert all(n.startswith("avd-dispatch") for n in ran), ran


class _SyncBatcher:
    """A batcher stand-in: each host-prep window runs at once."""

    def __init__(self):
        self.jobs = 0

    def submit_prep(self, w320, w32, device):
        self.jobs += 1
        return _InlinePool().submit(
            lambda: tvf.run_prep_window(w320, w32, device).numpy())


def test_a_batcher_takes_every_window_and_the_pool_none(env, frames):
    ref = _inline(env, "streaming", frames)
    env.setattr(tvf, "_dispatch_pool", lambda: _NoPool())
    b = _SyncBatcher()
    out = _run("streaming", frames, batcher=b)
    assert b.jobs == N_WINDOWS
    assert out["dup"] == ref["dup"] and out["textures"] == ref["textures"]
    np.testing.assert_allclose(out["flow_means"], ref["flow_means"],
                               rtol=2e-5, atol=1e-5)
    np.testing.assert_allclose(out["flow_vars"], ref["flow_vars"],
                               rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("entry", ["streaming", "batch"])
def test_device_prep_windows_stay_on_the_calling_thread(env, frames, entry):
    env.setenv("AVD_PREP", "device")
    config_mod.reset_config()
    env.setattr(tvf, "_dispatch_pool", lambda: _NoPool())
    out = _run(entry, frames)
    assert out["total"] == N_FRAMES and len(out["flow_means"]) == N_FRAMES - 1
    assert _POOL.cache_info().currsize == 0


@pytest.mark.parametrize("value", [None, "4"])
def test_the_pool_is_one_named_thread(env, value):
    """One ``avd-dispatch`` thread a process, whatever ``avd_tpu``'s
    ``AVD_DISPATCH_WORKERS`` says: the port does not read it."""
    if value is not None:
        env.setenv("AVD_DISPATCH_WORKERS", value)
    pool = tvf._dispatch_pool()
    assert tvf._dispatch_pool() is pool  # one a process
    assert pool._max_workers == 1
    assert pool._thread_name_prefix == "avd-dispatch"


_WARM_PROBE = r"""
import threading
from avd_tpu_torch.ops import video_features as vf
def dispatch_threads():
    return [t.name for t in threading.enumerate()
            if t.name.startswith("avd-dispatch")]
assert not dispatch_threads() and vf._dispatch_pool.cache_info().currsize == 0
vf.warm_device(device="cpu")
assert vf.device_warmed()
assert not dispatch_threads(), dispatch_threads()
assert vf._dispatch_pool.cache_info().currsize == 0
print("ok")
"""


def test_import_and_warm_up_start_no_dispatch_thread():
    env = {k: v for k, v in os.environ.items() if k != "AVD_PREP"}
    env["AVD_VIDEO_CHUNK"] = "4"  # warm windows of 2, 3, 4 and 5 frames
    r = subprocess.run([sys.executable, "-c", _WARM_PROBE], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-3000:]


def test_compute_features_marks_the_device_warm(env, frames):
    env.setattr(tvf, "_DEVICE_WARM", False)
    tvf.compute_features(frames[:CHUNK + 3], device="cpu")
    assert tvf.device_warmed()


# ---------------------------------------------------------------------------
# launch counters and symbol caches across threads
# ---------------------------------------------------------------------------

def test_launch_counts_are_exact_across_threads():
    ns = {"LAUNCHES": 0, "BY": {"a": 0, "b": 0}}
    n_threads, per = 16, 2000
    start = threading.Barrier(n_threads)

    def work(i):
        start.wait(30)
        for _ in range(per):
            _launches.count(ns, "BY", "ab"[i % 2])

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert ns["LAUNCHES"] == n_threads * per
    assert ns["BY"] == {"a": n_threads * per // 2, "b": n_threads * per // 2}


def _fake_lib(name):
    fns = {n: types.SimpleNamespace() for n in (
        "avd_warp_bilinear", "avd_warp_bilinear_bf16", "avd_blur_solve",
        "avd_blur_solve_bf16", "avd_flow_iter", "avd_mha_mma",
        "avd_mha_general", "avd_mha_smem_bytes")}
    return types.SimpleNamespace(
        avd_mha_mma_max_tokens=lambda: attention.MMA_MAX_TOKENS, **fns)


@pytest.mark.parametrize("mod, call", [
    (warp, lambda: warp._lib(torch.float32)),
    (blur_solve, lambda: blur_solve._lib(torch.bfloat16)),
    (flow_iter, lambda: flow_iter._lib()),
    (attention, lambda: attention._lib()),
], ids=["warp", "blur_solve", "flow_iter", "attention"])
def test_symbols_are_bound_once_across_threads(monkeypatch, mod, call):
    """Concurrent first calls bind the library's functions once and every
    caller gets them with their argument types set."""
    loads = []

    def load(name):
        loads.append(name)
        threading.Event().wait(0.05)  # widen the window for a race
        return _fake_lib(name)

    monkeypatch.setattr(mod, "_fns", {})
    monkeypatch.setattr(mod._build, "load", load)
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        got = list(pool.map(lambda _: call(), range(8)))
    assert len(loads) == 1
    assert all(g is got[0] for g in got)
    bound = got[0].values() if isinstance(got[0], dict) else [got[0]]
    assert all(getattr(fn, "argtypes", None) for fn in bound)
