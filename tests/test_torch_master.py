"""The port's pre-fork master (``python -m avd_tpu_torch.serve.master
--device cpu``): the cases of tests/test_master.py — spawn, serve, recycle
after max_requests, graceful shutdown, Gunicorn's runtime signal surface
(SIGTTIN/SIGTTOU scale, SIGHUP zero-downtime rolling restart), the
heartbeat reaper — plus the port's rules: a worker without CUDA stops the
master (no silent CPU run), and the warm-up runs the device work, the
stacked-window ladder and the detector once.

Ports are picked free at run time (tests/test_master.py holds fixed ones
and runs beside this file under xdist).  Every wait polls a log or pid
state against a deadline; none relies on a fixed sleep.
"""

import http.client
import json
import os
import re
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from avd_tpu_torch import config as cfg_mod
from avd_tpu_torch.models import scoring
from avd_tpu_torch.ops import video_features as vf
from avd_tpu_torch.serve import batching
from avd_tpu_torch.serve import master as m

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port, path, timeout=5):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def _read(path) -> str:
    with open(path) as f:
        return f.read()


def _wait_for(cond, what, timeout=30.0, log=None):
    """Poll ``cond()`` until it returns a truthy value or the deadline."""
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(0.1)
    pytest.fail(f"timed out waiting for {what}"
                + (f"; log:\n{_read(log)}" if log else ""))


def _wait_log(log, needle, count=1, timeout=30.0):
    return _wait_for(lambda: (lambda t: t if t.count(needle) >= count
                              else None)(_read(log)),
                     f"{count}x {needle!r}", timeout, log)


def _spawn(tmp_path, device="cpu", **env_over):
    """Start a master on a free port, its log in ``tmp_path``; returns
    (proc, port, log) at once (``_ready`` waits for /healthz)."""
    port = _free_port()
    log = tmp_path / f"master_{port}.log"
    env = dict(os.environ)
    env.update({
        "GUNICORN_BIND": f"127.0.0.1:{port}",
        "WEB_CONCURRENCY": "1",
        "GUNICORN_MAX_REQUESTS": "0",
        "GUNICORN_GRACEFUL_TIMEOUT": "5",
        "AVD_BACKEND": "oracle",
    })
    env.update(env_over)
    argv = [sys.executable, "-m", "avd_tpu_torch.serve.master"]
    if device:
        argv += ["--device", device]
    with open(log, "w") as lf:
        proc = subprocess.Popen(argv, env=env, cwd=REPO, stdout=lf,
                                stderr=subprocess.STDOUT, text=True)
    return proc, port, log


def _ready(proc, port, log):
    def up():
        try:
            return _get(port, "/healthz", timeout=1)[0] == 200
        except OSError:
            return False
    _wait_for(up, "the master to serve", 60, log)
    return proc, port, log


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)


@pytest.fixture
def master_proc(tmp_path):
    proc, port, log = _ready(*_spawn(
        tmp_path, WEB_CONCURRENCY="2", GUNICORN_MAX_REQUESTS="5",
        GUNICORN_MAX_REQUESTS_JITTER="0"))
    yield proc, port, log
    _stop(proc)


def test_master_serves_and_recycles(master_proc):
    proc, port, log = master_proc
    ok = 0
    for _ in range(25):
        try:
            status, d = _get(port, "/healthz")
            if status == 200 and d["ok"]:
                ok += 1
        except OSError:
            time.sleep(0.3)
    assert ok >= 20
    assert proc.poll() is None  # master still alive
    _wait_log(log, "zero-downtime recycle")


def test_master_graceful_shutdown(master_proc):
    proc, _, log = master_proc
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=20)
    assert proc.returncode == 0
    assert "[master] shutdown complete" in _read(log)


def test_zero_downtime_recycle(tmp_path):
    """ONE worker with a tiny budget: the replacement is bound and warm
    BEFORE the old worker retires, so a continuous probe sees no hard
    connection failure (one immediate retry allowed: SO_REUSEPORT has no
    graceful leave)."""
    proc, port, log = _ready(*_spawn(tmp_path, GUNICORN_MAX_REQUESTS="3",
                                     GUNICORN_MAX_REQUESTS_JITTER="0"))
    try:
        hard_failures = retried = ok = 0
        for _ in range(30):  # 10 recycle cycles at budget 3
            try:
                status, d = _get(port, "/healthz", timeout=5)
            except OSError:
                retried += 1
                try:
                    status, d = _get(port, "/healthz", timeout=5)
                except OSError:
                    hard_failures += 1
                    continue
            if status == 200 and d["ok"]:
                ok += 1
            time.sleep(0.05)
        assert hard_failures == 0
        assert ok == 30
        assert retried <= 3, f"{retried} resets — blackhole too wide"
        _wait_log(log, "zero-downtime recycle")
    finally:
        _stop(proc)


def test_sigttin_sigttou_scale(tmp_path):
    proc, port, log = _ready(*_spawn(tmp_path))
    try:
        _wait_log(log, "serving on")
        proc.send_signal(signal.SIGTTIN)
        _wait_log(log, "scale-up to 2 workers")
        _wait_log(log, "serving on", count=2)
        proc.send_signal(signal.SIGTTOU)
        _wait_log(log, "scale-down to 1 workers")
        _wait_log(log, "retired (scale-down)")
        proc.send_signal(signal.SIGTTOU)
        _wait_log(log, "scale-down ignored (already at 1 worker)")
        status, d = _get(port, "/healthz")
        assert status == 200 and d["ok"]
    finally:
        _stop(proc)
    assert proc.returncode == 0


def _pids(text, pattern):
    return set(re.findall(pattern, text))


def test_sighup_rolling_restart(tmp_path):
    """SIGHUP replaces every worker zero-downtime: new pids serve, old
    pids retire through the recycle path, probes never hard-fail.  Both
    workers must be serving before the HUP (waited for in the log: the
    first /healthz answer means only one is)."""
    proc, port, log = _ready(*_spawn(tmp_path, WEB_CONCURRENCY="2"))
    serving = r"\[worker (\d+)\] serving on"
    try:
        text = _wait_log(log, "serving on", count=2)
        before = _pids(text, serving)
        assert len(before) == 2
        proc.send_signal(signal.SIGHUP)
        hard_failures = 0
        for _ in range(40):
            for attempt in range(4):
                try:
                    status, d = _get(port, "/healthz", timeout=5)
                    assert status == 200 and d["ok"]
                    break
                except OSError:
                    if attempt == 3:
                        hard_failures += 1
            time.sleep(0.05)
        assert hard_failures == 0
        _wait_log(log, "SIGHUP: config reloaded, rolling 2 workers "
                       "(zero-downtime, staggered")
        retired = r"\[master\] worker (\d+) retired \(zero-downtime"
        text = _wait_for(
            lambda: (lambda t: t if before <= _pids(t, retired) else None)(
                _read(log)), "both old workers to retire", 60, log)
        assert len(_pids(text, serving) - before) == 2
        assert not any(_alive(p) for p in before)  # reaped, not lingering
        status, d = _get(port, "/healthz")
        assert status == 200 and d["ok"]
    finally:
        _stop(proc)
    assert proc.returncode == 0


def _alive(pid) -> bool:
    try:
        os.kill(int(pid), 0)
        return True
    except ProcessLookupError:
        return False


def test_reap_stuck_kills_stale_heartbeat(monkeypatch, tmp_path):
    killed = []
    monkeypatch.setattr(m.os, "kill",
                        lambda pid, sig: killed.append((pid, sig)))
    monkeypatch.setattr(m, "_hb_path",
                        lambda pid: str(tmp_path / f"hb_{pid}"))
    mm = m.Master.__new__(m.Master)
    mm.cfg = type("C", (), {"worker_timeout_s": 10})()
    now = time.time()
    mm.workers = {111: now - 300.0, 222: now - 300.0, 333: now - 3.0}
    for pid, age in ((111, 60.0), (222, 1.0)):
        p = tmp_path / f"hb_{pid}"
        p.write_text("x")
        os.utime(p, (now - age, now - age))
    mm._reap_stuck()
    assert killed == [(111, m.signal.SIGKILL)]
    killed.clear()
    mm.cfg = type("C", (), {"worker_timeout_s": 0})()
    mm._reap_stuck()
    assert killed == []


def test_config_warns_on_malformed_env(monkeypatch, capsys):
    monkeypatch.setenv("MAX_UPLOAD_BYTES", "100M")
    cfg_mod.reset_config()
    try:
        c = cfg_mod.get_config()
        assert c.max_upload_bytes == 50 * 1024 * 1024  # default kept
        assert "MAX_UPLOAD_BYTES" in capsys.readouterr().err
    finally:
        monkeypatch.delenv("MAX_UPLOAD_BYTES")
        cfg_mod.reset_config()


def test_worker_without_cuda_stops_the_master(tmp_path):
    """No ``--device cpu`` on a host without CUDA: the worker exits with
    Gunicorn's boot-error code and the master shuts down with it, instead
    of respawning it forever or serving on the CPU."""
    proc, port, log = _spawn(tmp_path, device=None)
    try:
        assert proc.wait(timeout=60) == m.WORKER_BOOT_ERROR
    finally:
        _stop(proc)
    text = _read(log)
    assert "failed to boot: CUDA is not available" in text
    assert "failed to boot; shutting down" in text
    assert text.count("spawned worker") == 1


# ---------------------------------------------------------------------------
# warm-up
# ---------------------------------------------------------------------------

@pytest.fixture
def warm_calls(monkeypatch):
    calls = []
    monkeypatch.setenv("AVD_WARMUP", "1")
    monkeypatch.delenv("AVD_BACKEND", raising=False)
    monkeypatch.delenv("AVD_BATCH_WINDOW_MS", raising=False)
    monkeypatch.delenv("AVD_DETECTOR", raising=False)
    monkeypatch.setattr(vf, "warm_device",
                        lambda device: calls.append(("warm", device)))
    monkeypatch.setattr(vf, "run_prep_windows", lambda a, b, device: (
        calls.append(("stack", a.shape, b.shape, device))
        or torch.zeros(a.shape[0], 3 * (a.shape[1] - 1))))
    monkeypatch.setattr(scoring, "detector_timeline", lambda f, device: (
        calls.append(("detector", f.shape, device))))
    cfg_mod.reset_config()
    yield calls
    cfg_mod.reset_config()


def test_warmup_runs_the_window_buckets(warm_calls, capsys):
    cpu = torch.device("cpu")
    m._warmup(cpu)
    assert warm_calls == [("warm", cpu)]
    assert "warmup complete" in capsys.readouterr().out


def test_warmup_covers_the_stacked_windows(warm_calls, monkeypatch):
    monkeypatch.setenv("AVD_BATCH_WINDOW_MS", "100")
    cfg_mod.reset_config()
    cpu = torch.device("cpu")
    m._warmup(cpu)
    n = vf._DEFAULT_CHUNK + 1
    assert warm_calls == [("warm", cpu)] + [
        ("stack", (k, n, 320, 320), (k, n, 32, 32), cpu)
        for k in batching._BUCKETS]


def test_warmup_covers_detector(warm_calls, monkeypatch):
    monkeypatch.setenv("AVD_DETECTOR", "1")
    cpu = torch.device("cpu")
    m._warmup(cpu)
    assert warm_calls == [("warm", cpu), ("detector", (1, 64, 64, 3), cpu)]


def test_warmup_scores_one_temporal_window(monkeypatch, capsys):
    """A temporal worker's warm-up scores one whole window: the one shape
    every later scoring call has (the tail padded to the window)."""
    monkeypatch.setenv("AVD_WARMUP", "1")
    monkeypatch.setenv("AVD_DETECTOR", "1")
    monkeypatch.setenv("AVD_DETECTOR_ARCH", "temporal")
    for name in ("AVD_BACKEND", "AVD_BATCH_WINDOW_MS", "AVD_DETECTOR_PRESET",
                 "AVD_DETECTOR_CKPT", "AVD_TEMPORAL_WINDOW",
                 "AVD_DETECTOR_QUANT", "AVD_ATTN_FUSED"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(vf, "warm_device", lambda device: None)
    cfg_mod.reset_config()
    scoring._bundle.cache_clear()
    cpu = torch.device("cpu")
    cfg, params, probs, source = scoring._bundle(cpu)
    seen = []

    def spy(frames, *n_valid):
        seen.append((tuple(frames.shape), n_valid))
        return probs(frames, *n_valid)

    spy.clip_window = probs.clip_window
    monkeypatch.setattr(scoring, "_bundle",
                        lambda device=None: (cfg, params, spy, source))
    try:
        m._warmup(cpu)
    finally:
        cfg_mod.reset_config()
        scoring._bundle_on.cache_clear()
    assert "warmup complete" in capsys.readouterr().out
    assert seen == [((32, 64, 64, 3), (1,))]


def test_warmup_skips_detector_when_disabled(warm_calls):
    m._warmup(torch.device("cpu"))
    assert [c[0] for c in warm_calls] == ["warm"]


def test_warmup_never_kills_a_worker(warm_calls, monkeypatch, capsys):
    def boom(device):
        raise RuntimeError("no kernels")
    monkeypatch.setattr(vf, "warm_device", boom)
    m._warmup(torch.device("cpu"))
    assert "warmup skipped: RuntimeError('no kernels')" in \
        capsys.readouterr().out


def test_warmup_stacked_windows_run_for_real(monkeypatch):
    """The ladder's zero windows through the real ``run_prep_windows`` at
    a small chunk: every m returns its [m, 3·(n−1)] zeros' features."""
    monkeypatch.setattr(vf, "_DEFAULT_CHUNK", 2)
    seen = []
    real = vf.run_prep_windows
    monkeypatch.setattr(vf, "run_prep_windows", lambda a, b, device: (
        lambda out: seen.append(out) or out)(real(a, b, device)))
    monkeypatch.setattr(vf, "warm_device", lambda device: None)
    monkeypatch.setenv("AVD_BATCH_WINDOW_MS", "100")
    monkeypatch.delenv("AVD_BACKEND", raising=False)
    monkeypatch.delenv("AVD_DETECTOR", raising=False)
    cfg_mod.reset_config()
    try:
        m._warmup(torch.device("cpu"))
    finally:
        cfg_mod.reset_config()
    assert [tuple(o.shape) for o in seen] == \
        [(k, 6) for k in batching._BUCKETS]
    assert all(np.isfinite(o.numpy()).all() for o in seen)


def test_requests_are_read_from_the_posted_files(tmp_path, monkeypatch):
    """A worker's recycle and ready requests are files named for its pid
    in the master's dir (the signal only wakes the master): a recycle
    request spawns a replacement, its ready post retires the old
    worker, and each file is consumed once."""
    killed = []
    monkeypatch.setattr(m.os, "kill",
                        lambda pid, sig: killed.append((pid, sig)))
    mm = m.Master.__new__(m.Master)
    mm.hb_dir = str(tmp_path)
    mm.workers = {111: time.time()}
    mm.retire_for, mm.retiring, mm.scale_down, mm.roll_queue = {}, set(), \
        set(), []
    mm.spawn = lambda: mm.workers.setdefault(222, time.time()) and 222
    (tmp_path / "avd_recycle_111").write_text("")
    (tmp_path / "avd_hb_111").write_text("beat")
    mm._read_posts()
    assert mm.retire_for == {222: 111} and mm.retiring == {111}
    assert sorted(os.listdir(tmp_path)) == ["avd_hb_111"]
    (tmp_path / "avd_ready_222").write_text("")
    mm._read_posts()
    assert killed == [(111, m.signal.SIGTERM)] and mm.retire_for == {}
    mm._read_posts()  # consumed: nothing happens twice
    assert killed == [(111, m.signal.SIGTERM)]
