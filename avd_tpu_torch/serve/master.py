"""Pre-fork worker master — the reference's Gunicorn role (gunicorn_conf.py).

Port of ``avd_tpu/serve/master.py``.

Reproduced semantics:
* ``WEB_CONCURRENCY`` workers × ``GUNICORN_THREADS`` threads
  (gunicorn_conf.py:4-5; our worker is a threading server, so threads are a
  connection-concurrency cap);
* worker recycling after ``GUNICORN_MAX_REQUESTS ± jitter`` requests
  (gunicorn_conf.py:13-14) — guards against leaks on long-lived processes;
* graceful shutdown window ``GUNICORN_GRACEFUL_TIMEOUT`` then SIGKILL;
* dead workers are respawned (Gunicorn master behavior);
* access/error logs to stdout (gunicorn_conf.py:16-17);
* Gunicorn's runtime signal surface: ``SIGTTIN``/``SIGTTOU`` scale the
  worker pool up/down one at a time (never below one; the retiring
  worker drains while its siblings keep the SO_REUSEPORT accept group),
  and ``SIGHUP`` reloads config and rolls every worker through the
  zero-downtime recycle below — each replacement binds + warms before
  its predecessor drains, so a HUP never gaps the service.

Improvement over Gunicorn's recycle: ZERO-DOWNTIME recycling.  Gunicorn
retires a worker at its request budget and only then boots the
replacement — with one worker (the reference's default) the service is
down for the whole replacement boot, which here includes the device
warm-up (the kernels' load, the CUDA context, every window bucket once).
Instead a
worker reaching its budget keeps serving and asks the master for a
replacement; the master boots the replacement, and only when it reports
ready (after bind + warmup) does the old worker get SIGTERM and drain.
Each request is a file named for the worker in the master's private dir
(``_post``), with a realtime signal (SIGRTMIN+1, SIGRTMIN+2) to wake the
master: the file, not the signal's sender pid, names the worker, since a
signal sent from a handler thread can carry that thread's id as its
sender pid (some sandboxed kernels do so, and ``avd_tpu``'s si_pid
handshake then never recycles).

Workers share the listening port via SO_REUSEPORT — the kernel load
balances accepts, no fd passing needed.  Each worker holds its own CUDA
context on the card; the kernels' libraries, built once under the
checkout's ``build/`` (one nvcc per source, under a file lock), make
respawned workers start hot.

CUDA and fork: a child forked after its parent initialized CUDA cannot use
it, and a parent that ran torch's intra-op thread pool can hang its
children.  So the master process imports neither ``torch`` nor the
application: each worker imports them after the fork
(``tests/test_torch_imports.py`` holds the master to it).  A worker that
cannot get its device (no CUDA without ``--device cpu``) exits with
Gunicorn's boot-error code, and the master then shuts down with it
instead of respawning.

A worker spans every visible card, as ``avd_tpu``'s worker sees every
chip: with more than one, it is the leader of a rank group
(``serve/group.py``) whose followers it starts itself, and it shards the
detector and the batch path's pair features over them.  One visible card
(``CUDA_VISIBLE_DEVICES`` naming one) is today's single-device path: no
group, no follower.  ``--group-size N`` asks for N ranks (1: a group of
one, NCCL's path on one card; on the CPU, gloo ranks), ``--dist-backend``
names the group's backend (default NCCL on cards, gloo on the CPU; more
NCCL ranks than cards is refused at boot).  Rank r of every worker binds
``cuda:r`` (gloo ranks share cards modulo their count).  Recycling,
``SIGHUP``, ``SIGTTIN``/``SIGTTOU`` and ``SIGTERM`` act on the leader and
so on its whole group: a replacement group boots and warms before the old
one drains, and followers die with their leader.  A group that fails
(a rank raised, exited or hung past the collective timeout), or that
cannot form or warm, makes its worker exit with ``group.GROUP_FAILED``,
and the master respawns it; only a group ``group.plan`` refuses is a
boot error.

Run: ``python -m avd_tpu_torch.serve.master [--device cuda|cpu]
[--group-size N] [--dist-backend nccl|gloo]``
"""

from __future__ import annotations

import os
import random
import signal
import sys
import threading
import time
from typing import Optional

from avd_tpu_torch.config import get_config

_SIG_RECYCLE = signal.SIGRTMIN + 1   # worker → master: budget reached
_SIG_READY = signal.SIGRTMIN + 2     # worker → master: bound + warm
WORKER_BOOT_ERROR = 3  # Gunicorn's code: a worker that can never boot


def _hb_path(pid: int) -> Optional[str]:
    """Heartbeat file for ``pid`` inside the master-owned PRIVATE dir
    (a 0700 mkdtemp created by the master, handed to workers via
    AVD_HB_DIR across fork).  The shared world-writable tempdir is off
    limits: on a multi-tenant host a predictable /tmp/avd_hb_<pid> could
    be pre-created or symlinked by another tenant, feeding the reaper a
    stale attacker-controlled mtime (perpetual kill/respawn of healthy
    workers) or making the worker truncate an arbitrary file.  Returns
    None when no master provided a dir (single-process serving — there
    is no reaper, so there is nothing to beat for)."""
    hb_dir = os.environ.get("AVD_HB_DIR")
    if not hb_dir:
        return None
    return os.path.join(hb_dir, f"avd_hb_{pid}")


def _post(kind: str, sig) -> bool:
    """Post ``kind`` ("recycle" or "ready") to the master: an empty file
    ``avd_<kind>_<pid>`` in its private dir, then ``sig`` to wake it.
    Returns False when there is no master to tell (orphaned)."""
    master = os.getppid()
    hb_dir = os.environ.get("AVD_HB_DIR")
    if master <= 1 or not hb_dir:
        return False
    open(os.path.join(hb_dir, f"avd_{kind}_{os.getpid()}"), "w").close()
    os.kill(master, sig)
    return True


def _start_heartbeat() -> None:
    """Worker-side heartbeat for the GUNICORN_TIMEOUT hang-kill timer
    (gunicorn_conf.py:9): a dedicated daemon thread touches this pid's
    heartbeat file every 2 s.  A handler thread blocked in a long device
    program keeps beating; only a wedged PROCESS stops — which is exactly
    what gunicorn's timer reaps."""
    path = _hb_path(os.getpid())
    if path is None:
        return
    warned = False

    def beat() -> None:
        nonlocal warned
        while True:
            try:
                with open(path, "w") as f:
                    f.write(str(time.time()))
            except OSError as e:
                # a worker that cannot beat will be reaped at the
                # timeout — say so ONCE instead of dying silently
                if not warned:
                    warned = True
                    print(f"[worker {os.getpid()}] WARNING: cannot write "
                          f"heartbeat {path}: {e!r} — the master will "
                          "SIGKILL this worker at GUNICORN_TIMEOUT",
                          flush=True)
            time.sleep(2.0)

    threading.Thread(target=beat, daemon=True, name="avd-heartbeat").start()


def _warmup(device) -> None:
    """Run the default device work once before accepting traffic.

    The first window on a fresh worker pays the kernels' load, the CUDA
    context and the libraries' start-up; warming at boot keeps the first
    request inside REQUEST_TIMEOUT_S and flips the warm flag so live
    requests keep the exact 180 s.  AVD_WARMUP=0 skips.  Never kills a
    worker: a failure prints ``warmup skipped`` and serving proceeds.
    """
    if os.getenv("AVD_WARMUP", "1") != "1":
        return
    if os.getenv("AVD_BACKEND", "jax") == "oracle":
        return  # host-only serving has nothing to warm
    try:
        import numpy as np
        import torch

        from avd_tpu_torch.ops import video_features as vf
        if get_config().prep_mode == "host":
            # every quarter-chunk window bucket (the kernels built first)
            vf.warm_device(device)
            if get_config().batch_window_ms > 0:
                # the stacked windows the batcher can form: the full
                # bucket length at every m of the ladder (tails dispatch
                # singly through the buckets warmed above)
                from avd_tpu_torch.serve import batching
                full = vf._DEFAULT_CHUNK + 1
                z320 = np.zeros((full, vf._FLOW_SIZE, vf._FLOW_SIZE),
                                np.uint8)
                z32 = np.zeros((full, vf._HASH_SIZE, vf._HASH_SIZE),
                               np.uint8)
                outs = [vf.run_prep_windows(
                    np.broadcast_to(z320, (m,) + z320.shape),
                    np.broadcast_to(z32, (m,) + z32.shape), device)
                    for m in batching._BUCKETS]
                torch.cat([o.reshape(-1) for o in outs]).cpu()
        from avd_tpu_torch.models import scoring
        if scoring.enabled():
            # load the weights and run the first scoring bucket so the
            # first detector-enabled request doesn't pay model load
            scoring.detector_timeline(np.zeros((1, 64, 64, 3), np.uint8),
                                      device=device)
        print(f"[worker {os.getpid()}] warmup complete", flush=True)
    except Exception as e:  # warmup must never kill a worker
        print(f"[worker {os.getpid()}] warmup skipped: {e!r}", flush=True)


def _worker_main(max_requests: int, device: str, group_size: int = 0,
                 backend: Optional[str] = None) -> None:
    """Child process: serve on ``device`` (over a rank group of
    ``group_size`` ranks, ``group.plan``); at the request budget, ask the
    master for a zero-downtime replacement and keep serving until told to
    retire."""
    # the master blocks its control signals; undo the inherited mask.
    # HUP/TTIN/TTOU are master-level controls: ignore them here so a
    # process-group-wide `kill -HUP` can't kill workers mid-request
    # (the master rolls us gracefully instead).
    for sig in (signal.SIGHUP, signal.SIGTTIN, signal.SIGTTOU):
        signal.signal(sig, signal.SIG_IGN)
    signal.pthread_sigmask(
        signal.SIG_UNBLOCK,
        {signal.SIGTERM, signal.SIGINT, signal.SIGCHLD,
         signal.SIGHUP, signal.SIGTTIN, signal.SIGTTOU,
         _SIG_RECYCLE, _SIG_READY})

    from avd_tpu_torch import device as device_mod
    from avd_tpu_torch.serve import app as app_mod
    from avd_tpu_torch.serve import group as group_mod
    from avd_tpu_torch.serve import http as http_mod

    cfg = get_config()
    _start_heartbeat()
    try:
        dev = device_mod.pinned(device)
        group_size, backend = group_mod.plan(device, group_size, backend)
    except (RuntimeError, ValueError) as e:
        # no device will appear on a respawn, no refused group become
        # possible: tell the master
        print(f"[worker {os.getpid()}] failed to boot: {e}", flush=True)
        sys.exit(WORKER_BOOT_ERROR)
    try:
        # a group boots and runs each of its calls once before serving
        leader = group_mod.start(device, group_size, backend)
    except Exception as e:
        # a follower that exited or hung, a rendezvous, a rank out of
        # memory: a respawned group may form
        print(f"[worker {os.getpid()}] rank group failed to form: {e!r}",
              flush=True)
        sys.exit(group_mod.GROUP_FAILED)
    if leader is not None:
        dev = leader.device
    _warmup(dev)
    host, _, port = cfg.bind.rpartition(":")
    application = app_mod.build_app(device=dev)
    server = http_mod.make_server(application, host or "0.0.0.0", int(port),
                                  reuse_port=True)
    server.drain_timeout = cfg.graceful_timeout_s
    served = 0
    recycle_asked = False
    count_lock = threading.Lock()
    orig_dispatch = application.dispatch

    def counting_dispatch(req):
        nonlocal served, recycle_asked
        # handler threads dispatch concurrently: unsynchronized += loses
        # increments (late recycle) and two threads could both pass the
        # recycle_asked check (double signal)
        with count_lock:
            served += 1
            ask = (max_requests and served >= max_requests
                   and not recycle_asked)
            if ask:
                recycle_asked = True
        resp = orig_dispatch(req)
        if ask:
            # keep serving; the master SIGTERMs us once the replacement
            # is bound and warm
            if not _post("recycle", _SIG_RECYCLE):
                # master gone (orphaned): old-style self-recycle
                import threading
                threading.Thread(target=server.shutdown,
                                 daemon=True).start()
        return resp

    application.dispatch = counting_dispatch

    def term(_sig, _frm):
        import threading

        def stop():
            # leave the SO_REUSEPORT accept group FIRST: closing the fd
            # makes the kernel stop hashing new SYNs here immediately, so
            # the reset window is only whatever was already sitting in
            # this socket's accept queue (~nothing).  serve_forever
            # tolerates the closed fd (accept -> OSError is swallowed by
            # socketserver's _handle_request_noblock) until shutdown()
            # stops the loop; server_close()'s second close is a no-op.
            try:
                server.socket.close()
            except OSError:
                pass
            server.shutdown()

        threading.Thread(target=stop, daemon=True).start()

    signal.signal(signal.SIGTERM, term)
    if leader is not None:
        def group_failed():
            # stop serving; a call stuck on a hung rank is not waited for
            term(None, None)
            timer = threading.Timer(cfg.graceful_timeout_s, os._exit,
                                    (group_mod.GROUP_FAILED,))
            timer.daemon = True
            timer.start()
        leader.on_fail = group_failed
        if leader.failed:  # failed before it could say so (the warm-up)
            group_failed()
    print(f"[worker {os.getpid()}] serving on {cfg.bind} "
          f"(max_requests={max_requests})", flush=True)
    _post("ready", _SIG_READY)
    # tight poll: between the shutdown request and the socket close, SYNs
    # the kernel hashed to THIS reuseport socket would be reset — keep
    # the blackhole window at most one poll
    server.serve_forever(poll_interval=0.02)
    server.server_close()  # joins in-flight handler threads (drain)
    code = 0
    if leader is not None:
        code = group_mod.GROUP_FAILED if leader.failed else 0
        leader.stop()
    print(f"[worker {os.getpid()}] exiting after {served} requests",
          flush=True)
    sys.exit(code)


class Master:
    def __init__(self, device: str = "cuda", group_size: int = 0,
                 backend: Optional[str] = None) -> None:
        self.cfg = get_config()
        self.device = device  # handed to every worker's build_app
        # each worker's rank group (serve/group.plan; 0: every visible card)
        self.group_size, self.backend = group_size, backend
        self.exit_code = 0
        # private heartbeat dir (0700, master-owned) — see _hb_path
        import tempfile
        self.hb_dir = tempfile.mkdtemp(prefix="avd_hb_")
        os.environ["AVD_HB_DIR"] = self.hb_dir
        self.workers: dict[int, float] = {}
        # zero-downtime recycling state: replacement pid → worker it will
        # retire once ready; workers awaiting retirement
        self.retire_for: dict[int, int] = {}
        self.retiring: set[int] = set()
        # workers being retired by SIGTTOU scale-down (reap: no respawn)
        self.scale_down: set[int] = set()
        # SIGHUP rolling-restart queue: workers awaiting their staggered
        # turn (one in flight at a time — see _rolling_restart)
        self.roll_queue: list[int] = []
        self.n_workers = max(1, self.cfg.workers)
        self.running = True

    def _budget(self) -> int:
        base = self.cfg.max_requests
        if base <= 0:
            return 0
        return base + random.randint(0, max(0, self.cfg.max_requests_jitter))

    def spawn(self) -> int:
        budget = self._budget()
        pid = os.fork()
        if pid == 0:
            # never swallow a worker crash: print it and exit nonzero so
            # the master can distinguish crash-respawn from retirement
            code = 0
            try:
                _worker_main(budget, self.device, self.group_size,
                             self.backend)
            except SystemExit as e:
                code = int(e.code or 0)
            except BaseException:
                import traceback
                traceback.print_exc()
                code = 1
            finally:
                os._exit(code)
        self.workers[pid] = time.time()
        print(f"[master] spawned worker {pid}", flush=True)
        return pid

    def _reap(self) -> None:
        while True:
            try:
                pid, _status = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                return
            if not pid:
                return
            hb = _hb_path(pid)
            if hb:
                try:
                    os.unlink(hb)
                except OSError:
                    pass
            born = self.workers.pop(pid, None)
            code = os.waitstatus_to_exitcode(_status)
            if code:
                print(f"[master] worker {pid} died (exit {code})",
                      flush=True)
            if code == WORKER_BOOT_ERROR and self.running:
                print(f"[master] worker {pid} failed to boot; shutting "
                      "down", flush=True)
                self.running = False
                self.exit_code = WORKER_BOOT_ERROR
            if born is not None and time.time() - born < 2.0 \
                    and pid not in self.retiring \
                    and pid not in self.scale_down \
                    and pid not in self.retire_for:
                # crash within 2 s of spawn: back off so a persistent
                # boot failure (e.g. squatted port) doesn't fork-storm
                time.sleep(0.5)
            if not self.running:
                continue
            if pid in self.scale_down:
                self.scale_down.discard(pid)
                print(f"[master] worker {pid} retired (scale-down)",
                      flush=True)
            elif pid in self.retire_for:
                # a replacement died before becoming ready: boot another
                # for the same still-serving worker
                old = self.retire_for.pop(pid)
                if old in self.workers:
                    self.retire_for[self.spawn()] = old
                else:
                    self.retiring.discard(old)
                    self.spawn()
            elif pid in self.retiring:
                # planned retirement — its replacement is already serving
                self.retiring.discard(pid)
                print(f"[master] worker {pid} retired (zero-downtime "
                      "recycle)", flush=True)
            else:
                self.spawn()  # crash → respawn (Gunicorn behavior)

    def _read_posts(self) -> None:
        """Act on the requests workers posted (``_post``), readiness
        first: a ready replacement retires its predecessor before a new
        recycle is weighed."""
        try:
            names = os.listdir(self.hb_dir)
        except OSError:
            return
        for kind, act in (("ready", self._on_ready),
                          ("recycle", self._on_recycle_request)):
            prefix = f"avd_{kind}_"
            for name in sorted(n for n in names if n.startswith(prefix)):
                try:
                    os.unlink(os.path.join(self.hb_dir, name))
                except OSError:
                    continue
                act(int(name[len(prefix):]))

    def _on_recycle_request(self, pid: int) -> None:
        # scale_down pids are already draining via SIGTERM — spawning a
        # replacement for one would undo the operator's SIGTTOU and leak
        # a retiring entry (the reap path for scale-down doesn't clean it)
        if (pid in self.workers and pid not in self.retiring
                and pid not in self.scale_down
                and pid not in self.retire_for.values()):
            self.retiring.add(pid)
            self.retire_for[self.spawn()] = pid

    def _on_ready(self, pid: int) -> None:
        old = self.retire_for.pop(pid, None)
        if old is not None and old in self.workers:
            try:
                os.kill(old, signal.SIGTERM)  # drain + exit
            except ProcessLookupError:
                pass
        if old is not None:
            self._advance_roll()

    def _advance_roll(self) -> None:
        """Recycle the next queued SIGHUP-roll worker (staggered roll:
        one replacement warms at a time — N simultaneous replacements
        would transiently double the pool and warm up concurrently on
        the one shared card, stretching every warmup)."""
        while self.roll_queue:
            pid = self.roll_queue.pop(0)
            if (pid in self.workers and pid not in self.retiring
                    and pid not in self.scale_down
                    and pid not in self.retire_for
                    and pid not in self.retire_for.values()):
                self._on_recycle_request(pid)
                return

    def _scale_up(self) -> None:
        """SIGTTIN (Gunicorn: increment worker count by one)."""
        self.n_workers += 1
        self.spawn()
        print(f"[master] scale-up to {self.n_workers} workers", flush=True)

    def _scale_down(self) -> None:
        """SIGTTOU (Gunicorn: decrement worker count, never below one).
        The oldest active worker drains and exits; its siblings keep the
        SO_REUSEPORT accept group, so no request is dropped."""
        if self.n_workers <= 1:
            print("[master] scale-down ignored (already at 1 worker)",
                  flush=True)
            return
        active = [p for p in self.workers
                  if p not in self.retiring and p not in self.scale_down
                  and p not in self.retire_for]
        if not active:
            # every worker is mid-recycle/roll — don't touch the pool
            # state, but tell the operator the signal was dropped
            print("[master] scale-down ignored (all workers mid-recycle; "
                  "re-send SIGTTOU once the roll settles)", flush=True)
            return
        victim = min(active, key=lambda p: self.workers[p])
        self.n_workers -= 1
        self.scale_down.add(victim)
        try:
            os.kill(victim, signal.SIGTERM)
        except ProcessLookupError:
            self.scale_down.discard(victim)
        print(f"[master] scale-down to {self.n_workers} workers "
              f"(retiring {victim})", flush=True)

    def _rolling_restart(self) -> None:
        """SIGHUP (Gunicorn: reload config + replace all workers).

        Config is re-read and every active worker goes through the
        zero-downtime recycle path — each replacement binds, warms, and
        reports ready before its predecessor is told to drain, so the
        service never gaps.  Workers import the application inside the
        child after fork (the master itself never imports it), so a HUP
        also picks up changed code and freshly trained detector
        checkpoints from disk.
        """
        from avd_tpu_torch import config as config_mod
        config_mod.reset_config()
        self.cfg = get_config()
        queued = 0
        for pid in list(self.workers):
            # skip workers already mid-transition: retiring olds, scale-down
            # victims, still-booting replacements (retire_for KEYS — rolling
            # one before it reports ready would orphan its roll-replacement
            # if it crashes during warmup), olds awaiting retirement
            # (retire_for values), and already-queued pids (double HUP)
            if (pid in self.retiring or pid in self.scale_down
                    or pid in self.retire_for
                    or pid in self.retire_for.values()
                    or pid in self.roll_queue):
                continue
            self.roll_queue.append(pid)
            queued += 1
        print(f"[master] SIGHUP: config reloaded, rolling {queued} "
              "workers (zero-downtime, staggered one at a time)",
              flush=True)
        # kick the roll only if no replacement is already warming —
        # otherwise its ready signal advances the queue
        if not self.retire_for:
            self._advance_roll()

    def _reap_stuck(self) -> None:
        """GUNICORN_TIMEOUT (gunicorn_conf.py:9): SIGKILL a worker whose
        heartbeat file hasn't been touched for worker_timeout_s — the
        wedged-process reaper gunicorn's timer provides.  The SIGCHLD →
        _reap path respawns it."""
        t = self.cfg.worker_timeout_s
        if t <= 0:
            return
        now = time.time()
        for pid, born in list(self.workers.items()):
            hb = _hb_path(pid)
            try:
                age = now - os.path.getmtime(hb) if hb else 0.0
            except OSError:
                age = now - born  # no beat ever written: age since spawn
            if age > t:
                print(f"[master] worker {pid} heartbeat stale "
                      f"{age:.0f}s > GUNICORN_TIMEOUT={t} — SIGKILL",
                      flush=True)
                try:
                    os.kill(pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass

    def run(self) -> int:
        cfg = self.cfg
        sigs = {signal.SIGTERM, signal.SIGINT, signal.SIGCHLD,
                signal.SIGHUP, signal.SIGTTIN, signal.SIGTTOU,
                _SIG_RECYCLE, _SIG_READY}
        # the control signals are only waited for, never handled
        signal.pthread_sigmask(signal.SIG_BLOCK, sigs)

        for _ in range(self.n_workers):
            self.spawn()

        last_hb_check = time.time()
        while self.running:
            info = signal.sigtimedwait(sigs, 0.5)
            if time.time() - last_hb_check >= 5.0:
                self._reap_stuck()
                last_hb_check = time.time()
            if info is None:
                self._reap()  # belt and braces
                self._read_posts()
                continue
            if info.si_signo in (signal.SIGTERM, signal.SIGINT):
                self.running = False
            elif info.si_signo == signal.SIGCHLD:
                self._reap()
            elif info.si_signo == signal.SIGHUP:
                self._rolling_restart()
            elif info.si_signo == signal.SIGTTIN:
                self._scale_up()
            elif info.si_signo == signal.SIGTTOU:
                self._scale_down()
            elif info.si_signo in (_SIG_RECYCLE, _SIG_READY):
                self._read_posts()

        # graceful drain (gunicorn_conf.py:10)
        deadline = time.time() + cfg.graceful_timeout_s
        for pid in list(self.workers):
            try:
                os.kill(pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
        while self.workers and time.time() < deadline:
            try:
                pid, _ = os.waitpid(-1, os.WNOHANG)
            except ChildProcessError:
                break
            if pid:
                self.workers.pop(pid, None)
            else:
                time.sleep(0.2)
        for pid in list(self.workers):
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        import shutil
        shutil.rmtree(self.hb_dir, ignore_errors=True)
        print("[master] shutdown complete", flush=True)
        return self.exit_code


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="pre-fork AI-video analysis service (Gunicorn's role)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where each worker analyzes (default cuda; a "
                         "worker without CUDA stops the master)")
    ap.add_argument("--group-size", type=int, default=0,
                    help="ranks of each worker's group (default 0: every "
                         "visible card, no group on one card or the CPU)")
    ap.add_argument("--dist-backend", choices=["nccl", "gloo"],
                    default=None,
                    help="the group's backend (default nccl on cuda, gloo "
                         "on the CPU; gloo shares cards)")
    args = ap.parse_args(argv)
    return Master(args.device, args.group_size, args.dist_backend).run()


if __name__ == "__main__":
    raise SystemExit(main())
