"""One served worker over several devices: a rank group behind one HTTP
worker.

``avd_tpu``'s worker is a single controller over every chip: it shards the
detector over a (data, model) mesh and the batch path's pair features
over a time mesh (``avd_tpu/models/scoring.py:211-243``,
``avd_tpu/ops/video_features.py:697-719``).  The port's programs for the
same work (``scoring.sharded_probs``, ``video_features.cp_pairs``) are
SPMD: every rank makes the same call.  This module is the port's side of
"one process owns every device": a group led by the process that serves
HTTP.

* **Leader** (rank 0): the worker the master knows.  It binds the port,
  runs the handler threads, the window batcher and the streaming path on
  its own device, and enters the group's calls through its dispatch point
  (``Leader.__call__``, installed as ``distributed.run_on_group``'s).
* **Followers** (ranks 1…N-1): ``python -m avd_tpu_torch.serve.group``,
  started by the leader with fork+exec (``subprocess``; never a fork of a
  process that holds CUDA), or by ``torchrun`` beside ``serve.app``.  They
  bind nothing: they wait for a call, run it on their share, and wait for
  the next.

The calls (``_calls``) are exactly what ``avd_tpu`` shards in a served
worker: ``scoring.score_resized`` (per-frame families; the resized uint8
frames go out, each rank flips and scales them itself, bit for bit as one
device would), ``video_features.cp_pairs`` (the host-prep planes go out),
and ``scoring.warm``.  Everything else stays on the leader: the streaming
video path, the temporal family, int8, exported programs.

Transports.  The compute group is the world: NCCL on cards, gloo on the
CPU or when named (several ranks sharing a card).  Its collectives, and
those of its meshes' sub-groups (``mesh.make_mesh``), time out after the
worker's hang timer, ``config.worker_timeout_s`` (``GUNICORN_TIMEOUT``,
default 180 s; 0: no bound).  Beside it, two gloo groups over the host
carry the dispatch (``collectives.broadcast_*``):

* the *bell*: the call's header (its name, the arrays' shapes and dtypes),
  which a follower waits for between calls.  A gloo group's timeout is
  each process's own: a follower's bell waits a year, so an idle follower
  never times out (the leader's exit closes the bell's connections and
  its broadcast raises), while the leader's has the collective timeout,
  so a follower that stopped taking calls fails the next one;
* the *host* group: the payload (one broadcast an array) and the closing
  exchange, in which every rank reports whether its call raised and its
  kernel launch and collective counters (``/metrics``'s ``group``).  It has
  the collective timeout.

A lock on the leader serializes the calls, so every rank issues the
group's collectives in the same order while handler threads run
concurrently; the answer returns once every rank has closed the call.

Faults.  A call that raises on any rank, a transport error, a follower
that exits (the leader's watch thread polls them) and a hung rank (a
collective that outlives the timeout raises on gloo; on NCCL torch's
watchdog ends the process) all fail the group: the request that hit it
gets the analyzer's ``detector_error`` or ``video_error``, and
``on_fail`` (the worker's) stops serving, so the worker exits with
``GROUP_FAILED`` and the master respawns a new group.  A follower started
by the leader dies with it (``PR_SET_PDEATHSIG``, and its broadcast
raising when the bell closes).

Warm-up: every rank builds the bundle (its shards) and runs each call once
(``Leader.warm``) before the leader reports ready.  A group that cannot
form or warm (a follower that exits or hangs, a rendezvous error, a rank
out of memory) raises from ``start``; the worker exits with
``GROUP_FAILED`` then too, and the master respawns it.  Only ``plan``'s
refusals cannot change on a respawn.
"""

from __future__ import annotations

import argparse
import ctypes
import datetime
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.parallel import collectives
from avd_tpu_torch.parallel import distributed

GROUP_FAILED = 4      # a worker whose group failed: the master respawns it
_BELL_TIMEOUT = datetime.timedelta(days=365)
_BOOT_TIMEOUT_S = 600.0  # followers' start: interpreter, torch, kernels

_ACTIVE: Optional["Leader"] = None


def timeout_s() -> float:
    """The group's collective timeout, s: the worker's hang timer
    (``config.worker_timeout_s``), or the bell's year when that is 0."""
    from avd_tpu_torch.config import get_config
    return float(get_config().worker_timeout_s) or \
        _BELL_TIMEOUT.total_seconds()


def active() -> Optional["Leader"]:
    """The leader of this process's served group, or None."""
    return _ACTIVE


def _name(fn: Callable) -> str:
    return f"{fn.__module__}.{fn.__qualname__}"


def _calls() -> Dict[str, Callable]:
    """The calls a served group runs, by name."""
    from avd_tpu_torch.models import scoring
    from avd_tpu_torch.ops import video_features
    return {_name(f): f for f in (scoring.warm, scoring.score_resized,
                                  video_features.cp_pairs)}


def _counters() -> dict:
    """This rank's kernel launches and collective calls since it started."""
    from avd_tpu_torch.ops.kernels import (attention, blur_solve, flow_iter,
                                           warp)
    launches = {"warp_bilinear": warp.LAUNCHES,
                "box_blur_solve": blur_solve.LAUNCHES,
                "solve_iteration": flow_iter.LAUNCHES,
                "mha": attention.LAUNCHES}
    return {"launches": launches, "collectives": collectives.counts()}


class GroupFailed(RuntimeError):
    """The served group failed; the worker stops serving."""


def plan(device: str, size: int = 0, backend: Optional[str] = None):
    """(ranks, backend) of a worker's group; 0 ranks is no group.

    ``size`` 0 spans every visible card (``avd_tpu``'s worker sees every
    chip); one card, or the CPU, is no group: today's single-device path.
    A size given is a group of that many ranks, one included (NCCL's path
    on one card).  The backend defaults to NCCL on CUDA and gloo on the
    CPU; more NCCL ranks than cards is refused (NCCL takes one rank a
    card; gloo shares cards, its collectives staged through the host)."""
    dev = device_mod.resolve(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if size < 0:
        raise ValueError(f"group size {size} < 0")
    if size == 0:
        size = cards if cards > 1 else 0
    if size == 0:
        return 0, None
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unsupported backend {backend!r}")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("an NCCL group needs --device cuda")
    if backend == "nccl" and size > cards:
        raise ValueError(
            f"{size} NCCL ranks on {cards} visible card(s): NCCL takes one "
            "rank a card; pass --dist-backend gloo to share cards, or a "
            "smaller --group-size")
    return size, backend


def _host_groups(leader: bool):
    """(bell, host) gloo groups over every rank (made on every rank in the
    same order, after the world group); a follower's bell waits a year."""
    timeout = datetime.timedelta(seconds=timeout_s())
    bell = dist.new_group(backend="gloo",
                          timeout=timeout if leader else _BELL_TIMEOUT)
    host = dist.new_group(backend="gloo", timeout=timeout)
    distributed._SERVED = True
    return bell, host


def _load_kernels(dev: torch.device) -> None:
    """Build or load every kernel before the first call, so no call waits
    on nvcc (builds share a file lock across processes)."""
    if dev.type == "cuda":
        from avd_tpu_torch.ops.kernels import _build
        for name in _build.SOURCES:
            _build.load(name)


class Leader:
    """Rank 0 of a served group: its dispatch point and its state."""

    def __init__(self, size: int, backend: str, bell, host,
                 procs: Sequence[subprocess.Popen] = (),
                 workdir: Optional[str] = None):
        self.size, self.backend = size, backend
        self.device = distributed.rank_device()
        self.procs = list(procs)
        self.workdir = workdir
        self.timeout_s = timeout_s()
        self.on_fail: Optional[Callable[[], None]] = None
        self.failed: Optional[str] = None
        self.calls: Dict[str, dict] = {}
        self.ranks: List[dict] = []   # every rank's counters, last call
        self._bell, self._host = bell, host
        self._lock = threading.Lock()
        self._fail_lock = threading.Lock()
        self._stopped = threading.Event()
        threading.Thread(target=self._watch, daemon=True,
                         name="avd-group-watch").start()

    @property
    def pids(self) -> List[int]:
        return [os.getpid()] + [p.pid for p in self.procs]

    def __call__(self, fn: Callable, arrays: Sequence[np.ndarray], device):
        name = _name(fn)
        if name not in _calls():
            raise ValueError(f"{name} is not a call of the served group")
        arrays = [np.ascontiguousarray(a) for a in arrays]
        with self._lock:
            if self.failed:
                raise GroupFailed(self.failed)
            t0 = time.perf_counter()
            err = None
            try:
                collectives.broadcast_object(
                    ("call", name, [(a.shape, a.dtype.str) for a in arrays]),
                    self._bell)
                for a in arrays:
                    collectives.broadcast_host(torch.from_numpy(a),
                                               self._host)
                try:
                    out = fn(*arrays, device=device)
                except Exception as e:  # closed below, then re-raised
                    out, err = None, e
                closed = collectives.all_gather_object(
                    (err is None, _counters()), self._host)
            except Exception as e:
                self._fail(f"{name}: {e!r}")
                raise GroupFailed(f"{name}: {e!r}") from e
            self.ranks = [c for _, c in closed]
            bad = [r for r, (ok, _) in enumerate(closed) if not ok]
            if bad:
                self._fail(f"{name} raised on rank(s) {bad}")
                if err is not None:
                    raise err
                raise GroupFailed(f"{name} raised on rank(s) {bad}")
            ms = (time.perf_counter() - t0) * 1e3
            st = self.calls.setdefault(name.rsplit(".", 1)[1],
                                       {"n": 0, "ms": 0.0, "last_ms": 0.0})
            st["n"] += 1
            st["ms"] += ms
            st["last_ms"] = ms
            return out

    def warm(self) -> None:
        """Run each call this worker can make once on every rank: the
        bundle's build (its shards) and a slab's scoring with the detector
        on, the context-parallel pairs where the batch path can take them
        (host prep, the gate off)."""
        from avd_tpu_torch import config as config_mod
        from avd_tpu_torch.models import scoring
        from avd_tpu_torch.ops import video_features as vf
        if scoring.enabled() and scoring.sharded():
            self(scoring.warm, [], self.device)
        cfg = config_mod.get_config()
        if distributed.cp_enabled() and cfg.prep_mode == "host" \
                and not cfg.change_gate:
            n = 2 * self.size
            self(vf.cp_pairs, [
                np.zeros((n, vf._FLOW_SIZE, vf._FLOW_SIZE), np.uint8),
                np.zeros((n, vf._HASH_SIZE, vf._HASH_SIZE), np.uint8)],
                self.device)

    def stats(self) -> dict:
        """The group's state for ``/metrics``."""
        return {"size": self.size, "backend": self.backend,
                "device": str(self.device), "pids": self.pids,
                "timeout_s": self.timeout_s, "failed": self.failed,
                "calls": {k: dict(v) for k, v in list(self.calls.items())},
                "ranks": list(self.ranks)}

    def _fail(self, reason: str) -> None:
        with self._fail_lock:
            if self.failed or self._stopped.is_set():
                return
            self.failed = reason
        print(f"[worker {os.getpid()}] rank group failed: {reason}",
              flush=True)
        if self.on_fail is not None:
            self.on_fail()

    def _watch(self) -> None:
        """Fail the group when a follower exits, between calls too (a hung
        one is the collectives' timeout's)."""
        while not self._stopped.wait(0.25):
            if self.failed:
                return
            for rank, p in enumerate(self.procs, 1):
                if p.poll() is not None:
                    self._fail(f"follower rank {rank} (pid {p.pid}) exited "
                               f"{p.returncode}")

    def stop(self) -> None:
        """Leave the group: the followers are told to exit (a failed
        group's are killed), and waited for."""
        global _ACTIVE
        self._stopped.set()
        if not self.failed:
            try:
                with self._lock:
                    collectives.broadcast_object(("stop",), self._bell)
            except Exception as e:
                print(f"[worker {os.getpid()}] group stop: {e!r}",
                      flush=True)
        for p in self.procs:
            if self.failed and p.poll() is None:
                p.kill()  # it may wait in a collective that never ends
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=30)
        if not self.failed:
            distributed.shutdown()
        else:  # a broken group's collectives may hang: drop it unjoined
            distributed._SERVED, distributed._DISPATCH = False, None
        from avd_tpu_torch.models import scoring
        scoring._bundle.cache_clear()
        if self.workdir:
            shutil.rmtree(self.workdir, ignore_errors=True)
        _ACTIVE = None


def _install(leader: Leader) -> Leader:
    global _ACTIVE
    distributed._DISPATCH = leader
    _ACTIVE = leader
    return leader


def start(device: str = "cuda", size: int = 0,
          backend: Optional[str] = None) -> Optional[Leader]:
    """Make this process the leader of a served group of ``size`` ranks
    (``plan``), its followers started here; warm; None for no group.
    Raises when the group cannot form or warm."""
    size, backend = plan(device, size, backend)
    if size == 0:
        return None
    dev_type = device_mod.resolve(device).type
    work = tempfile.mkdtemp(prefix="avd_group_")
    init = f"file://{work}/store"
    procs: List[subprocess.Popen] = []
    leader = None
    try:
        # the followers import this package as the leader did
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        path = os.pathsep.join(p for p in (root, os.getenv("PYTHONPATH"))
                               if p)
        for rank in range(1, size):
            env = dict(os.environ, LOCAL_RANK=str(rank), PYTHONPATH=path)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "avd_tpu_torch.serve.group",
                 "--rank", str(rank), "--world", str(size),
                 "--init", init, "--device", dev_type,
                 "--backend", backend, "--leader", str(os.getpid()),
                 "--ready", os.path.join(work, f"ready_{rank}")],
                env=env))
        print(f"[worker {os.getpid()}] starting followers "
              f"{[p.pid for p in procs]}", flush=True)
        os.environ["LOCAL_RANK"] = "0"
        _load_kernels(device_mod.resolve(dev_type))
        _wait_ready(procs, work)
        distributed.initialize(dev_type, backend, init_method=init,
                               world_size=size, rank=0,
                               timeout_s=timeout_s())
        bell, host = _host_groups(leader=True)
        leader = _install(Leader(size, backend, bell, host, procs, work))
        print(f"[worker {os.getpid()}] rank group of {size} over "
              f"{backend} on {dev_type}: followers "
              f"{[p.pid for p in procs]}", flush=True)
        leader.warm()
        return leader
    except BaseException:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
        if leader is not None:
            leader._stopped.set()
        distributed.shutdown()
        shutil.rmtree(work, ignore_errors=True)
        raise


def _wait_ready(procs, work: str) -> None:
    """Wait until every follower has started (its kernels loaded), so the
    rendezvous itself stays inside the collective timeout."""
    deadline = time.monotonic() + _BOOT_TIMEOUT_S
    for rank, p in enumerate(procs, 1):
        path = os.path.join(work, f"ready_{rank}")
        while not os.path.exists(path):
            if p.poll() is not None:
                raise RuntimeError(f"follower rank {rank} exited "
                                   f"{p.returncode} before joining")
            if time.monotonic() > deadline:
                raise RuntimeError(f"follower rank {rank} not started after "
                                   f"{_BOOT_TIMEOUT_S:.0f} s")
            time.sleep(0.05)


def join(device: str = "cuda",
         backend: Optional[str] = None) -> Optional[Leader]:
    """Join the group ``torchrun`` started (``RANK``, ``WORLD_SIZE``,
    ``env://``): rank 0 returns its warmed ``Leader``; any other rank
    follows until the leader stops or fails, then returns None."""
    dev_type = device_mod.resolve(device).type
    if backend == "nccl" or (backend is None and dev_type == "cuda"):
        plan(device, int(os.getenv("WORLD_SIZE", "1")), backend)
    distributed.initialize(dev_type, backend, timeout_s=timeout_s())
    _load_kernels(distributed.rank_device())
    bell, host = _host_groups(leader=distributed.rank() == 0)
    if distributed.rank() != 0:
        code = follow(distributed.rank_device(), bell, host)
        if code:
            raise SystemExit(code)
        distributed.shutdown()
        return None
    leader = _install(Leader(distributed.world_size(),
                             dist.get_backend(), bell, host))
    leader.warm()
    return leader


def follow(device: torch.device, bell, host) -> int:
    """A follower's loop: each call the leader sends, run on this rank's
    share; 0 when told to stop, 1 after a call that raised here."""
    calls = _calls()
    while True:
        head = collectives.broadcast_object(None, bell)
        if head[0] == "stop":
            return 0
        _, name, specs = head
        arrays = [np.empty(shape, np.dtype(dtype)) for shape, dtype in specs]
        for a in arrays:
            collectives.broadcast_host(torch.from_numpy(a), host)
        ok = True
        try:
            calls[name](*arrays, device=device)
        except Exception:
            traceback.print_exc()
            ok = False
        collectives.all_gather_object((ok, _counters()), host)
        if not ok:
            return 1


def _die_with_parent(leader_pid: int) -> None:
    """SIGKILL this process when the leader exits (Linux), and exit now
    if it already has."""
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    except (OSError, AttributeError):
        pass
    if os.getppid() != leader_pid:
        raise SystemExit(GROUP_FAILED)


def main(argv=None) -> int:
    """A follower started by ``start``."""
    ap = argparse.ArgumentParser(
        description="a follower rank of a served worker's group")
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], required=True)
    ap.add_argument("--backend", choices=["nccl", "gloo"], required=True)
    ap.add_argument("--leader", type=int, required=True)
    ap.add_argument("--ready", required=True)
    args = ap.parse_args(argv)
    _die_with_parent(args.leader)
    # the master's controls are process-group wide: only the leader acts
    for sig in (signal.SIGHUP, signal.SIGTTIN, signal.SIGTTOU,
                signal.SIGINT):
        signal.signal(sig, signal.SIG_IGN)
    dev = device_mod.resolve(args.device)
    if dev.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(args.rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    _load_kernels(dev)
    open(args.ready, "w").close()
    distributed.initialize(args.device, args.backend, init_method=args.init,
                           world_size=args.world, rank=args.rank,
                           timeout_s=timeout_s())
    bell, host = _host_groups(leader=False)
    try:
        code = follow(distributed.rank_device(), bell, host)
    except Exception as e:  # the leader is gone: its connections closed
        print(f"[follower {os.getpid()} rank {args.rank}] leaving the "
              f"group: {e!r}", flush=True)
        return GROUP_FAILED
    if code == 0:
        distributed.shutdown()
    return code


if __name__ == "__main__":
    sys.exit(main())
