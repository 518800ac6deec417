"""Closed-loop clip traffic served by one worker that leads a rank group
of one process a card.

The clients, clips and checks of ``closed_loop_clips`` (its ``_Clip``,
``_failure`` and ``_compare``, by import), served the way a served worker
over several cards serves them (``serve/group.py``): the driver's process
is rank 0 and joins the group through ``serve.group.join`` (``torchrun``'s
variables, a ``tcp://localhost`` rendezvous); ranks 1 … N-1 are processes
it starts, each running ``benchmark.follower``, which opens a ``Busy``
session on its idle card and then follows the leader's calls.  The
program's own paths do the rest: the per-frame detector scores sharded
over the (data, model) mesh (``scoring.sharded_probs``) and each clip's
pairs go through the context-parallel video path (``cp_pairs``).

The card time (``card_busy_s``) is the four cards' busy seconds summed,
each from the window's opening to its drain (``group_busy_s``): the
leader's session marked as in ``closed_loop_clips``, and each follower's
cut to the same wall clock bounds (``follower.py``); none unless every
session is complete.  Of a collective each card counts the transfer: its
NCCL kernel's time on the rank that reached it last, as an NCCL kernel
on a rank that came first spins until the last one has launched
(``follower.CardBusy``).
The launch check counts, from the group's own counters (each rank's at
every call's close), 12 warps and 12 blur+solves a rank for every clip's
context-parallel call (``launch_deficit``).
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Dict, List, Optional

from . import closed_loop_clips as base
from .. import generate, media
from ..follower import CardBusy
from ..roofline import blur_solve as roof_blur
from ..roofline import warp as roof_warp
from ..run import Check, Run
from ..spec import PACKAGE, ROOT
from ..trace import _union

FOLLOWER_TIMEOUT_S = 120.0   # a follower's exit after the group stops
_FLOW = ("warp_bilinear", "box_blur_solve")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def flow_launches(ranks: List[Dict]) -> List[int]:
    """Each rank's warp and blur+solve launches in the group's counters."""
    return [sum(r["launches"][k] for k in _FLOW) for r in ranks]


def group_busy_s(busy: List[Optional[Dict]], log=None) -> Optional[float]:
    """The cards' busy seconds summed, or None unless every rank's session
    (``CardBusy.cut``) is there and complete and the ranks launched the
    same NCCL kernels.  The k-th NCCL kernel of every rank is one step of
    the same program; its shortest duration over the ranks, d_k, is its
    time on the rank that reached it last, and each rank counts the last
    d_k of its own kernel beside its own work."""
    if not busy or any(b is None or not b["complete"] for b in busy):
        return None
    seqs = [[k[2] for k in b["nccl"]] for b in busy]
    if any(q != seqs[0] for q in seqs):
        if log is not None:
            log(f"the ranks' NCCL kernels differ ({[len(q) for q in seqs]} "
                f"launched): no card time")
        return None
    d = [min(b["nccl"][k][1] - b["nccl"][k][0] for b in busy)
         for k in range(len(seqs[0]))]
    total = 0.0
    for b in busy:
        tails = [(max(s, e - dk), e) for (s, e, _), dk in zip(b["nccl"], d)]
        b["transfer_s"] = _union(tails) / 1e9
        total += _union([tuple(iv) for iv in b["device"]] + tails)
    return total / 1e9


def start_followers(world: int, work: str, device: str):
    """Ranks 1 … world-1, each ``python -m benchmark.follower``; sets this
    process's rank-0 variables."""
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world))
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"{PACKAGE}.follower", "--dir", work,
         "--device", device],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
        stdout=sys.stderr) for r in range(1, world)]
    os.environ.update({k: env[k] for k in ("MASTER_ADDR", "MASTER_PORT",
                                           "WORLD_SIZE")},
                      RANK="0", LOCAL_RANK="0")
    return procs


def run(ctx) -> Run:
    import torch
    from avd_tpu_torch.serve import group

    world = int(ctx.cell["chips"])
    work = tempfile.mkdtemp(prefix="bench_group_")
    procs = start_followers(world, work, ctx.device)
    leader = None
    try:
        leader = group.join(ctx.device)
        dev = leader.device
        ctx.log(f"rank group of {world} over {leader.backend}, followers "
                f"{[p.pid for p in procs]} "
                f"({time.perf_counter() - ctx.t0:.1f} s)")
        out = _serve(ctx, leader, dev, work)
    finally:
        if leader is not None:
            leader.stop()
        for p in procs:
            try:
                p.wait(timeout=FOLLOWER_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    run_, records, pool, wave, spf, sr, launches, expect = out
    busy = [run_.data.pop("leader_busy")]
    for r in range(1, world):
        path = os.path.join(work, f"busy_{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                busy.append(json.load(f))
        else:
            busy.append(None)
    run_.data["card_busy_s"] = group_busy_s(busy, ctx.log)
    for r, b in enumerate(busy):
        if b is not None:
            ctx.log(f"rank {r}: card busy {b['busy_s']:.4f} s in its own "
                    f"work, {b['nccl_s']:.4f} s in {len(b['nccl'])} NCCL "
                    f"kernels of which {b.get('transfer_s', 0.0):.4f} s "
                    f"transfer, {b['launches']} launches, "
                    f"{100 * b['lost_share']:.2f} % without their kernel, "
                    f"{b['counted']} flow kernels of {expect[r]} launched, "
                    f"longest pause {b['gap_s']:.3f} s")
    shutil.rmtree(work, ignore_errors=True)
    for p in procs:
        if p.returncode:
            run_.checks.append(Check("follower_exit", float(p.returncode),
                                     0.0))
    _check(ctx, run_, records, pool, wave, spf, sr, launches, world,
           torch.device(ctx.device if ctx.device == "cpu" else "cuda:0"))
    return run_


def _serve(ctx, leader, dev, work: str):
    """Set-up, the window and its drain; what ``run`` checks."""
    import torch
    from avd_tpu_torch import pipeline
    from avd_tpu_torch.ingest.video_reader import FrameBatch
    from avd_tpu_torch.oracle import video_ref
    tr, cfg = ctx.traffic, ctx.config
    h, w, fps = tr["height"], tr["width"], float(tr["fps"])
    sfps, sr = float(tr["sample_fps"]), int(tr["audio_sr"])
    spf = int(round(sr / sfps))
    pool_n = int(tr["pool_frames"])
    pool = media.make_frames(pool_n, h, w, ctx.seed)
    wave = media.speech_wave(pool_n / sfps, generate.rng(ctx.seed, 3)
                             .integers(1 << 62))
    caught = threading.local()
    summarize = video_ref.summarize

    def catch(feats, *a, **k):
        caught.feats = feats
        return summarize(feats, *a, **k)

    video_ref.summarize = catch

    def analyze(clip) -> None:
        s, n = clip.start, clip.n
        fb = FrameBatch(pool[s:s + n], n, fps, w, h, n / sfps)
        meta = media.probe_meta(n, h, w, fps, sfps)
        caught.feats = None
        clip.send = time.perf_counter()
        try:
            clip.env = pipeline.analyze_decoded(
                fb, wave[s * spf:(s + n) * spf], sr, meta, device=dev)
        except Exception as e:  # counted as a failed clip and reported
            clip.error = f"{type(e).__name__}: {e}"
        clip.done = time.perf_counter()
        clip.feats = caught.feats

    if ctx.trace:
        from ..trace import prime
        prime()
    clients = int(tr["clients"])
    barrier = threading.Barrier(clients + 1)
    window: Dict[str, float] = {"end": float("inf")}
    records: List[List] = [[] for _ in range(clients)]
    warm_errors: List[str] = []

    def client(k: int) -> None:
        for n in tr["warm_frames"]:
            c = base._Clip(k, 0, min(int(n), pool_n))
            analyze(c)
            if c.error:
                warm_errors.append(c.error)
        barrier.wait()
        stream = generate.clips(tr, ctx.seed, k)
        while time.perf_counter() < window["end"]:
            s, n = next(stream)
            c = base._Clip(k, s, n)
            records[k].append(c)
            analyze(c)

    threads = [threading.Thread(target=client, args=(k,), daemon=True,
                                name=f"bench-client-{k}")
               for k in range(clients)]
    for t in threads:
        t.start()
    sl = busy = leader_busy = None
    bounds = {}
    try:
        while barrier.n_waiting < clients and all(
                t.is_alive() for t in threads):
            time.sleep(0.01)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        from ..trace import Slicer
        if ctx.trace:
            sl = Slicer(0.0, float(cfg["trace"]["seconds"]), 0.0, ctx.log)
            sl.begin()
        elif dev.type == "cuda":
            busy = CardBusy(named=(roof_warp.KERNEL,) + roof_blur.KERNELS)
            busy.start()
        launches0 = flow_launches(leader.ranks)
        barrier.wait()
        if busy is not None:
            busy.open()
            bounds["lo_ns"] = time.time_ns()
        t_open = time.perf_counter()
        window["end"] = t_open + ctx.seconds
        setup_s = t_open - ctx.t0
        ctx.log(f"set-up {setup_s:.2f} s; window open")
        if sl is not None:
            sl.t_next = t_open + float(cfg["trace"]["at"]) * ctx.seconds
            sl.t_end = window["end"]
            while not sl.done:
                time.sleep(min(sl.poll(time.perf_counter()), 1.0))
        for t in threads:
            t.join(timeout=ctx.seconds + 240)
        stuck = [t.name for t in threads if t.is_alive()]
        if stuck:
            raise RuntimeError(f"clients still running: {stuck}")
        launches1 = flow_launches(leader.ranks)
        expect = [b - a for a, b in zip(launches0, launches1)]
        if busy is not None:
            torch.cuda.synchronize(dev)
            bounds["hi_ns"] = time.time_ns()
            busy.close()
            busy.stop()
            leader_busy = busy.cut(busy.lo_ns, busy.hi_ns, expect[0])
            # each follower cuts its session to these bounds
            with open(os.path.join(work, "window.json"), "w") as f:
                json.dump(dict(bounds, expect=expect), f)
    finally:
        video_ref.summarize = summarize
    t_close = window["end"]
    clips = [c for rec in records for c in rec]
    run = Run(setup_s=setup_s, window_s=ctx.seconds, attempted=len(clips))
    run.data = {"leader_busy": leader_busy, "warm_errors": warm_errors,
                "t_close": t_close}
    if sl is not None and sl.trace is not None:
        run.trace = sl.trace
        done = [c for c in clips if c.env is not None
                and sl.t0 <= c.done <= sl.t1]
        run.trace.work = {"frames": sum(c.n for c in done),
                          "clips": len(done), "model": cfg.get("detector")}
    if dev.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))
    return (run, clips, pool, wave, spf, sr,
            sum(expect), expect)


def _check(ctx, run: Run, clips, pool, wave, spf, sr, launches: int,
           world: int, dev) -> None:
    """``closed_loop_clips``' checks, the launches counted over the
    group."""
    import torch
    detector = ctx.config.get("detector") is not None
    warm_errors = run.data.pop("warm_errors")
    t_close = run.data.pop("t_close")
    why = {id(c): base._failure(c, detector) for c in clips}
    bad = [c for c in clips if why[id(c)]]
    run.failed = len(bad)
    for c in bad[:3]:
        ctx.log(f"failed clip {c.start}+{c.n}: {why[id(c)]}")
    good = [c for c in clips if not why[id(c)]]
    in_window = [c for c in good if c.done <= t_close]
    run.data.update({
        "frames_done": sum(c.n for c in in_window),
        "clips_done": len(in_window),
        "latencies": [c.done - c.send for c in in_window],
        "frames_sent": sum(c.n for c in clips)})
    ctx.log(f"{len(in_window)} clips ({run.data['frames_done']} frames) in "
            f"{ctx.seconds} s, {len(clips)} attempted, {run.failed} failed")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    run.checks.append(Check("failed_clips",
                            float(run.failed + len(warm_errors)), 0.0))
    if dev.type == "cuda":
        expected = 24 * world * len(clips)
        run.checks.append(Check("launch_deficit",
                                float(max(0, expected - launches)), 0.0))
    base._compare(ctx, run, good, pool, wave, spf, sr, dev, detector)
