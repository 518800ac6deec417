"""Time the port's dispatch stage against ``avd_tpu``'s design, several
windows enqueued at once (needs a CUDA card).

The port enqueues its host-prep windows on one ``avd-dispatch`` thread
(``video_features._dispatch_pool``); ``avd_tpu``'s pool has
``AVD_DISPATCH_WORKERS`` threads (default 4) that put windows at once.
On ``chip_smoke.py``'s 145 panning 1080p frames, in one process and in
turns (the order rotates each round): the warm ``analyze_batch``, then
the device pass with the host prep precomputed, with each window's
enqueue (host ms of ``run_prep_window`` on the thread that ran it) and
the pass's peak device memory, under the inline order (each window
enqueued on the calling thread), the shipped pool, and pools of 2 and 4
threads enqueueing at once.  Every order's features equal the inline
order's bit for bit.  Run from the root of the checkout:

    python tools/torch_dispatch_ab.py [--rounds 5] [--json OUT]

It prints the card's name and power limit and one line per order, and
writes the runs as JSON to ``OUT``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import os
import statistics
import sys
import time
from unittest import mock

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

ORDERS = ("inline", "pool", 2, 4)


@contextlib.contextmanager
def dispatch_order(order, pools):
    """``order``'s dispatch stage: the inline stand-in or the shipped pool
    (``chip_smoke.dispatch_order``), or a pool of ``order`` threads."""
    from avd_tpu_torch.ops import video_features
    if order in ("inline", "pool"):
        with smoke.dispatch_order(order):
            yield
        return
    with mock.patch.object(video_features, "_dispatch_pool",
                           lambda: pools[order]):
        yield


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch
    from avd_tpu_torch import device as device_mod
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.ingest import video_reader
    from avd_tpu_torch.ops import host_prep, video_features

    device_mod.resolve("cuda")
    card = smoke.phase_device()
    smoke.phase_build()
    n = smoke.FRAMES_MAIN
    frames = smoke.pan_frames(n, smoke.H_MAIN, smoke.W_MAIN)
    fps = 30.0
    fb = video_reader.FrameBatch(
        frames, n, fps, smoke.W_MAIN, smoke.H_MAIN,
        n * video_reader.sampling_step(fps) / fps)
    cuda = torch.device("cuda")
    chunk = video_features._DEFAULT_CHUNK
    prepped = [host_prep.host_prep(frames[i:i + chunk])
               for i in range(0, n, chunk)]
    video_an.analyze_batch(fb, device=cuda)  # warm

    pools = {o: concurrent.futures.ThreadPoolExecutor(o) for o in ORDERS
             if isinstance(o, int)}
    runs = {str(o): {"analyze_batch_s": [], "device_pass_s": [],
                     "enqueue_ms": [], "peak_mib": []} for o in ORDERS}
    feats = {}
    try:
        for r in range(args.rounds):
            k = r % len(ORDERS)
            for order in ORDERS[k:] + ORDERS[:k]:
                row = runs[str(order)]
                with dispatch_order(order, pools):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    video_an.analyze_batch(fb, device=cuda)
                    row["analyze_batch_s"].append(time.perf_counter() - t0)
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    enq: list = []
                    with smoke.timed_enqueues(enq):
                        t0 = time.perf_counter()
                        f, _ = smoke._device_pass(frames, prepped)
                        row["device_pass_s"].append(
                            time.perf_counter() - t0)
                    row["enqueue_ms"].append(sorted(enq))
                    row["peak_mib"].append(
                        (torch.cuda.max_memory_allocated() - base) / 2 ** 20)
                feats.setdefault(str(order), f)
                if f != feats.setdefault("inline", f):
                    raise SystemExit(f"{order}: the features differ from "
                                     "the inline order's")
    finally:
        for pool in pools.values():
            pool.shutdown(wait=True)
    for order, row in runs.items():
        enq = [x for rep in row["enqueue_ms"] for x in rep]
        print(f"{order}: analyze_batch best {min(row['analyze_batch_s']):.4f}"
              f" median {statistics.median(row['analyze_batch_s']):.4f} s; "
              f"device pass best {min(row['device_pass_s']):.4f} median "
              f"{statistics.median(row['device_pass_s']):.4f} s; a window's "
              f"enqueue in the pass {min(enq):.2f}-{max(enq):.2f} ms "
              f"(median {statistics.median(enq):.2f}, host); the pass's "
              f"peak {max(row['peak_mib']):.1f} MiB above its start",
              flush=True)
    print(card, flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": card, "rounds": args.rounds, "runs": runs}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
