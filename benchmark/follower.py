"""A follower rank of the group cell's worker (``drivers/closed_loop_group``).

    python -m benchmark.follower --dir <work dir> --device cuda|cpu

with ``torchrun``'s variables (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) set by the driver.  On a card it starts
a ``CardBusy`` session while the card is idle, opens its range, then joins
the group through the program's ``serve.group.join`` and follows the
leader's calls until the leader stops the group.  The leader then has
written ``window.json`` (the window's wall-clock bounds, ``time.time_ns()``,
and each rank's flow launches in it, from the group's counters); the
session is cut to those bounds, shifted by the offset between the wall
clock and the profiler's, read where this process opened its range, and
``busy_<rank>.json`` is written.  A run with no window (traced) writes
nothing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .roofline import blur_solve as roof_blur
from .roofline import warp as roof_warp
from .spans import _merged
from .trace import WINDOW, Busy, _union

NCCL = "nccl"  # in the name of every NCCL kernel


class CardBusy(Busy):
    """``Busy`` over a rank of a group, which keeps NCCL's kernels apart
    for the group's sum (``closed_loop_group.group_busy_s``).  An NCCL
    kernel occupies its card from its launch until every rank has
    launched its own, so on a rank whose host is ahead most of it is the
    wait for the slowest host (the leader's, which serves the clients): a
    follower's card read 7-10 s of a 12 s window so.  The session keeps
    what it recorded, to be cut again to other bounds (``cut``)."""

    def stop(self) -> None:
        import torch
        from torch._C._autograd import DeviceType
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._prof.stop()
        events = self._prof.profiler.kineto_results.events()
        self._prof = None
        lo = hi = None
        device, nccl, launches, seen = [], [], [], set()
        for e in events:
            name = e.name()
            if e.device_type() == DeviceType.CUDA:
                if name == WINDOW or e.is_user_annotation():
                    continue
                seen.add(e.correlation_id())
                if NCCL in name.lower():
                    nccl.append((e.correlation_id(), e.start_ns(),
                                 e.end_ns(), name.split("(", 1)[0]))
                else:
                    device.append((e.start_ns(), e.end_ns(),
                                   any(k in name for k in self.named)))
            elif name == WINDOW:
                lo, hi = e.start_ns(), e.end_ns()
            elif name.startswith("cudaLaunch") or name.startswith("cuLaunch"):
                launches.append((e.start_ns(), e.correlation_id()))
        del events
        if lo is None:
            raise RuntimeError("the window's marker is missing")
        self.lo_ns, self.hi_ns = lo, hi
        self.recorded = (device, sorted(nccl), launches, seen)

    def cut(self, lo_ns: int, hi_ns: int, expect: int) -> dict:
        """The session over [lo_ns, hi_ns] (the profiler's ns), in ns from
        ``lo_ns``: the card's own work (``device``, merged intervals;
        ``busy_s`` their sum in seconds) and the NCCL kernels launched in
        it (``nccl``, [start, end, name] in launch order; ``nccl_s`` their
        union in seconds)."""
        device, nccl, launches, seen = self.recorded
        self.expect = expect
        self.reduce(lo_ns, hi_ns, device, launches, seen)
        own = _merged([(max(lo_ns, a) - lo_ns, min(hi_ns, b) - lo_ns)
                      for a, b, _ in device if a < hi_ns and b > lo_ns])
        coll = [[a - lo_ns, min(hi_ns, b) - lo_ns, name]
                for _, a, b, name in nccl if lo_ns <= a < hi_ns]
        self.nccl_s = _union([(a, b) for a, b, _ in coll]) / 1e9
        return {"busy_s": self.busy_s, "nccl_s": self.nccl_s,
                "complete": self.complete, "launches": self.launches,
                "lost_share": self.lost_share, "counted": self.counted,
                "gap_s": self.gap_s, "device": own, "nccl": coll}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m benchmark.follower")
    ap.add_argument("--dir", required=True)
    ap.add_argument("--device", choices=("cuda", "cpu"), required=True)
    args = ap.parse_args(argv)
    import torch
    from avd_tpu_torch.serve import group
    rank = int(os.environ["RANK"])
    busy = None
    if args.device == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        busy = CardBusy(named=(roof_warp.KERNEL,) + roof_blur.KERNELS)
        busy.start()
        opened_ns = time.time_ns()
        busy.open()
    group.join(args.device)
    window = os.path.join(args.dir, "window.json")
    if busy is None:
        return 0
    busy.close()
    busy.stop()
    if not os.path.exists(window):
        return 0
    with open(window) as f:
        w = json.load(f)
    shift = busy.lo_ns - opened_ns  # the profiler's clock less the wall's
    out = busy.cut(w["lo_ns"] + shift, w["hi_ns"] + shift, w["expect"][rank])
    with open(os.path.join(args.dir, f"busy_{rank}.json"), "w") as f:
        json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
