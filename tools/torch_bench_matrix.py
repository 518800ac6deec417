#!/usr/bin/env python
"""Resolution × content matrix of the port's benchmark in one command.

The port's counterpart of ``tools/bench_matrix.py``: ``python -m
avd_tpu_torch.bench`` once per (resolution, content) cell, each a fresh
subprocess, merged into one JSON document plus a table on stderr.  Every
cell carries the bench's per-rep list, median and spread, so the matrix is
one session's data with its noise bars.

Cells (``bench_matrix.CELLS``):
    1080p × {pan, static, noise},  4k × {pan, noise},  latency p50.

Usage:
    python tools/torch_bench_matrix.py [--reps 5] [--skip-latency]
        [--cells 1080p/pan,1080p/noise] [--device cpu] [--out F]

Keep the host idle while it runs: the CPU-oracle denominator and the host
prep share its cores with anything else running.
"""

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CELLS = (
    ("1080p", "pan"),
    ("1080p", "static"),
    ("1080p", "noise"),
    ("4k", "pan"),
    ("4k", "noise"),
)


def _bench(env_over: dict, timeout: int, device, what: str) -> dict:
    env = {**os.environ, **env_over}
    cmd = [sys.executable, "-m", "avd_tpu_torch.bench"]
    if device:
        cmd += ["--device", device]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the bench failed on {what}: "
                           f"{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()][-1]
    return json.loads(line)


def run_cell(res: str, content: str, reps: int, timeout: int,
             device=None) -> dict:
    return _bench({"AVD_BENCH_RES": res, "AVD_BENCH_CONTENT": content,
                   "AVD_BENCH_REPS": str(reps)}, timeout, device,
                  f"{res}/{content}")


def run_latency(timeout: int, device=None) -> dict:
    return _bench({"AVD_BENCH_MODE": "latency"}, timeout, device, "latency")


def _cells(spec):
    """``CELLS``, or the listed ``res/content`` cells of it, in order."""
    if spec is None:
        return CELLS
    want = [tuple(c.strip().split("/")) for c in spec.split(",")
            if c.strip()]
    unknown = [c for c in want if c not in CELLS]
    if unknown:
        raise SystemExit(f"unknown cells {unknown}; the cells are {CELLS}")
    return tuple(want)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--skip-latency", action="store_true")
    ap.add_argument("--cells", default=None,
                    help="run only these cells, res/content[,res/content]")
    ap.add_argument("--device", default=None,
                    help="the bench's --device (default: the bench's, cuda)")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="per-cell subprocess timeout in seconds")
    ap.add_argument("--out", help="also write the JSON document here")
    args = ap.parse_args(argv)

    doc = {"cells": []}
    for res, content in _cells(args.cells):
        cell = run_cell(res, content, args.reps, args.timeout, args.device)
        cell["res"], cell["content"] = res, content
        doc["cells"].append(cell)
        print(f"  {res:6s} {content:7s} best {cell['value']:7.1f} "
              f"median {cell['gpu_fps_median']:7.1f} "
              f"spread {cell['gpu_fps_spread']:6.1f} "
              f"device {cell['device_stage_fps']:7.1f} "
              f"vs_cpu {cell['vs_baseline']:5.1f}x", file=sys.stderr)
    if not args.skip_latency:
        lat = run_latency(args.timeout, args.device)
        doc["latency"] = lat
        print(f"  latency p50 {lat['value']} s", file=sys.stderr)
    print(json.dumps(doc))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
