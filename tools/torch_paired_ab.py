#!/usr/bin/env python
"""Interleaved paired A/B of the port's benchmark, with a sign test.

The port's counterpart of ``tools/paired_ab.py``, on ``python -m
avd_tpu_torch.bench``.  Host clocks swing several-fold between runs, so a
single before/after pair cannot settle a small difference.  This runner:

* runs config A and config B interleaved in pairs, the order alternating
  (A,B then B,A) from pair to pair so slow drift cancels instead of
  favouring one arm;
* makes each run a fresh bench subprocess with short reps (the pair is
  the unit of replication, not the in-process best-of-N), the resident
  device stage off (``AVD_BENCH_DEVICE_STAGE=0``) unless asked for;
* reports each pair's ratio A/B, their median, and the exact two-sided
  sign test on sign(ratio - 1): noise is correlated within a pair
  (seconds apart) and much less across pairs.

Arms differ by environment (``--b-env AVD_PALLAS_ITER=1``) and/or by
checkout (``--b-cwd DIR``, e.g. a ``git worktree`` of the parent commit,
whose own ``avd_tpu_torch`` the bench then imports), so one protocol
times a parent and its change in the same session.

Usage:
    python tools/torch_paired_ab.py --pairs 6 --b-env AVD_PALLAS_ITER=1
    python tools/torch_paired_ab.py --pairs 6 --b-cwd ../parent \\
        --a-label change --b-label parent
    python tools/torch_paired_ab.py --pairs 2 --device cpu \\
        --env AVD_BENCH_FRAMES=8,AVD_BENCH_CPU_FRAMES=2

One JSON line on stdout, a table on stderr.
"""

import argparse
import json
import math
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _parse_env(items):
    out = {}
    for it in items or []:
        for kv in it.split(","):
            if not kv.strip():
                continue
            k, _, v = kv.partition("=")
            out[k.strip()] = v.strip()
    return out


def run_bench(cwd: str, env_over: dict, reps: int, timeout: int,
              device=None) -> dict:
    """One ``python -m avd_tpu_torch.bench`` in ``cwd``; its JSON line."""
    env = dict(os.environ)
    env["AVD_BENCH_REPS"] = str(reps)
    # pairs replicate across subprocesses; the resident stage is a
    # separate measure, invariant to most A/B settings
    env.setdefault("AVD_BENCH_DEVICE_STAGE", "0")
    env.update(env_over)
    cmd = [sys.executable, "-m", "avd_tpu_torch.bench"]
    if device:
        cmd += ["--device", device]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"the bench failed in {cwd}: "
                           f"{proc.stderr[-2000:]}")
    line = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()][-1]
    return json.loads(line)


def sign_test_p(ratios) -> float:
    """Two-sided exact binomial sign test on sign(ratio - 1), ties
    dropped."""
    wins = sum(1 for r in ratios if r > 1.0)
    losses = sum(1 for r in ratios if r < 1.0)
    n = wins + losses
    if n == 0:
        return 1.0
    k = min(wins, losses)
    p = sum(math.comb(n, i) for i in range(k + 1)) / 2.0 ** n
    return min(1.0, 2.0 * p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Interleaved paired A/B of the port's bench with a "
                    "sign test")
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--reps", type=int, default=2,
                    help="in-process bench reps per run (pairs are the "
                         "unit of replication)")
    ap.add_argument("--env", action="append", default=[],
                    help="common env K=V[,K=V] for both arms "
                         "(e.g. AVD_BENCH_CONTENT=noise)")
    ap.add_argument("--a-env", action="append", default=[])
    ap.add_argument("--b-env", action="append", default=[])
    ap.add_argument("--a-cwd", default=REPO)
    ap.add_argument("--b-cwd", default=REPO)
    ap.add_argument("--a-label", default="A")
    ap.add_argument("--b-label", default="B")
    ap.add_argument("--device", default=None,
                    help="the bench's --device for both arms (default: "
                         "the bench's, cuda)")
    ap.add_argument("--timeout", type=int, default=1800,
                    help="per-run timeout in seconds")
    args = ap.parse_args(argv)
    if args.pairs < 1:
        ap.error("--pairs must be at least 1")

    common = _parse_env(args.env)
    a_env = {**common, **_parse_env(args.a_env)}
    b_env = {**common, **_parse_env(args.b_env)}
    arms = {"a": (args.a_cwd, a_env), "b": (args.b_cwd, b_env)}

    # one unrecorded run per arm: the first run of a checkout may build
    # its kernels and host runtime
    print("warming both arms (unrecorded)...", file=sys.stderr, flush=True)
    for cwd, env in arms.values():
        run_bench(cwd, env, 1, args.timeout, args.device)

    pairs = []
    for i in range(args.pairs):
        order = ("a", "b") if i % 2 == 0 else ("b", "a")
        vals = {arm: run_bench(*arms[arm], args.reps, args.timeout,
                               args.device) for arm in order}
        ratio = vals["a"]["value"] / vals["b"]["value"]
        pairs.append({"a": vals["a"]["value"], "b": vals["b"]["value"],
                      "ratio": round(ratio, 4), "order": "".join(order)})
        print(f"pair {i + 1}/{args.pairs} [{pairs[-1]['order']}]: "
              f"{args.a_label}={vals['a']['value']:.1f} "
              f"{args.b_label}={vals['b']['value']:.1f} "
              f"ratio={ratio:.3f}", file=sys.stderr, flush=True)

    ratios = [p["ratio"] for p in pairs]
    med = statistics.median(ratios)
    p = sign_test_p(ratios)
    if p < 0.05:
        verdict = (f"{args.a_label} FASTER" if med > 1
                   else f"{args.b_label} FASTER")
    else:
        verdict = "NO SIGNIFICANT DIFFERENCE"
    out = {
        "protocol": "interleaved_paired_ab",
        "a": {"label": args.a_label, "cwd": args.a_cwd, "env": a_env},
        "b": {"label": args.b_label, "cwd": args.b_cwd, "env": b_env},
        "device": vals["a"]["device"],
        "pairs": pairs,
        "median_ratio_a_over_b": round(med, 4),
        "ratio_range": [round(min(ratios), 4), round(max(ratios), 4)],
        "sign_test_p": round(p, 5),
        "verdict": verdict,
    }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
