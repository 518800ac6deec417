"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration sets the program's environment before the
program is imported; its traffic mix's driver makes the inputs from the
seed, warms every shape it will use (set-up), measures for ``--seconds``
and checks what the timed path produced against the plain reference.
``--trace 1`` reports the per-layer metrics of a profiled slice of the
window instead of the end-to-end ones.  ``--control 1`` puts the
configuration's lower-precision control in the program's place (its
``control_env`` and the driver's own substitutes): the readings that set
the correctness limits, which the benchmark's own runs never take.

Without CUDA, or with fewer cards than the cell asks for, it exits 3 and
prints no result.  It also exits 3 if ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``avd_tpu`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()  # set-up is timed from the process's start

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

from . import spec as spec_mod  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "avd_tpu")


@dataclasses.dataclass
class Check:
    """One compared number and its limit (it passes at or under it)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Context:
    """What a driver gets: the cell's pieces and the run's settings."""
    cell: Dict
    config: Dict
    traffic: Dict
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: str
    t0: float
    log: object


@dataclasses.dataclass
class Run:
    """What a driver hands back; the metric readers read it."""
    setup_s: float = 0.0
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    checks: List[Check] = dataclasses.field(default_factory=list)
    data: Dict = dataclasses.field(default_factory=dict)
    trace: Optional[object] = None

    @property
    def correct(self) -> bool:
        return all(c.ok for c in self.checks) and bool(self.checks)


def _log(msg: str) -> None:
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is one the
    benchmark must never load."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def device_info(device: str, count: int, peak: int) -> Dict:
    """The card's name and count, the peak on the fullest card, and the
    power limit as ``nvidia-smi`` reads it."""
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": int(peak)}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20)
        info["power_limit_w"] = float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        info["power_limit_w"] = None
    return info


def execute(workload: str, seed: int, seconds: float, trace: bool,
            control: bool = False, device: str = "cuda",
            root: str = spec_mod.ROOT) -> Dict:
    """Run the cell once on ``device`` and return the result line's
    object.  The CLI asks for CUDA; tests drive the CPU through here."""
    spec = spec_mod.load(root)
    cell = spec_mod.cell(spec, workload)
    config = spec_mod.config(spec, cell["config"], root)
    traffic = spec_mod.traffic(cell["traffic"])
    env = dict(config.get("env", {}))
    if control:
        env.update(config.get("control_env", {}))
    os.environ.update({k: str(v) for k, v in env.items()})
    ctx = Context(cell, config, traffic, int(seed), float(seconds),
                  bool(trace), bool(control), device, _T0, _log)
    run = spec_mod.driver(traffic["kind"]).run(ctx)

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in spec_mod.metrics_of(spec, workload, kind):
        value = spec_mod.reader(m["name"])(run, run.trace)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = device_info(device, cell["chips"], run.memory_peak_bytes)
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None and not run.trace.complete:
        _log(f"the traced slice lost the kernels of "
             f"{100 * run.trace.lost_share:.1f} % of its launches: "
             f"no device numbers")
    elif trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops(),
                            "idle_gaps": run.trace.idle_gaps()}
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in run.checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = spec_mod.load()
    chips = spec_mod.cell(spec, args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"the cell needs {chips} CUDA device(s); "
             f"torch.cuda.is_available()={torch.cuda.is_available()}, "
             f"device_count={torch.cuda.device_count()}: no result")
        return 3
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  bool(args.control))
    found = forbidden_modules()
    if found:
        _log(f"modules the benchmark must not load are loaded: {found}")
        return 3
    for name, c in out["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
