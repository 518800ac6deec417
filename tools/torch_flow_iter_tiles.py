"""Time ``csrc/flow_iter.cu`` on each of its two tiles, beside an older
source, at the shapes of a full and a tail window (needs a CUDA card).

``flow_iter.cu`` runs the 32×8 tile where the 32×80 one would give
fewer than ``kSmallTileBelow`` blocks (``use_small_tile`` in
``csrc/blur.cuh``).  This script builds ``flow_iter.cu`` three ways from
the checkout's sources: as it is, with that rule forced to the large tile
and forced to the small one (the threshold rewritten in a copy under
``build/``), and with ``--old FILE`` a fourth, an older ``flow_iter.cu``
with the same C interface (for example the output of
``git show <rev>:avd_tpu_torch/csrc/flow_iter.cu``).  At each shape every
build must equal ``solve_iteration_plain`` bit for bit on the smooth and
the pan flow of ``chip_smoke.py``; each is then timed with
``chip_smoke.time_ms`` twice, the builds in one order and then the other,
in one process.  Run from the root of the checkout:

    python tools/torch_flow_iter_tiles.py [--old FILE] [--json OUT]

It prints the card's name and power limit, one line per shape and the
window sums, and writes the same numbers as JSON to ``OUT``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from avd_tpu_torch.ops.kernels import _build, flow_iter  # noqa: E402

RULE = re.compile(r"kSmallTileBelow = (\d+);")
FORCED = {"large": "kSmallTileBelow = 0;",
          "small": "kSmallTileBelow = int64_t{1} << 62;"}
LARGE_TH = 80


def _source():
    with open(os.path.join(_build.CSRC, "flow_iter.cu")) as f:
        src = f.read()
    if not RULE.search(src):
        raise SystemExit("flow_iter.cu no longer sets kSmallTileBelow")
    return src


def _variant_sources(old):
    """{name: the directory under build/ that holds its flow_iter.cu}."""
    base = os.path.join(ROOT, "build", "flow_iter_tiles")
    src = _source()
    out = {}
    for name, rule in FORCED.items():
        d = os.path.join(base, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "flow_iter.cu"), "w") as f:
            f.write(RULE.sub(rule, src))
        out[name] = d
    if old:
        d = os.path.join(base, "old")
        os.makedirs(d, exist_ok=True)
        shutil.copy(old, os.path.join(d, "flow_iter.cu"))
        out["old"] = d
    return out


def _build_variants(dirs):
    """One nvcc per build, all started together → {name: ctypes function}."""
    procs = {}
    for name, d in dirs.items():
        lib = os.path.join(d, "libflow_iter.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
             os.path.join(d, "flow_iter.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the {name} build:\n{log}")
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas ({name}): {line.strip()}")
        fn = ctypes.CDLL(lib).avd_flow_iter
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + \
            [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _caller(fn):
    import torch
    border = (ctypes.c_float * len(flow_iter.BORDER_SCALE))(
        *flow_iter.BORDER_SCALE)

    def call(R0, R1, fl):
        B, _, H, W = R0.shape
        out = torch.empty_like(fl)
        err = fn(R0.data_ptr(), R1.data_ptr(), fl.data_ptr(), out.data_ptr(),
                 B, H, W, border, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out
    return call


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="an older flow_iter.cu to time beside")
    ap.add_argument("--json", help="write the numbers here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = smoke.phase_device()
    calls = {"tree": flow_iter.solve_iteration}
    calls.update((n, _caller(f)) for n, f in
                 _build_variants(_variant_sources(args.old)).items())
    names = list(calls)
    below = int(RULE.search(_source()).group(1))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for b, h in [(b, lv) for b in (smoke.PAIRS, 12) for lv in smoke.LEVELS]:
        R1, cases = smoke._warp_cases(h, gen, b)
        R0 = torch.rand((b, 5, h, h), generator=gen, device="cuda")
        for flow_name, fl in cases.items():
            ref = flow_iter.solve_iteration_plain(R0, R1, fl)
            for n in names:
                if not torch.equal(calls[n](R0, R1, fl), ref):
                    raise SystemExit(f"{n} build at [{b},·,{h},{h}] "
                                     f"{flow_name}: not equal to the plain "
                                     "version")
        fl = cases["smooth"]
        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                times[n].append(smoke.time_ms(
                    lambda n=n: calls[n](R0, R1, fl)))
        blocks = -(-h // 32) * -(-h // LARGE_TH) * b
        row = {"shape": [b, h, h], "large_tile_blocks": blocks,
               "tree_tile": "small" if blocks < below else "large",
               "ms": {n: sum(t) / 2 for n, t in times.items()},
               "runs_ms": times}
        rows.append(row)
        print(f"[{b},·,{h},{h}] ({blocks} large-tile blocks, the tree runs "
              f"the {row['tree_tile']} tile): " + ", ".join(
                  f"{n} {row['ms'][n]:.4f} ms ({t[0]:.4f}/{t[1]:.4f})"
                  for n, t in times.items()), flush=True)
    windows = {}
    for b, label in ((smoke.PAIRS, "full"), (12, "tail")):
        windows[label] = {n: smoke.ROUNDS * sum(
            r["ms"][n] for r in rows if r["shape"][0] == b) for n in names}
        print(f"{label} window ({smoke.ROUNDS} rounds × 4 levels at B={b}): "
              + ", ".join(f"{n} {t:.4f} ms"
                          for n, t in windows[label].items()))
    print(card)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows, "windows": windows}, f,
                      indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
