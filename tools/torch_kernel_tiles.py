"""Time a blur-tiled kernel of ``csrc/`` on each of its tiles, beside an
older source, at the shapes of a full and a tail window (needs a CUDA
card).

Two kernels take the 32×TH tiles of ``csrc/blur.cuh``: ``flow_iter``
(``flow_iter.cu``) and ``blur_solve_bf16`` (the bf16 instance of
``blur_solve.cu``).  Each runs the 32×8 tile where its large tile would
give fewer than ``kSmallTileBelow`` blocks (``use_small_tile``), and its
large tile is ``kLargeTH`` rows, ``kLargeKV`` a warp.  This script builds
the kernel's source from the checkout several ways, each a copy under
``build/`` with those constants rewritten: the rule forced to the large
tile and to the small one, with ``--tile TH,KV`` (repeatable) a large tile
of TH rows and KV rows a warp (forced), and with ``--old FILE`` an older
source with the same C interface (for example the output of
``git show <rev>:avd_tpu_torch/csrc/flow_iter.cu``).  At each shape every
build is checked against the plain version on ``chip_smoke.py``'s inputs:
``flow_iter`` bit for bit on the smooth and the pan flow,
``blur_solve_bf16`` at atol 2e-4 / rtol 1e-3 (the TPU kernel's tolerance)
on positive-semidefinite M.  Each build is then timed with
``chip_smoke.time_ms`` twice, the builds in one order and then the other,
in one process.  Run from the root of the checkout:

    python tools/torch_kernel_tiles.py {flow_iter,blur_solve_bf16}
        [--tile TH,KV ...] [--old FILE] [--json OUT]

It prints the card's name and power limit, each build's ``ptxas`` lines
for the kernel, one line per shape and the window sums, and writes the
same numbers as JSON to ``OUT``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from avd_tpu_torch.ops.kernels import (  # noqa: E402
    _build, blur_solve, flow_iter)

RULE = re.compile(r"kSmallTileBelow = ([^;]+);")
TILE = re.compile(r"kLargeTH = (\d+), kLargeKV = (\d+);")
NEVER = "int64_t{1} << 62"  # no grid has this many blocks

# the kernel's source, its C symbol and argument types, and the name of its
# __global__ function in ptxas's log
KERNELS = {
    "flow_iter": ("flow_iter.cu", "avd_flow_iter",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 +
                  [ctypes.POINTER(ctypes.c_float), ctypes.c_void_p],
                  "flow_iter_kernel"),
    "blur_solve_bf16": ("blur_solve.cu", "avd_blur_solve_bf16",
                        [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 +
                        [ctypes.c_void_p], "blur_solve_bf16_kernel"),
}


def source(kernel):
    with open(os.path.join(_build.CSRC, KERNELS[kernel][0])) as f:
        src = f.read()
    if not (RULE.search(src) and TILE.search(src)):
        raise SystemExit(f"{KERNELS[kernel][0]} no longer sets "
                         "kSmallTileBelow and kLargeTH, kLargeKV")
    return src


def tree_rule(src):
    """(TH, KV, threshold) of the source's large tile and its rule."""
    th, kv = (int(v) for v in TILE.search(src).groups())
    return th, kv, int(RULE.search(src).group(1))


def variant_sources(src, tiles=()):
    """{name: source}: the rule forced to the large and to the small tile,
    and a forced large tile for each (TH, KV) in ``tiles``."""
    out = {"large": RULE.sub("kSmallTileBelow = 0;", src),
           "small": RULE.sub(f"kSmallTileBelow = {NEVER};", src)}
    for th, kv in tiles:
        if th % kv or th % 8:
            raise SystemExit(f"tile {th},{kv}: TH must be a multiple of 8 "
                             "and of KV")
        out[f"th{th}kv{kv}"] = TILE.sub(
            f"kLargeTH = {th}, kLargeKV = {kv};", out["large"])
    return out


def _write_variants(kernel, tiles, old):
    """{name: the path under build/ of its copy of the source}."""
    base = os.path.join(ROOT, "build", "kernel_tiles", kernel)
    sources = variant_sources(source(kernel), tiles)
    if old:
        with open(old) as f:
            sources["old"] = f.read()
    out = {}
    for name, text in sources.items():
        os.makedirs(os.path.join(base, name), exist_ok=True)
        out[name] = os.path.join(base, name, KERNELS[kernel][0])
        with open(out[name], "w") as f:
            f.write(text)
    return out


def _build_variants(kernel, paths):
    """One nvcc per build, all started together → {name: ctypes function}."""
    _, symbol, argtypes, global_name = KERNELS[kernel]
    procs = {}
    for name, path in paths.items():
        lib = os.path.join(os.path.dirname(path), f"lib{kernel}.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the {name} build:\n{log}")
        entry = ""
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                entry = m.group(1)
            elif global_name in entry and ("Used" in line or "spill" in line):
                args = ",".join(re.findall(r"Li(\d+)E", entry))
                print(f"ptxas ({name}) <{args}>: {line.strip()}")
        fn = getattr(ctypes.CDLL(lib), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _caller(kernel, fn):
    import torch
    border = (ctypes.c_float * len(flow_iter.BORDER_SCALE))(
        *flow_iter.BORDER_SCALE)

    def launched(err, out):
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return out

    def flow_iter_call(R0, R1, fl):
        B, _, H, W = R0.shape
        out = torch.empty_like(fl)
        return launched(fn(R0.data_ptr(), R1.data_ptr(), fl.data_ptr(),
                           out.data_ptr(), B, H, W, border,
                           torch.cuda.current_stream().cuda_stream), out)

    def blur_call(m):
        B, _, H, W = m.shape
        out = torch.empty((B, 2, H, W), device=m.device)
        return launched(fn(m.data_ptr(), out.data_ptr(), B, H, W,
                           torch.cuda.current_stream().cuda_stream), out)
    return flow_iter_call if kernel == "flow_iter" else blur_call


def _case(kernel, gen, b, h):
    """(the timed inputs, check(name, call)) at one shape."""
    import torch
    if kernel == "blur_solve_bf16":
        m = smoke._psd_m(gen, b, h, h).bfloat16()
        ref = blur_solve.box_blur_solve_plain(m)

        def check(name, call):
            err, ok = smoke._close(call(m), ref, 2e-4, 1e-3)
            if not ok:
                raise SystemExit(f"{name} build at [{b},5,{h},{h}]: |Δ| "
                                 f"{err} over atol 2e-4 rtol 1e-3")
        return (m,), check
    R1, cases = smoke._warp_cases(h, gen, b)
    R0 = torch.rand((b, 5, h, h), generator=gen, device="cuda")
    refs = {k: flow_iter.solve_iteration_plain(R0, R1, fl)
            for k, fl in cases.items()}

    def check(name, call):
        for k, fl in cases.items():
            if not torch.equal(call(R0, R1, fl), refs[k]):
                raise SystemExit(f"{name} build at [{b},·,{h},{h}] {k}: not "
                                 "equal to the plain version")
    return (R0, R1, cases["smooth"]), check


def main():
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--tile", action="append", default=[],
                    help="TH,KV: also time a forced 32×TH tile, KV rows a "
                         "warp")
    ap.add_argument("--old", help="an older source of the kernel to time "
                                  "beside")
    ap.add_argument("--json", help="write the numbers here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    card = smoke.phase_device()
    tiles = [tuple(int(v) for v in t.split(",")) for t in args.tile]
    calls = {"tree": flow_iter.solve_iteration if args.kernel == "flow_iter"
             else blur_solve.box_blur_solve}
    calls.update((n, _caller(args.kernel, f)) for n, f in _build_variants(
        args.kernel, _write_variants(args.kernel, tiles, args.old)).items())
    names = list(calls)
    th, _, below = tree_rule(source(args.kernel))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for b, h in [(b, lv) for b in (smoke.PAIRS, 12) for lv in smoke.LEVELS]:
        inputs, check = _case(args.kernel, gen, b, h)
        for n in names:
            check(n, calls[n])
        times = {n: [] for n in names}
        for order in (names, names[::-1]):
            for n in order:
                times[n].append(smoke.time_ms(lambda n=n: calls[n](*inputs)))
        blocks = -(-h // 32) * -(-h // th) * b
        row = {"shape": [b, h, h], "large_tile_blocks": blocks,
               "tree_tile": "small" if blocks < below else "large",
               "ms": {n: sum(t) / 2 for n, t in times.items()},
               "runs_ms": times}
        rows.append(row)
        print(f"{args.kernel} [{b},·,{h},{h}] ({blocks} large-tile blocks, "
              f"the tree runs the {row['tree_tile']} tile): " + ", ".join(
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
            json.dump({"kernel": args.kernel, "card": card, "rows": rows,
                       "windows": windows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
