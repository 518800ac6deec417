"""Time the float32 warp and blur+solve kernels of the checkout beside an
older build of the same sources (needs a CUDA card).

Each older source (``--old DIR`` holding ``warp.cu`` and ``blur_solve.cu``
with the same C interface, for example from
``git show <rev>:avd_tpu_torch/csrc/warp.cu``) is built with nvcc beside
the checkout's (``-I csrc`` for the shared headers).  At each level of a
full window, [48,·,H,W] for H = W in 320, 160, 80, 40, both builds must
equal the plain version bit for bit on ``chip_smoke.py``'s inputs; then
each is timed with ``chip_smoke.time_ms`` in the order old, new, new,
old, in one process.  Run from the root of the checkout:

    python tools/torch_kernel_ab.py --old DIR [--json OUT]

It prints the card's name and power limit and one line per kernel and
shape, and writes the numbers as JSON to ``OUT``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from avd_tpu_torch.ops.kernels import _build, blur_solve, warp  # noqa: E402

SYMBOLS = {"warp": "avd_warp_bilinear", "blur_solve": "avd_blur_solve"}


def _load_old(old_dir):
    """Build the older sources → {name: ctypes function}."""
    out_dir = os.path.join(ROOT, "build", "kernel_ab")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name in SYMBOLS:
        lib = os.path.join(out_dir, f"lib{name}_old.so")
        procs[name] = (lib, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC, "-o", lib,
             os.path.join(old_dir, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for the old {name}.cu:\n{log}")
        fn = getattr(ctypes.CDLL(lib), SYMBOLS[name])
        n_ptr = 3 if name == "warp" else 2
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def _call_old(fn, inputs, out):
    import torch
    err = fn(*(t.data_ptr() for t in inputs), out.data_ptr(),
             *out.shape[:1], *out.shape[2:],
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old kernel launch failed: cudaError {err}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="directory with the older warp.cu, blur_solve.cu")
    ap.add_argument("--json", help="write the numbers here")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = smoke.phase_device()
    _build.build_all(("warp", "blur_solve"))
    old = _load_old(args.old)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = []
    for h in smoke.LEVELS:
        src, cases = smoke._warp_cases(h, gen)
        fl = cases["smooth"]
        m = smoke._psd_m(gen, smoke.PAIRS, h, h)
        out5 = torch.empty_like(src)
        out2 = torch.empty((smoke.PAIRS, 2, h, h), device="cuda")
        pairs = {
            "warp": (lambda: warp.warp_bilinear(src, fl),
                     lambda: _call_old(old["warp"], (src, fl), out5),
                     warp.warp_bilinear_plain(src, fl)),
            "blur_solve": (lambda: blur_solve.box_blur_solve(m),
                           lambda: _call_old(old["blur_solve"], (m,), out2),
                           blur_solve.box_blur_solve_plain(m)),
        }
        for name, (new_fn, old_fn, ref) in pairs.items():
            if not (torch.equal(new_fn(), ref) and torch.equal(old_fn(), ref)):
                raise SystemExit(f"{name} at {h}: a build differs from the "
                                 "plain version")
            t = [smoke.time_ms(f) for f in (old_fn, new_fn, new_fn, old_fn)]
            row = {"kernel": name, "shape": [smoke.PAIRS, 5, h, h],
                   "old_ms": [t[0], t[3]], "new_ms": [t[1], t[2]],
                   "new_over_old": (t[1] + t[2]) / (t[0] + t[3])}
            rows.append(row)
            print(f"{name} [{smoke.PAIRS},5,{h},{h}] float32: old "
                  f"{t[0]:.4f} / {t[3]:.4f} ms, new {t[1]:.4f} / {t[2]:.4f} "
                  f"ms, new/old {row['new_over_old']:.4f}", flush=True)
    print(card, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
