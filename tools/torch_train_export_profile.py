"""Time and profile, in a process of its own, the full ViT's train step and
one scoring call of ``detector_full`` exported against the eager bundle
(needs a CUDA card).

The train step is ``chip_smoke.py`` phase 27's: the shipped
``detector_full`` at its recipe (batch 64 at 224², AdamW, cosine with
warmup, logit L2), remat off, ``chip_smoke._timed_steps`` (step ms by CUDA
events over 10 steps, then one step under the profiler: device-busy ms
and device ops).  The scoring call is phase 28's at the exported batch
(64): ``chip_smoke.time_ms`` and ``chip_smoke.device_profile`` of one
call of each program (tables in ``chiprun_out/scoring_call_*.txt``), and
the host's wall ms per call over back-to-back calls.  Run before and
after ``chip_smoke.py`` in one call on the card, it sets a fresh process
beside phases 27-28 (which run after the 26 earlier phases) on one
machine.  Run from the root of the checkout:

    python tools/torch_train_export_profile.py [--json OUT]

It prints the card's name and power limit and one line per quantity, and
writes the numbers as JSON to ``OUT``.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

WALL_CALLS = 20


def train_step(cuda):
    import numpy as np
    import torch
    from avd_tpu_torch.models import convert, detector, scoring, train
    kw = smoke._recipe("detector_full")
    cfg = detector.make_config("full")
    base = convert.load_checkpoint(scoring._shipped_ckpt("vit", "full"), cfg)
    f, y = train.synthetic_batch(np.random.default_rng(5), kw["batch"],
                                 cfg.image_size, kw["families"])
    t = smoke._timed_steps(cfg, detector, smoke._on_device(base, cuda),
                           torch.from_numpy(f).to(cuda),
                           torch.from_numpy(y).to(cuda), kw,
                           profile="train_step_profile_alone.txt")
    return dict(t, idle_share=1 - t["busy_ms"] / t["step_ms"])


def scoring_calls(cuda):
    import torch
    from avd_tpu_torch.models import export, scoring
    tmp = tempfile.mkdtemp(prefix="avd_export_")
    rows = {}
    try:
        out = os.path.join(tmp, "detector_full")
        manifest = export.export_detector(out, arch="vit", preset="full",
                                          device=cuda)
        smoke._family_env({"AVD_DETECTOR_ARCH": "vit",
                           "AVD_DETECTOR_PRESET": "full"})
        eager = scoring._bundle(cuda)
        exported = export.load_bundle(out, cuda)
        n, size = manifest["batch"], manifest["image_size"]
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        xb = torch.rand((n, size, size, 3), generator=gen, device=cuda)
        for kind, b in (("exported", exported), ("eager", eager)):
            ms = smoke.time_ms(lambda: b[2](xb), reps=10)
            busy, n_dev, avgs = smoke.device_profile(lambda: b[2](xb))
            os.makedirs("chiprun_out", exist_ok=True)
            with open(os.path.join("chiprun_out",
                                   f"scoring_call_{kind}.txt"), "w") as f:
                f.write(avgs.table(sort_by="self_device_time_total",
                                   row_limit=60))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(WALL_CALLS):
                b[2](xb)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / WALL_CALLS * 1e3
            rows[kind] = {"ms": ms, "busy_ms": busy, "device_ops": n_dev,
                          "wall_ms": wall}
    finally:
        smoke._set_env(**{k: None for k in smoke._FAMILY_ENV})
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None, help="write the numbers here")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cuda = torch.device("cuda")
    card = smoke.phase_device()
    rows = {"card": card, "train_step": train_step(cuda),
            "scoring_call": scoring_calls(cuda)}
    t = rows["train_step"]
    print(f"train step, full ViT, batch 64 at 224²: {t['step_ms']:.3f} ms, "
          f"device busy {t['busy_ms']:.3f} ms in {t['device_ops']} ops, "
          f"idle share {t['idle_share']:.4f}", flush=True)
    for kind, r in rows["scoring_call"].items():
        print(f"scoring call, detector_full {kind}, 64 frames: "
              f"{r['ms']:.3f} ms (CUDA events), busy {r['busy_ms']:.3f} ms "
              f"in {r['device_ops']} ops, host wall {r['wall_ms']:.3f} ms",
              flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
