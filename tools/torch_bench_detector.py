#!/usr/bin/env python
"""Detector-family throughput and MFU of the PyTorch port at the serving
size (224 px), on the card.

Port of ``tools/bench_detector.py``.  For each mode it measures frames/s
on device-resident input, best of ``--reps`` repetitions of ``--chain``
back-to-back scoring calls timed with CUDA events (the host clock on the
CPU), and reports the FLOPs per frame and the MFU against the H100 SXM's
dense peak (989 TFLOP/s bf16, 1979 TOP/s int8):

    python tools/torch_bench_detector.py [vit vit-int8 cnn cnn-int8
        temporal vit-fused vit-exported ...] [--batch 64] [--device cuda]

* ``vit``, ``cnn``, ``temporal``: the family's ``full`` preset, seeded
  weights, the eager serving forward (the temporal family scores one clip
  of ``--batch`` frames);
* ``-int8``: ``models/quant.py``'s W8A8 forward (vit, cnn);
* ``vit-fused``: the ViT with the attention kernel
  (``ops/kernels/attention.py``, ``AVD_ATTN_FUSED=1``);
* ``<arch>-exported``: the same program exported with ``models/export.py``
  and loaded back, served as ``AVD_DETECTOR_EXPORTED`` serves it.

FLOPs are counted by ``torch.utils.flop_counter.FlopCounterMode`` over the
plain bf16 forward of the mode's config (matmuls, einsums, convolutions):
the int8 and fused modes do the same arithmetic in other kernels, which
the counter cannot see into.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PEAK_BF16 = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8 = 1979e12  # H100 SXM dense int8

DEFAULT_MODES = ("vit", "vit-int8", "cnn", "cnn-int8", "temporal",
                 "vit-fused", "vit-exported")


def _flops_per_frame(fam, cfg, params, x) -> float:
    """FLOPs of the plain forward on ``x`` per frame."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        if hasattr(fam, "forward_clip"):
            fam.forward_clip(params, x, cfg)
        else:
            fam.forward(params, x, cfg)
    return counter.get_total_flops() / x.shape[0]


def _time(fn, x, dev, reps: int, chain: int) -> float:
    """Best seconds per call over ``reps`` runs of ``chain`` calls."""
    import torch
    best = float("inf")
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(chain):
                fn(x)
            end.record()
            end.synchronize()
            secs = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for _ in range(chain):
                fn(x)
            secs = time.perf_counter() - t0
        best = min(best, secs / chain)
    return best


def bench(mode: str, batch: int = 64, device=None, preset: str = "full",
          reps: int = 5, chain: int = 8) -> dict:
    """One mode → {"mode", "frames_per_s", "ms_per_batch",
    "flops_per_frame", "mfu", "peak"}."""
    import torch

    from avd_tpu_torch import device as device_mod
    from avd_tpu_torch import models
    from avd_tpu_torch.models import export as export_mod
    from avd_tpu_torch.models import quant

    dev = device_mod.resolve(device)
    arch, _, variant = mode.partition("-")
    fam = models.family(arch)
    cfg = fam.make_config(preset)
    if variant == "fused" and arch != "vit":
        raise ValueError(f"{mode}: the attention kernel is the ViT's")
    if variant == "int8" and arch not in ("vit", "cnn"):
        raise ValueError(f"{mode}: int8 serves vit and cnn")
    if variant not in ("", "fused", "int8", "exported"):
        raise ValueError(f"unknown mode {mode!r}")
    params = fam.init_params(0, cfg)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (batch, cfg.image_size, cfg.image_size, 3), np.float32)).to(dev)
    plain = fam.cast_for_inference(params, dev)
    flops = _flops_per_frame(fam, cfg, plain, x)

    if variant == "exported":
        with tempfile.TemporaryDirectory(prefix="avd_export_bench_") as out:
            export_mod.export_detector(out, arch=arch, preset=preset,
                                       ckpt=None, batch=batch, window=batch,
                                       devices=(dev.type,), device=dev)
            _, _, probs, _ = export_mod.load_bundle(out, dev)
        fn = ((lambda b: probs(b, batch)) if hasattr(probs, "clip_window")
              else probs)
    elif variant == "int8":
        qp = quant.to_device(quant.quantize_params(params), dev)

        def fn(b):
            return torch.sigmoid(quant.forward(qp, b, cfg)[:, 0].float())
    else:
        if variant == "fused":
            cfg = dataclasses.replace(cfg, fused_attn=True)
        clip = hasattr(fam, "forward_clip")

        def fn(b):
            out = (fam.forward_clip(plain, b, cfg) if clip
                   else fam.forward(plain, b, cfg))
            return torch.sigmoid(out[:, 0].float())

    with torch.inference_mode():
        fn(x)  # warm: kernel builds, cuBLAS handles
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = _time(fn, x, dev, reps, chain)
    fps = batch / secs
    peak = PEAK_INT8 if variant == "int8" else PEAK_BF16
    return {"mode": mode, "frames_per_s": fps, "ms_per_batch": secs * 1e3,
            "flops_per_frame": flops, "mfu": flops * fps / peak,
            "peak": "int8" if variant == "int8" else "bf16"}


def line(r: dict) -> str:
    return (f"{r['mode']:13s} {r['frames_per_s']:9.1f} frames/s  "
            f"({r['ms_per_batch']:.3f} ms/batch, "
            f"{r['flops_per_frame'] / 1e9:.2f} GFLOP/frame, MFU "
            f"{r['mfu']:.2%} of the H100's dense {r['peak']} peak)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("modes", nargs="*", default=list(DEFAULT_MODES))
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--preset", default="full")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--chain", type=int, default=8)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    import torch
    name = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(f"device: {name}  batch: {args.batch}  preset: {args.preset}")
    for m in args.modes:
        print(line(bench(m, args.batch, args.device, args.preset,
                         args.reps, args.chain)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
