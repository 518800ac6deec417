#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``avd_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:

1. device: the card's name and power limit, torch and CUDA versions;
2. build: every CUDA source under ``avd_tpu_torch/csrc`` (one nvcc each,
   all started together);
3. warp: the kernel against its plain version at [48,5,H,W] for the four
   pyramid levels, on smooth random flow and on a large pan (in-bounds
   |Δ| <= 1e-5, out-of-bounds exactly 0), with kernel, plain and
   ``grid_sample`` times and the bytes bound;
4. blur+solve: the same on positive-semidefinite M fields (atol 2e-4,
   rtol 1e-3, and equal bit for bit), plus the tail window's four levels
   ([12,5,H,W]; its 40² level takes the small tile) and ragged and small
   planes ([3,5,37,53], [2,5,16,16]); the kernel's ptxas lines;
5. main path: 145 panning 1080p BGR frames and a 5 s speech-like waveform
   through ``pipeline.analyze_decoded`` on the card; the launch counters
   must rise by 48 each (4 windows × 4 levels × 3 rounds); the envelope
   must pass ``schema.validate``; then host-prep, device and end-to-end
   times (the windows enqueued by the dispatch thread);
5b. dispatch: the warm ``analyze_batch`` and the device pass (host prep
   precomputed) in the inline order (a synchronous stand-in for the
   pool) and through the dispatch pool's one thread, interleaved over 5
   rounds: best and median, each window's enqueue ms, the pass's peak
   device memory and launches (warp and blur+solve 48 each), the
   features and envelopes bit-equal to the inline order's; then one
   packed 49-frame window's pinned
   host→device copy beside its enqueue and device time
   (``chiprun_out/dispatch.json``);
6. card vs CPU: a 25-frame 360×640 clip through the port on both (flow
   mean rtol 1e-3, |Δai_score| <= 1e-3, the same label);
7. profile: ``torch.profiler`` over the main path's device work (host prep
   precomputed), once in each dispatch order: the device-busy time and
   the card's idle share of the end-to-end run, and of each order's best
   run against its own busy time, with the pool's table of kernels by
   device time written to
   ``chiprun_out/torch_profile_window.txt``;
8. mha: the attention kernels against their plain version at the
   detector's shapes ([256,6,197,64], ``moe_small``'s [256,4,17,64],
   [12,6,197,64], [8,4,17,64]) and an odd one (atol/rtol 2e-2 on bf16), with kernel, plain and
   ``scaled_dot_product_attention`` times and the bound; the same on
   large scores (q and k times 8); then token counts
   at the edges of the 16-key tiles (16, 17, 32, 33, 65, 197, 208) at head
   dims 64, 8 and 128 on the tensor-core kernel and a shape past its
   largest instance on the general kernel, with the per-kernel counters;
9. flow_iter: the fused Farnebäck round against its plain version at
   [48,·,H,W] and at the tail window's [12,·,H,W] for the four levels
   (the tail's 80² and 40² and the full window's 40² take the small
   tile), on the smooth flow and the large pan (atol 5e-4, rtol 1e-3, the
   contract with ``avd_tpu``, and equal bit for bit), timed beside the
   unfused sequence it replaces (warp kernel, PyTorch update, blur+solve
   kernel); the kernel's ptxas lines (registers, spills);
10. detector path: the same 145 frames with ``AVD_DETECTOR=1``,
    ``AVD_ATTN_FUSED=1`` and the ``full`` ViT (the shipped trained
    weights, the port's default) through
    ``pipeline.analyze_decoded``: 145 finite probabilities, no
    ``detector_error``, the attention counter up by 6 (depth × one
    256-frame bucket), all six on the tensor-core kernel; logits card
    against CPU within 2e-2; frames/s of
    the scoring call and of the analyzer, and the device-busy time of one
    scoring call with and without the kernel;
11. fused-iteration path: 61 of the frames with ``AVD_PALLAS_ITER=1``:
    ``flow_iter`` launched 24 times (2 windows × 4 levels × 3 rounds), warp
    and blur+solve not at all, flow stats and ai_score against the unfused
    run on the card; device pass and device launches per window for both;
12. host runtime: the C++ host prep (``avd_tpu_torch/native``, built by g++
    in phase 2 beside nvcc) against its numpy plain version on the 145
    1080p frames and on 720p, 360×640 and 33×47 frames, all three outputs
    equal; host prep seconds both ways; then, warm, the main path's steady
    frames/s (best of 7 ``analyze_batch`` calls), its device pass and the
    card's idle share against phase 7's busy time, and a host profile of
    one call (``chiprun_out/analyze_batch_cprofile.txt``);
13. bf16 kernels: warp and blur+solve on bf16 inputs against their plain
    versions at [48,·,H,W] for the four levels (warp in-bounds |Δ| <= 1e-5,
    out-of-bounds 0; blur+solve equal bit for bit), timed beside the
    float32 instances of phases 3 and 4, with their bytes bounds;
14. modes, on the 61-frame clip: ``AVD_FLOW_BF16=1`` (both kernels
    launched 24 times on bf16 and never on float32; per-pair flow stats
    within the bound of ``tests/test_flow_bf16.py`` of the float32 run),
    ``AVD_PREP=device`` (|Δai_score| <= 1e-3 and the same label as host
    prep), ``AVD_CHANGE_GATE=1`` on the clip with a 20-frame static run
    put in front (pairs skipped, the moving pairs within rtol 1e-3 of the
    ungated run) and ``AVD_FREQ_FORENSICS=1`` (card against CPU within
    rtol 1e-4).

15. ``analyze_path`` on a 5 s speech-like WAV the script writes: the
    audio block on the card (checked by the device its analyzer ran on)
    against the same call on the CPU (timeline atol 2e-2, the bound of
    ``tests/test_torch_audio.py`` for the speech-like wave; |Δai_score| <=
    1e-3), no ``audio_error``, and the video block ``avd_tpu`` gives for a
    WAV on a host without cv2 (``video_error`` ModuleNotFoundError);
16. ``analyze_path`` on ``tests/data/corpus_v1/ai/clip_00_crf23.mp4``: the
    route each step took (ffprobe, libav and why it is unavailable, cv2,
    exiftool), card against CPU; then the mp4 and the WAV with the decode
    routes patched away: the envelope ``avd_tpu`` gives on a host with no
    decoder (neutral video block, ``ffmpeg_convert_failed`` audio, empty
    meta, the BMFF ``forensic`` block), no frame decoded; where cv2 is
    present, a 1080p mp4 of the 145 frames written with it (2 fps, every
    frame sampled) through ``analyze_path`` with the detector, streaming
    against ``AVD_STREAM=0`` (timelines equal within 1e-6 and 2e-2);
16b. dispatch on the streaming analyzer: that mp4 through
    ``analyzers.video.analyze`` (decode in chunks of 32) in the inline
    order and through the pool, interleaved over 3 rounds, with the
    detector off, on (scored after the stream) and on in slabs of 64
    (scored on the streaming thread beside the dispatch thread's
    enqueue): best and median s, each window's enqueue ms, summaries
    bit-equal, detector timelines within 2e-2, no restart on the batch
    path;
17. the streaming video analyzer (``analyzers.video.analyze``) with decode
    replaced by an in-memory source of the 145 frames in chunks of 32 (a
    stand-in for decode, labelled so), ``AVD_DETECTOR=1 AVD_ATTN_FUSED=1``
    on the shipped ``full`` weights and ``AVD_DETECTOR_SLAB=64``, against
    ``analyze_batch`` on the same frames: ``dup_density`` equal, the
    heuristic timeline within 1e-6, the detector timeline within 2e-2;
    ``warp``, ``blur_solve`` and ``mha`` launched; frames/s of both;
18. the CLI in subprocesses: its first call from a fresh copy of the tree
    under ``build/fresh_tree`` (``git archive HEAD`` in a git checkout,
    else the port's files), which builds the kernels there, and
    ``--jsonl`` on the WAV and the mp4 (two lines);
19. the fused scoring call (``AVD_ATTN_FUSED=1``, 256-frame bucket) under
    the profiler in this process, in a subprocess from this tree and in a
    subprocess from the fresh tree: launches and device-busy ms of each,
    the rows that differ, and the tables under ``chiprun_out/``;
20. stacked windows: ``run_prep_windows`` on m = 1, 2, 4, 8 of the pan
    frames' 49-frame host-prep windows against m ``run_prep_window`` calls
    (Hamming exact, flow mean rtol 1e-4, variance rtol 1e-3, max |Δ|
    printed); warp and blur+solve launched as often for one stacked call
    (m·48 pairs) as for one window; wall ms of both;
21. a real master, ``python -m avd_tpu_torch.serve.master --device cuda``
    with ``WEB_CONCURRENCY=2`` on a free port (log in
    ``chiprun_out/serve_recycle.log``): both workers print ``warmup
    complete`` (``warmup skipped`` or a traceback fails), ``/readyz``
    names the card, the WAV and the 1080p mp4 posted with the port's
    ``Client`` equal the in-process ``analyze_path`` envelopes (key order,
    label, |Δai_score| <= 1e-3, heuristic timeline within 1e-6, no
    ``video_error``/``audio_error``/``detector_error``), then with
    ``GUNICORN_MAX_REQUESTS=3`` a zero-downtime recycle whose replacement,
    forked while its sibling holds a CUDA context, warms and serves;
22. cross-request batching: one worker, ``GUNICORN_THREADS=4``,
    ``AVD_BATCH_WINDOW_MS=100``: 4 concurrent uploads of the 1080p mp4
    (``batch_fused_jobs`` >= 2, each envelope equal to the solo one), 4
    sequential; then, with batching on and off, one round of 4 uploads
    from 1 client and 8 from 4, every envelope held to the solo one:
    requests/s, p50 and max latency over the rounds
    (``chiprun_out/serving.json``);
23. the trace route: the in-process app with ``DEBUG=1``,
    ``/debug/trace/start``, one upload of the 1080p mp4, ``/stop``: the
    Chrome trace names ``warp_bilinear_kernel``, and the request launched
    warp and blur+solve 48 times each (``served_launches`` in the kernels
    line);
24. the detector families: the 145 frames resized to each family's input
    and scored with ``cnn_small``, ``temporal_small``, ``moe_small`` (with
    and without ``AVD_ATTN_FUSED=1``), int8 on ``detector_full`` and
    ``cnn_small`` (all shipped) and the seeded ``full`` presets of the CNN
    and the temporal family (224 px): the weights label, card against CPU
    logits on 8 frames within 2e-2, every MoE token's expert equal on
    both, ``mha`` launched depth times with the kernel and never without,
    and a scoring call's kernels and host→device copy ms, device ops and
    frames/s (``chiprun_out/families.json``);
25. temporal windows on the card: the streaming slabs of 64 against the
    batch path, and with 8-frame windows a 40-frame clip against the first
    40 frames of a 70-frame one (|Δ| <= 1e-6 both);
26. ``analyze_path`` on the 1080p mp4 with ``AVD_DETECTOR_ARCH=cnn``,
    ``temporal``, ``AVD_DETECTOR_PRESET=moe_small`` and
    ``AVD_DETECTOR_QUANT=1`` (no ``detector_error``, every frame scored,
    wall s and frames/s), then a spliced clip of blob scenes (AI-like from
    frame 20) uploaded to the in-process app with the temporal family and
    ``AVD_DETECTOR_BLEND=1``: its envelope equals the in-process one;
27. training at full width: the shipped ``detector_full`` fine-tuned with
    the recipe of its ``train_meta.json`` (224 px, width 384, depth 6,
    batch 64, lr 1e-4, warmup 300 in a cosine of 2500 steps, logit L2
    0.02, the three training families; no codec augmentation: no libav*
    there) for 40 steps from a device pool of 512 samples; train step ms,
    train frames/s and peak memory with remat off and on; the loss at the
    shipped weights on the card within 2e-2 of the CPU's on the same
    batch; remat and plain gradients within 1e-5 relative L2; a run saved
    at step 10 and resumed against an uninterrupted 20-step run (losses
    within 1e-5, parameters 1e-6); the held-out family's accuracy and AUC;
    ``calibration.json`` written by the eval tool; the trained directory
    served through ``AVD_DETECTOR_CKPT`` on the 145 frames; five steps of
    ``cnn_small``, ``temporal_small`` and ``moe_small`` at their shipped
    settings (finite losses, step ms, train frames/s).  Everything is
    written to a temporary directory;
28. exported programs: ``detector_full``, ``moe_small`` and
    ``temporal_small`` exported on the card and served through
    ``AVD_DETECTOR_EXPORTED`` on the 145 frames (within 1e-3 of the eager
    bundle, the ``exported:`` label), a tampered artifact raising, one
    call's ms exported and eager, and ``detector_full`` traced on the CPU
    and moved to the card;
29. the detector bench (``tools/torch_bench_detector.py``): frames/s,
    FLOPs per frame and MFU of each mode at 224 px, batch 64
    (``chiprun_out/training.json`` holds 27-29).

30. the NCCL probe: two NCCL ranks on the one card (NCCL is expected to
    refuse: "Duplicate GPU detected"; what it said is printed, either way
    passes);
31. inference parallelism on a group of one rank over NCCL, in this
    process (``parallel/dryrun.py``): the video path's pair features
    under context parallelism on the 145 frames' planes (``cp``: warp and
    blur+solve launched; ``cp_iter`` with the fused round: ``flow_iter``
    launched), the ``full`` ViT under (data, model) (``vit_dm``), GPipe
    (``gpipe``), ``moe_small`` expert-parallel (routes equal), the 3-D
    (data, stage, model) forward and ``temporal_small`` ring and Ulysses
    at T = 32, on the shipped weights, each against its single-device
    result (features rtol 1e-5, logits 2e-2): ms and NCCL calls;
32. the same programs and scoring's sharded branch on 4 ranks sharing the
    card over gloo, collectives staged through host memory
    (``dryrun.launch(4, "cuda")``): every rank against the single-device
    result, ms, collectives by kind and transport, kernel launches per
    rank (``chiprun_out/parallel.json``);
33. training over a rank group at full width: the shipped
    ``detector_full`` at batch 64 with its recipe (lr 1e-4, logit L2
    0.02), 3 warm steps of the dp × tp step, ZeRO-1, FSDP, GPipe over
    (data, stage) and over (data, stage, model) (``dryrun``'s
    ``dp_tp_train``, ``zero1``, ``fsdp``, ``pp_train``, ``pp_tp_train``),
    on one NCCL rank and on 4 gloo ranks sharing the card, each against
    the single-device steps on the card (loss 2e-2, ZeRO-1 against its
    replicated step rtol 1e-5, every leaf's first gradient and final value
    3e-2 in relative L2, the clip's global norm over the shards against
    the gathered gradients' rtol 1e-5, ZeRO-1's moments and FSDP's
    parameters sliced): warm ms a step, peak memory a rank, collectives by
    kind and transport, and no kernel launched on any rank
    (``chiprun_out/train_parallel.json``);
34. one served worker over a rank group (``serve/group.py``): the real
    master with one worker as (a) one NCCL rank joined through a store,
    (b) 2 gloo ranks sharing the card, (c) the master's default where
    there are two or more cards, one NCCL rank a card (else logged as not
    run); each with the detector on (the shipped ``full`` ViT sharded over
    the group) and the 1080p mp4, streaming and, in (b) and (c), with
    ``AVD_STREAM=0`` (the context-parallel pairs): ``/readyz`` reports
    the group's size, every envelope against the one-card one (label,
    |Δai_score| <= 1e-3, detector timeline 2e-2, the heuristic timeline
    1e-6 streaming, flow stats rtol 1e-5 through the pairs), warp and
    blur+solve launched on every rank for the ``AVD_STREAM=0`` upload,
    collectives by kind and transport per rank (the compute over NCCL or
    staged gloo as the group's backend says, the dispatch over gloo);
    boot-to-warm s, the warm group scoring call against the one-card
    call, requests/s, p50 and max latency from 1 and 4 clients, beside a one-card worker (``CUDA_VISIBLE_DEVICES=0``:
    no group) with the same uploads; in (b) and (c) a killed follower
    makes the worker exit and the master respawn a group that serves;
    SIGTERM leaves no process of any group
    (``chiprun_out/served_groups.json``, logs ``serve_group_*.log``).

It prints one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  It needs the repository beside it
and a CUDA device; it imports nothing of ``jax`` or ``avd_tpu``.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
import threading
from unittest import mock

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 in the tensor cores
LEVELS = (320, 160, 80, 40)  # Farnebäck pyramid of the 320² flow planes
PAIRS = 48                   # pairs per full window (chunk 48)
ROUNDS = 3                   # solver rounds per level

FRAMES_MAIN = 145
FRAMES_FUSED = 61            # one full 49-frame window and a 13-frame tail
VIT_DEPTH, VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM = 6, 6, 197, 64  # "full"
VIT_BUCKET = 256             # 145 frames padded to the power-of-two bucket
MOE_MHA_SHAPE = (VIT_BUCKET, 4, 17, 64)  # moe_small: [B, heads, tokens, D]
H_MAIN, W_MAIN = 1080, 1920
DEV = "cuda"


def log(*args):
    print(*args, flush=True)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(fn, reps=25, warm=3):
    """Median device time of one ``fn`` call in ms (CUDA events, warm).

    A sleep kernel holds the stream while the host enqueues every call
    with an event between each two, so the events time the device work
    back to back and not the host's launch overhead."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(100_000_000)  # ~50 ms at the H100's clock
    events[0].record()
    for e in events[1:]:
        fn()
        e.record()
    events[-1].synchronize()
    return statistics.median(a.elapsed_time(b)
                             for a, b in zip(events, events[1:]))


def bound_ms(n_bytes, n_flops, flops_per_s=F32_FLOPS_PER_S):
    """Least time for the work: the larger of the bytes over the memory
    rate and the operations over the card's peak rate for their type."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else
                                 "operations")


# ---------------------------------------------------------------------------
# content (numpy, from seeds)
# ---------------------------------------------------------------------------

def box_smooth(img, r):
    """Separable (2r+1)-tap box mean along the first two axes."""
    out = img.astype(np.float32)
    for axis in (0, 1):
        c = np.cumsum(np.pad(out, [(r + 1, r) if a == axis else (0, 0)
                                   for a in range(out.ndim)], mode="edge"),
                      axis=axis)
        n = out.shape[axis]
        hi = np.take(c, np.arange(2 * r + 1, 2 * r + 1 + n), axis=axis)
        lo = np.take(c, np.arange(0, n), axis=axis)
        out = (hi - lo) / (2 * r + 1)
    return out


def pan_frames(n, h, w, seed=0):
    """Textured frames panning (5, 3) px per frame over a smoothed noise
    canvas (the bench's "pan" content), BGR uint8."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 64, w + 64, 3), dtype=np.uint8)
    base = np.clip(np.round(box_smooth(base, 2)), 0, 255).astype(np.uint8)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        dy, dx = (i * 3) % 64, (i * 5) % 64
        frames[i] = base[dy:dy + h, dx:dx + w]
    return frames


def speech_like(seconds, sr=16000, seed=5):
    """Amplitude-modulated low-passed noise at 16-bit PCM resolution."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    k = np.hanning(64)
    x = np.convolve(rng.standard_normal(n), k / k.sum(), mode="same")
    env = 0.5 * (1 + np.sin(2 * np.pi * 3.0 * np.arange(n) / sr))
    return (np.round(0.6 * x * env * 32768) / 32768).astype(np.float32)


def clip_meta(w, h, fps, duration):
    return {"width": w, "height": h, "fps": fps, "duration": duration,
            "bit_rate": 8_000_000, "vcodec": "h264", "acodec": "aac",
            "format_name": "mov,mp4,m4a,3gp,3g2,mj2"}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    """nvcc for every CUDA source and g++ for the host runtime, at once."""
    from avd_tpu_torch.native import _build as host_build
    from avd_tpu_torch.ops.kernels import _build
    host = {}

    def gxx():
        t0 = time.perf_counter()
        try:
            host["path"] = host_build.build()
        except Exception as e:  # reported below, after nvcc is done
            host["error"] = e
        host["seconds"] = time.perf_counter() - t0

    t = threading.Thread(target=gxx)
    t.start()
    secs = _build.build_all()
    t.join()
    if "error" in host:
        raise PhaseError(f"host runtime build: {host['error']}")
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "nvcc_ptxas.txt")
    with open(path, "w") as f:
        for name, text in _build.BUILD_LOGS.items():
            f.write(f"== {name}.cu\n{text}\n")
    log(f"build: {len(_build.SOURCES)} CUDA sources in {secs:.2f} s; "
        f"registers and shared memory per kernel in {path}")
    log(f"build: host runtime {os.path.basename(host['path'])} by "
        f"{host_build.version()} in {host['seconds']:.2f} s "
        f"({'compiled' if host_build.BUILD_INFO else 'found built'})")


def _warp_cases(h, gen, pairs=PAIRS):
    import torch
    import torch.nn.functional as F
    src = torch.rand((pairs, 5, h, h), generator=gen, device=DEV)
    rough = (torch.rand((pairs, 2, h, h), generator=gen, device=DEV)
             - 0.5) * 12.0
    smooth = F.avg_pool2d(F.pad(rough, (2, 2, 2, 2), mode="replicate"), 5,
                          stride=1).contiguous()
    pan = torch.empty((pairs, 2, h, h), device=DEV)
    pan[:, 0] = 61.3 * h / 128
    pan[:, 1] = 3.7 * h / 40
    return src, {"smooth": smooth, "pan": pan}


def phase_warp(gen):
    import torch
    import torch.nn.functional as F
    from avd_tpu_torch.ops import flow as flow_ops
    from avd_tpu_torch.ops.kernels import warp
    rows, max_err = [], 0.0
    for h in LEVELS:
        src, cases = _warp_cases(h, gen)
        n_inb = {}
        for name, fl in cases.items():
            out = warp.warp_bilinear(src, fl)
            ref = warp.warp_bilinear_plain(src, fl)
            _, inb = flow_ops._warp_poly(src, fl)
            n_inb[name] = int(inb.sum())
            inb = inb[:, None].expand_as(out)
            err = float((out - ref)[inb].abs().max()) if inb.any() else 0.0
            check(err <= 1e-5, f"warp {h} {name}: in-bounds |Δ| {err}")
            check(not bool(out[~inb].any()),
                  f"warp {h} {name}: out-of-bounds pixels not 0")
            max_err = max(max_err, err)
        fl = cases["smooth"]
        ys, xs = torch.meshgrid(torch.arange(h, device=DEV),
                                torch.arange(h, device=DEV),
                                indexing="ij")
        grid = torch.stack([(xs + fl[:, 0]) * (2.0 / (h - 1)) - 1,
                            (ys + fl[:, 1]) * (2.0 / (h - 1)) - 1], dim=-1)
        ms = time_ms(lambda: warp.warp_bilinear(src, fl))
        plain = time_ms(lambda: warp.warp_bilinear_plain(src, fl))
        lib = time_ms(lambda: F.grid_sample(src, grid, mode="bilinear",
                                            padding_mode="zeros",
                                            align_corners=True))
        px = PAIRS * h * h
        bnd, by = bound_ms(px * (5 + 2 + 5) * 4,
                           px * 10 + n_inb["smooth"] * 35)
        rows.append((h, ms, plain, lib, bnd, by))
        log(f"warp [{PAIRS},5,{h},{h}]: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, grid_sample {lib:.4f} ms, bound {bnd:.4f} ms "
            f"({by}); max in-bounds |Δ| {max_err:.3g}")
    return rows, max_err


def _psd_m(gen, b, h, w):
    import torch
    r4, r5, r6, h1, h2 = torch.randn((5, b, h, w), generator=gen, device=DEV)
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6,
                        h1, h2], dim=1).contiguous()


def phase_blur_solve(gen):
    import torch
    from avd_tpu_torch.ops.kernels import blur_solve
    rows, max_err = [], 0.0
    # the full window's levels, the tail window's (its 40² level takes the
    # small tile), then ragged and small planes
    shapes = [(PAIRS, h, h) for h in LEVELS] + \
        [(12, h, h) for h in LEVELS] + [(3, 37, 53), (2, 16, 16)]
    for b, h, w in shapes:
        m = _psd_m(gen, b, h, w)
        out = blur_solve.box_blur_solve(m)
        ref = blur_solve.box_blur_solve_plain(m)
        err, ok = _close(out, ref, 2e-4, 1e-3)
        check(ok, f"blur+solve [{b},5,{h},{w}]: |Δ| {err} over atol 2e-4 "
                  "rtol 1e-3")
        check(torch.equal(out, ref),
              f"blur+solve [{b},5,{h},{w}]: not equal to the plain version")
        max_err = max(max_err, err)
        ms = time_ms(lambda: blur_solve.box_blur_solve(m))
        plain = time_ms(lambda: blur_solve.box_blur_solve_plain(m))
        px = b * h * w
        bnd, by = bound_ms(px * (5 + 2) * 4, px * 170)
        if b == PAIRS:
            rows.append((h, ms, plain, None, bnd, by))
        log(f"blur_solve [{b},5,{h},{w}]: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, bound {bnd:.4f} ms ({by}); max |Δ| {err:.3g}")
    for line in ptxas_lines("blur_solve", "blur_solve_kernel"):
        log(f"ptxas: {line}")
    return rows, max_err


def ptxas_lines(source, kernel):
    """What ``-Xptxas -v`` said of each instance of ``kernel`` in this run's
    build of ``csrc/<source>.cu``: registers, barriers, spills."""
    import re
    from avd_tpu_torch.ops.kernels import _build
    out, name, spill = [], None, ""
    for line in _build.BUILD_LOGS.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), ""
        elif name and kernel in name and "spill" in line:
            spill = line.strip()
        elif name and kernel in name and "Used" in line:
            args = ",".join(re.findall(r"Li(\d+)E", name)
                            + (["bf16"] if "nv_bfloat16" in name else []))
            used = line.split(":", 1)[1].strip()
            out.append(f"{kernel}<{args}>: {used}; {spill}")
    return out or [f"{kernel}: not built in this run"]


def _kernel_modules():
    from avd_tpu_torch.ops.kernels import (attention, blur_solve, flow_iter,
                                           warp)
    return {"warp_bilinear": warp, "box_blur_solve": blur_solve,
            "solve_iteration": flow_iter, "mha": attention}


def _reset_counters():
    mods = _kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    for which in mods["mha"].VARIANT_LAUNCHES:
        mods["mha"].VARIANT_LAUNCHES[which] = 0
    for name in ("warp_bilinear", "box_blur_solve"):
        for dtype in mods[name].DTYPE_LAUNCHES:
            mods[name].DTYPE_LAUNCHES[dtype] = 0


def _counters():
    """Launches per wrapper; the bf16 launches of warp and blur+solve also
    under ``<name>_bf16`` (they are counted in ``<name>`` too)."""
    mods = _kernel_modules()
    out = {name: mod.LAUNCHES for name, mod in mods.items()}
    for name in ("warp_bilinear", "box_blur_solve"):
        out[f"{name}_bf16"] = mods[name].DTYPE_LAUNCHES["bfloat16"]
    return out


def phase_main_path():
    import torch
    from avd_tpu_torch import pipeline, schema
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.ingest import video_reader
    from avd_tpu_torch.ops import host_prep, video_features

    t0 = time.perf_counter()
    frames = pan_frames(FRAMES_MAIN, H_MAIN, W_MAIN)
    log(f"main path: made {FRAMES_MAIN} frames of {H_MAIN}x{W_MAIN} in "
        f"{time.perf_counter() - t0:.2f} s")
    fps = 30.0
    dur = FRAMES_MAIN * video_reader.sampling_step(fps) / fps
    fb = video_reader.FrameBatch(frames, FRAMES_MAIN, fps, W_MAIN, H_MAIN,
                                 dur)
    wav = speech_like(5.0)
    cuda = torch.device(DEV)

    _reset_counters()
    t0 = time.perf_counter()
    env = pipeline.analyze_decoded(fb, wav, 16000,
                                   clip_meta(W_MAIN, H_MAIN, fps, dur),
                                   device=cuda)
    first_s = time.perf_counter() - t0
    launches = _counters()
    log(f"main path launches: {launches}")
    for name in ("warp_bilinear", "box_blur_solve"):
        check(launches[name] == 48 and launches[f"{name}_bf16"] == 0,
              f"{name} launched {launches[name]} times on the main path "
              f"({launches[f'{name}_bf16']} on bf16), expected 48 on "
              "float32 (4 windows x 4 levels x 3 rounds)")
    schema.validate(env)
    summ = env["video"]["summary"]
    check(all(np.isfinite(v) for v in summ.values()
              if isinstance(v, float)), f"non-finite summary {summ}")
    check(len(env["video"]["timeline"]) == int(round(dur)),
          "video timeline length")
    check(0.5 < summ["flow_mean"] < 20.0,
          f"flow_mean {summ['flow_mean']} of a (5, 3) px/frame pan")
    log(f"main path envelope: label {env['result']['label']} ai_score "
        f"{env['result']['ai_score']} flow_mean {summ['flow_mean']:.6f} "
        f"dup_density {summ['dup_density']} ({first_s:.2f} s, first call)")

    # steady state: the video analyzer end to end, then its two halves
    e2e = []
    for _ in range(3):
        t0 = time.perf_counter()
        video_an.analyze_batch(fb, device=cuda)
        e2e.append(time.perf_counter() - t0)
    prep = []
    for _ in range(2):
        t0 = time.perf_counter()
        host_prep.host_prep(frames)
        prep.append(time.perf_counter() - t0)
    chunk = video_features._DEFAULT_CHUNK
    prepped = [host_prep.host_prep(frames[i:i + chunk])
               for i in range(0, FRAMES_MAIN, chunk)]
    dev = []
    for _ in range(3):
        it = iter(prepped)
        with mock.patch.object(video_features.host_prep_mod, "host_prep",
                               lambda f, **_: next(it)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            video_features.compute_features(frames, device=cuda)
            dev.append(time.perf_counter() - t0)
    best = min(e2e)
    log(f"main path steady: analyze_batch {best:.3f} s "
        f"({FRAMES_MAIN / best:.2f} frames/s; runs "
        f"{', '.join(f'{t:.3f}' for t in e2e)}), host prep "
        f"{min(prep):.3f} s, device pass (prep precomputed) "
        f"{min(dev):.3f} s (runs {', '.join(f'{t:.3f}' for t in dev)}), "
        f"threads {os.cpu_count()}")
    return launches, frames, fb, best


# the inline order (each window enqueued on the streaming thread) and the
# shipped dispatch stage (one avd-dispatch thread)
DISPATCH_ORDERS = ("inline", "pool")
DISPATCH_ROUNDS = 5           # interleaved rounds of the orders
STREAM_ROUNDS = 3             # the same, on the streaming analyzer (16b)
PACKED_REPS = 10              # host-clocked reps of the packed window


class _InlinePool:
    """The inline order, a stand-in for the dispatch pool: each
    ``submit`` runs at once on the streaming thread."""

    def submit(self, fn, *args):
        f = concurrent.futures.Future()
        f.set_result(fn(*args))
        return f


@contextlib.contextmanager
def dispatch_order(order):
    """``video_features``' dispatch stage as ``order``: ``"pool"`` the
    shipped one, ``"inline"`` the stand-in above."""
    from avd_tpu_torch.ops import video_features
    if order == "pool":
        yield
        return
    with mock.patch.object(video_features, "_dispatch_pool", _InlinePool):
        yield


@contextlib.contextmanager
def timed_enqueues(into):
    """Append each window's enqueue (host ms of ``run_prep_window`` on the
    thread that ran it, without a wait) to ``into``."""
    from avd_tpu_torch.ops import video_features
    orig = video_features.run_prep_window

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        into.append((time.perf_counter() - t0) * 1e3)
        return out

    with mock.patch.object(video_features, "run_prep_window", timed):
        yield


def _spread(xs):
    return {"best": min(xs), "median": statistics.median(xs), "runs": xs}


def phase_dispatch(frames, fb, card):
    """The dispatch stage both ways, interleaved in one process (the
    order rotates each round): the inline order and the shipped pool of
    one thread.  Each run: the warm ``analyze_batch``, then the device
    pass with the host prep precomputed, its peak device memory above
    what was allocated before it, its launches and each window's enqueue
    ms.  Every run's features and envelope equal the inline order's bit
    for bit; warp and blur+solve launch 48 times in each.  Then one
    packed 49-frame window: its pinned host→device copy (device ms), the
    pinning (host ms), the window's enqueue (host ms, ``run_prep_window``
    without a wait) and its device time."""
    import torch
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.ops import host_prep, video_features
    cuda = torch.device(DEV)
    chunk = video_features._DEFAULT_CHUNK
    prepped = [host_prep.host_prep(frames[i:i + chunk])
               for i in range(0, FRAMES_MAIN, chunk)]
    pool = video_features._dispatch_pool()
    check(pool._max_workers == 1,
          f"dispatch: a pool of {pool._max_workers} threads, expected 1")
    runs = {o: {"analyze_batch_s": [], "device_pass_s": [], "enqueue_ms": [],
                "peak_mib": [], "launches": []} for o in DISPATCH_ORDERS}
    feats, envs = {}, {}
    for r in range(DISPATCH_ROUNDS):
        k = r % len(DISPATCH_ORDERS)
        for order in DISPATCH_ORDERS[k:] + DISPATCH_ORDERS[:k]:
            row = runs[order]
            with dispatch_order(order):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                env = video_an.analyze_batch(fb, device=cuda)
                row["analyze_batch_s"].append(time.perf_counter() - t0)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                _reset_counters()
                with timed_enqueues(row["enqueue_ms"]):
                    t0 = time.perf_counter()
                    f, _ = _device_pass(frames, prepped)
                    row["device_pass_s"].append(time.perf_counter() - t0)
                row["peak_mib"].append(
                    (torch.cuda.max_memory_allocated() - base) / 2 ** 20)
                n = _counters()
                row["launches"].append(n)
            feats.setdefault(order, f)  # round 0 starts with "inline"
            envs.setdefault(order, env)
            check(f == feats["inline"] and env == envs["inline"],
                  f"dispatch {order}: the features or the analyze_batch "
                  "result differ from the inline order's")
            for name in ("warp_bilinear", "box_blur_solve"):
                check(n[name] == 48 and n[f"{name}_bf16"] == 0,
                      f"dispatch {order}: {name} launched {n[name]} times "
                      "in the device pass, expected 48 on float32")
    out = {"card": card, "rounds": DISPATCH_ROUNDS, "orders": {}}
    for order in DISPATCH_ORDERS:
        row = runs[order]
        out["orders"][order] = o = {
            "analyze_batch_s": _spread(row["analyze_batch_s"]),
            "device_pass_s": _spread(row["device_pass_s"]),
            "enqueue_ms": _spread(row["enqueue_ms"]),
            "peak_mib": max(row["peak_mib"]),
            "launches": row["launches"][0]}
        a, d, e = o["analyze_batch_s"], o["device_pass_s"], o["enqueue_ms"]
        log(f"dispatch {order}: analyze_batch best {a['best']:.4f} s "
            f"median {a['median']:.4f} s ({FRAMES_MAIN / a['best']:.2f} "
            f"frames/s); device pass best {d['best']:.4f} s median "
            f"{d['median']:.4f} s, a window's enqueue median "
            f"{e['median']:.2f} ms (host, {len(row['enqueue_ms'])} windows); "
            f"peak device memory of the pass {o['peak_mib']:.1f} MiB above "
            f"its start; launches warp {o['launches']['warp_bilinear']}, "
            f"blur+solve {o['launches']['box_blur_solve']} (every run)")
    log(f"dispatch: the features and envelopes of {len(DISPATCH_ORDERS)} "
        "orders are bit-equal")

    # one packed full window: the copy that AVD_H2D_DELTA would shrink
    w320 = np.concatenate([prepped[0][0][:1], prepped[0][0]])
    w32 = np.concatenate([prepped[0][1][:1], prepped[0][1]])
    host = torch.from_numpy(np.concatenate([w320.reshape(-1),
                                            w32.reshape(-1)]))
    pin = []
    for _ in range(PACKED_REPS):
        t0 = time.perf_counter()
        host.pin_memory()
        pin.append((time.perf_counter() - t0) * 1e3)
    pinned = host.pin_memory()
    copy_ms = time_ms(lambda: pinned.to(cuda, non_blocking=True))
    enq, win = [], []
    for _ in range(PACKED_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        video_features.run_prep_window(w320, w32, cuda)
        enq.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    for _ in range(PACKED_REPS // 2):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(200_000_000)  # covers the window's enqueue
        e0.record()
        video_features.run_prep_window(w320, w32, cuda)
        e1.record()
        e1.synchronize()
        win.append(e0.elapsed_time(e1))
    nbytes = host.numel()
    out["packed_window"] = {
        "bytes": nbytes, "pinned_h2d_ms": copy_ms,
        "h2d_gb_per_s": nbytes / copy_ms / 1e6,
        "pin_host_ms": _spread(pin), "enqueue_host_ms": _spread(enq),
        "window_device_ms": _spread(win)}
    log(f"packed window: {nbytes} B ({w320.shape[0]} x (320² + 32²) u8); "
        f"pinned host→device copy {copy_ms:.4f} ms "
        f"({nbytes / copy_ms / 1e6:.2f} GB/s; device, median of 25); "
        f"pinning {statistics.median(pin):.4f} ms (host); the window's "
        f"enqueue {statistics.median(enq):.4f} ms (host, median of "
        f"{PACKED_REPS}, best {min(enq):.4f}); its device time "
        f"{statistics.median(win):.4f} ms (median of {len(win)})")
    return out


def phase_card_vs_cpu():
    import torch
    from avd_tpu_torch import pipeline
    from avd_tpu_torch.ingest import video_reader
    frames = pan_frames(25, 360, 640, seed=1)
    fps = 30.0
    dur = 25 * video_reader.sampling_step(fps) / fps
    fb = video_reader.FrameBatch(frames, 25, fps, 640, 360, dur)
    wav = speech_like(3.0, seed=6)
    meta = clip_meta(640, 360, fps, dur)
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        out[dev] = pipeline.analyze_decoded(fb, wav, 16000, dict(meta),
                                            device=torch.device(dev))
        log(f"card vs cpu: {dev} {time.perf_counter() - t0:.2f} s")
    g, c = out["cuda"], out["cpu"]
    fm_g = g["video"]["summary"]["flow_mean"]
    fm_c = c["video"]["summary"]["flow_mean"]
    rel = abs(fm_g - fm_c) / abs(fm_c)
    d_ai = abs(np.mean(g["timeline_binned"]) - np.mean(c["timeline_binned"]))
    log(f"card vs cpu: flow_mean {fm_g:.7f} vs {fm_c:.7f} (rel {rel:.3g}), "
        f"|Δai_score| {d_ai:.3g}, labels {g['result']['label']} / "
        f"{c['result']['label']}")
    check(rel <= 1e-3, f"flow_mean differs by {rel} relative")
    check(d_ai <= 1e-3, f"ai_score differs by {d_ai}")
    check(g["result"]["label"] == c["result"]["label"], "labels differ")
    check(g["video"]["summary"]["dup_density"]
          == c["video"]["summary"]["dup_density"], "dup_density differs")


def device_profile(fn):
    """Run ``fn`` twice under ``torch.profiler`` and keep the second run:
    the first is the profiler's warm-up cycle.  Returns (device-busy ms,
    count of device kernels and copies, the averages).  Device-side events
    only: an operator's row repeats the time of the kernels it launched.

    Without the warm-up cycle the trace can lose the first device events
    of the window: on the H100 a detector scoring call read 13.6-14.0 ms
    when its 154 MB pageable host→device copy (20-28 ms) and, once, its
    embedding kernels were missing from the table, and 34-42 ms when they
    were there (PERF.md §6, PR 6)."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    avgs = prof.key_averages()
    # the step's own row spans the whole step on the device: not work
    dev = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    check(busy_ms > 0, "the profiler recorded no device time")
    return busy_ms, sum(e.count for e in dev), avgs


def _kernel_ms(avgs, name):
    """Device ms and launches of the kernels whose name holds ``name``."""
    import torch
    rows = [e for e in avgs if name in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.self_device_time_total for e in rows) / 1e3, \
        sum(e.count for e in rows)


def _device_pass(frames, prepped=None):
    """``compute_features`` on the card with the host prep precomputed;
    returns (features, the prepped chunks)."""
    from avd_tpu_torch.ops import host_prep, video_features
    chunk = video_features._DEFAULT_CHUNK
    if prepped is None:
        prepped = [host_prep.host_prep(frames[i:i + chunk])
                   for i in range(0, frames.shape[0], chunk)]
    it = iter(prepped)
    with mock.patch.object(video_features.host_prep_mod, "host_prep",
                           lambda f, **_: next(it)):
        feats = video_features.compute_features(frames, device=DEV)
    return feats, prepped


def phase_profile(frames, e2e_s, dispatch):
    """torch.profiler over the device work of the main path's windows,
    once in each dispatch order; the card's idle share is 1 - device busy
    / end-to-end wall time: for the main path's run (the shipped pool)
    and for each order's best ``analyze_batch`` against that order's own
    busy time (``chiprun_out/dispatch.json``)."""
    _, prepped = _device_pass(frames)
    prof = {}
    for order in DISPATCH_ORDERS:
        with dispatch_order(order):
            prof[order] = device_profile(
                lambda: _device_pass(frames, prepped))
    busy_ms, _, avgs = prof["pool"]
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "torch_profile_window.txt")
    with open(path, "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=40))
    idle = 1 - busy_ms / 1e3 / e2e_s
    log(f"profile: device busy {busy_ms:.3f} ms per {FRAMES_MAIN}-frame "
        f"clip; idle share {idle:.4f} of the "
        f"{e2e_s:.3f} s end-to-end run (the dispatch pool); table in {path}")
    dispatch["idle_share_main_path"] = idle
    for order, row in dispatch["orders"].items():
        row["busy_ms"] = prof[order][0]
        row["idle_share"] = \
            1 - row["busy_ms"] / 1e3 / row["analyze_batch_s"]["best"]
    log("profile: each dispatch order's device busy and the idle share of "
        "its best analyze_batch: " + ", ".join(
            f"{o} {r['busy_ms']:.3f} ms, {r['idle_share']:.4f}"
            for o, r in dispatch["orders"].items()))
    with open(os.path.join("chiprun_out", "dispatch.json"), "w") as f:
        json.dump(dispatch, f, indent=1)
    for order in DISPATCH_ORDERS:
        for name in ("blur_solve_kernel", "warp_bilinear_kernel"):
            ms, n = _kernel_ms(prof[order][2], name)
            check(n == 48, f"the {order} profile holds {n} launches of "
                  f"{name}")
            if order == "pool":
                log(f"profile: {name} {ms:.3f} ms in {n} launches "
                    f"({100 * ms / busy_ms:.2f} % of the device-busy time)")
    return busy_ms


def _close(out, ref, atol, rtol):
    """(max |Δ|, whether every element is within atol + rtol·|ref|)."""
    d = (out.float() - ref.float()).abs()
    return float(d.max()), bool((d <= atol + rtol * ref.float().abs()).all())


def phase_mha(gen):
    """The attention kernel against its plain version, as the detector
    block calls it: [B,T,H,D] views of one qkv tensor → [B,T,H·D]."""
    import torch
    import torch.nn.functional as F
    from avd_tpu_torch.ops.kernels import attention
    rows, max_err = [], 0.0
    shapes = [(VIT_BUCKET, VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM),
              MOE_MHA_SHAPE, (12, VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM),
              (8, 4, 17, 64), (2, 3, 17, 8)]
    for b, h, t, d in shapes:
        qkv = torch.randn((b, t, 3, h, d), generator=gen,
                          device=DEV).bfloat16()
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        out = attention.attention(q, k, v)
        ref = attention.attention_plain(q, k, v)
        err, ok = _close(out, ref, 2e-2, 2e-2)
        check(ok, f"mha [{b},{h},{t},{d}]: |Δ| {err} over atol/rtol 2e-2")
        # the head-major entry point on dense tensors
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        err_h, ok = _close(attention.mha(qh, kh, vh),
                           attention.mha_plain(qh, kh, vh), 2e-2, 2e-2)
        check(ok, f"mha head-major [{b},{h},{t},{d}]: |Δ| {err_h}")
        max_err = max(max_err, err, err_h)
        ms = time_ms(lambda: attention.attention(q, k, v))
        plain = time_ms(lambda: attention.attention_plain(q, k, v))
        qs, ks, vs = (x.transpose(1, 2) for x in (q, k, v))
        lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs))
        n = b * h * t * d
        bnd, by = bound_ms(4 * n * 2, 4 * n * t, BF16_FLOPS_PER_S)
        rows.append(((b, h, t, d), ms, plain, lib, bnd, by))
        log(f"mha [{b},{h},{t},{d}]: kernel {ms:.4f} ms, plain {plain:.4f} "
            f"ms, scaled_dot_product_attention {lib:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}); max |Δ| {max(err, err_h):.3g}")
        check(attention.variant(t, d) == "mma", f"variant({t}, {d})")

    # large scores (q and k times 8, rows nearly one-hot): the tensor-core
    # kernel's base-2 exponent with the scale folded in, where it is largest
    b, h, t, d = 4, VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM
    qkv = torch.randn((b, t, 3, h, d), generator=gen, device=DEV).bfloat16()
    q, k, v = qkv[:, :, 0] * 8, qkv[:, :, 1] * 8, qkv[:, :, 2]
    err, ok = _close(attention.attention(q, k, v),
                     attention.attention_plain(q, k, v), 2e-2, 2e-2)
    check(ok, f"mha on large scores [{b},{h},{t},{d}]: |Δ| {err} over "
              "atol/rtol 2e-2")
    max_err = max(max_err, err)
    log(f"mha [{b},{h},{t},{d}] with q and k times 8: max |Δ| {err:.3g}")

    # tile edges on the tensor-core kernel, then the general kernel
    edges = [(4, 3, t, d) for d in (64, 8, 128)
             for t in (16, 17, 32, 33, 65, 197, 208)]
    beyond = [(2, 3, attention.MMA_MAX_TOKENS + 1, 64), (2, 3, 300, 40)]
    for which, cases in (("mma", edges), ("general", beyond)):
        before = dict(attention.VARIANT_LAUNCHES)
        worst = 0.0
        for b, h, t, d in cases:
            check(attention.variant(t, d) == which,
                  f"variant({t}, {d}) is not {which}")
            qkv = torch.randn((b, t, 3, h, d), generator=gen,
                              device=DEV).bfloat16()
            q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
            err, ok = _close(attention.attention(q, k, v),
                             attention.attention_plain(q, k, v), 2e-2, 2e-2)
            check(ok, f"mha ({which}) [{b},{h},{t},{d}]: |Δ| {err} over "
                      "atol/rtol 2e-2")
            worst = max(worst, err)
        after = attention.VARIANT_LAUNCHES
        other = "general" if which == "mma" else "mma"
        check(after[which] == before[which] + len(cases)
              and after[other] == before[other],
              f"variant counters {before} -> {after} over {len(cases)} "
              f"{which} shapes")
        max_err = max(max_err, worst)
        log(f"mha {which} kernel at {len(cases)} edge shapes "
            f"{[c[2:] for c in cases]}: max |Δ| {worst:.3g}")
    return rows, max_err


def phase_flow_iter(gen):
    """The fused round against its plain version and beside the unfused
    sequence (warp kernel + PyTorch update + blur+solve kernel)."""
    import torch
    from avd_tpu_torch.ops import flow as flow_ops
    from avd_tpu_torch.ops.kernels import blur_solve, flow_iter, warp
    rows, max_err = [], 0.0
    for pairs, h in [(b, lv) for b in (PAIRS, 12) for lv in LEVELS]:
        R1, cases = _warp_cases(h, gen, pairs)
        R0 = torch.rand((pairs, 5, h, h), generator=gen, device=DEV)
        n_inb = 0
        for name, fl in cases.items():
            out = flow_iter.solve_iteration(R0, R1, fl)
            ref = flow_iter.solve_iteration_plain(R0, R1, fl)
            err, ok = _close(out, ref, 5e-4, 1e-3)
            check(ok, f"flow_iter [{pairs},{h}] {name}: |Δ| {err} over "
                      "atol 5e-4 rtol 1e-3")
            check(torch.equal(out, ref), f"flow_iter [{pairs},{h}] {name}: "
                                         "not equal to the plain version")
            max_err = max(max_err, err)
            if name == "smooth":
                n_inb = int(flow_ops._in_bounds(fl).sum())
                check(n_inb < fl[:, 0].numel(),
                      "the smooth flow never leaves the image")
        fl = cases["smooth"]

        def unfused():
            m = flow_ops.update_from_warped(R0, warp.warp_bilinear(R1, fl),
                                            fl)
            return blur_solve.box_blur_solve(m)

        ms = time_ms(lambda: flow_iter.solve_iteration(R0, R1, fl))
        plain = time_ms(lambda: flow_iter.solve_iteration_plain(R0, R1, fl),
                        reps=9)
        seq = time_ms(unfused)
        px = pairs * h * h
        bnd, by = bound_ms(px * (2 + 5 + 5 + 2) * 4,
                           px * 215 + n_inb * 35)
        key = h if pairs == PAIRS else f"{h} at B={pairs}"
        rows.append((key, ms, plain, None, bnd, by, seq))
        log(f"flow_iter [{pairs},5,{h},{h}]: kernel {ms:.4f} ms, plain "
            f"{plain:.4f} ms, unfused sequence {seq:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}); max |Δ| {max_err:.3g}")
    for line in ptxas_lines("flow_iter", "flow_iter_kernel"):
        log(f"ptxas: {line}")
    return rows, max_err


def _set_env(**env):
    """Set or drop environment settings the port reads, and drop what it
    cached from them."""
    from avd_tpu_torch import config
    from avd_tpu_torch.models import scoring
    for k, v in env.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    config.reset_config()
    scoring._bundle.cache_clear()


def phase_detector(frames, fb):
    """The detector path at full width: AVD_DETECTOR=1, AVD_ATTN_FUSED=1,
    the default preset (``full``) on the shipped trained weights."""
    import torch
    from avd_tpu_torch import pipeline, schema
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.models import detector, scoring
    cuda = torch.device(DEV)
    _set_env(AVD_DETECTOR="1", AVD_ATTN_FUSED="1", AVD_DETECTOR_PRESET=None,
             AVD_DETECTOR_CKPT=None, AVD_DETECTOR_BLEND=None)
    try:
        cfg = scoring._bundle(cuda)[0]
        check((cfg.image_size, cfg.width, cfg.depth, cfg.heads, cfg.tokens,
               cfg.head_dim, cfg.fused_attn) ==
              (224, 384, VIT_DEPTH, VIT_HEADS, VIT_TOKENS, VIT_HEAD_DIM,
               True), f"not the full preset with the kernel: {cfg}")
        meta = clip_meta(W_MAIN, H_MAIN, fb.fps, fb.duration)
        _reset_counters()
        t0 = time.perf_counter()
        env = pipeline.analyze_decoded(fb, speech_like(5.0), 16000, meta,
                                       device=cuda)
        first_s = time.perf_counter() - t0
        launches = _counters()
        log(f"detector path launches: {launches}")
        video = env["video"]
        check("detector_error" not in video,
              f"detector_error: {video.get('detector_error')}")
        det = video["detector"]
        tl = np.asarray(det["timeline"])
        check(tl.shape == (FRAMES_MAIN,) and np.isfinite(tl).all()
              and tl.min() >= 0.0 and tl.max() <= 1.0,
              f"detector timeline: shape {tl.shape}")
        shipped = scoring._shipped_ckpt("vit", "full")
        check(shipped is not None
              and det["weights"] == f"{shipped}+T1.00",
              f"weights {det['weights']}, not the shipped detector_full")
        check(launches["mha"] == VIT_DEPTH,
              f"mha launched {launches['mha']} times, expected {VIT_DEPTH} "
              f"(depth x one {VIT_BUCKET}-frame bucket)")
        by_kernel = dict(_kernel_modules()["mha"].VARIANT_LAUNCHES)
        check(by_kernel == {"mma": VIT_DEPTH, "general": 0},
              f"the detector path's mha launches by kernel: {by_kernel}")
        check(launches["solve_iteration"] == 0, "fused iteration ran")
        check(video["timeline"] is video["timeline_ai"], "timeline alias")
        schema.validate(env)
        log(f"detector path envelope: label {env['result']['label']} "
            f"ai_score {env['result']['ai_score']} P(ai) mean "
            f"{tl.mean():.4f} min {tl.min():.4f} max {tl.max():.4f} "
            f"({first_s:.2f} s, first call)")

        # outside the analyzer's except: the scoring call itself
        def best_of(fn, n):
            best = None
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                best = min(best or 1e9, time.perf_counter() - t0)
            return best, out

        t_full, direct = best_of(
            lambda: scoring.detector_timeline(frames, device=cuda), 2)
        check(np.allclose(direct["timeline"], tl, atol=1e-6),
              "the direct scoring call disagrees with the analyzer's")
        t_resize, resized = best_of(
            lambda: scoring.resize_frames(frames, cfg.image_size), 2)
        t_score, _ = best_of(
            lambda: scoring.detector_timeline_resized(resized, device=cuda),
            3)
        t_an, _ = best_of(lambda: video_an.analyze_batch(fb, device=cuda), 2)
        log(f"detector steady: detector_timeline {t_full:.3f} s "
            f"({FRAMES_MAIN / t_full:.2f} frames/s, host resize included: "
            f"resize alone {t_resize:.3f} s), resized frames → timeline "
            f"{t_score:.3f} s ({FRAMES_MAIN / t_score:.2f} frames/s), "
            f"analyze_batch with the detector {t_an:.3f} s "
            f"({FRAMES_MAIN / t_an:.2f} frames/s), threads {os.cpu_count()}")

        busy = {}
        for fused in ("1", "0"):
            _set_env(AVD_ATTN_FUSED=fused)
            scoring.detector_timeline_resized(resized, device=cuda)  # warm
            busy[fused], n_dev, avgs = device_profile(
                lambda: scoring.detector_timeline_resized(resized,
                                                          device=cuda))
            os.makedirs("chiprun_out", exist_ok=True)
            path = os.path.join("chiprun_out",
                                f"torch_profile_detector_fused{fused}.txt")
            with open(path, "w") as f:
                f.write(avgs.table(sort_by="self_device_time_total",
                                   row_limit=30))
            mha_ms, mha_n = _kernel_ms(avgs, "::mha_")
            check(mha_n == (VIT_DEPTH if fused == "1" else 0),
                  f"AVD_ATTN_FUSED={fused}: {mha_n} mha launches profiled")
            h2d_ms, h2d_n = _kernel_ms(avgs, "Memcpy HtoD")
            check(h2d_n == 1, f"AVD_ATTN_FUSED={fused}: {h2d_n} host→device "
                  "copies in the scoring call's trace, expected the batch's")
            log(f"detector profile AVD_ATTN_FUSED={fused}: device busy "
                f"{busy[fused]:.3f} ms per scoring call ({VIT_BUCKET}-frame "
                f"bucket), {n_dev} device kernels and copies, of which the "
                f"batch's host→device copy {h2d_ms:.3f} ms, kernels "
                f"{busy[fused] - h2d_ms:.3f} ms, the mha kernel {mha_ms:.3f} "
                f"ms in {mha_n} launches; table in {path}")
        _set_env(AVD_ATTN_FUSED="1")

        # card against CPU on a short clip: logits, not probabilities
        short = scoring._prep_frames(pan_frames(4, 360, 640, seed=1),
                                     cfg.image_size)
        logits = {}
        for dev in ("cuda", "cpu"):
            c, params, _, _ = scoring._bundle(dev)
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits[dev] = detector.forward(
                    params, torch.from_numpy(short).to(dev), c)[:, 0] \
                    .float().cpu()
            log(f"detector card vs cpu: {dev} "
                f"{time.perf_counter() - t0:.2f} s")
        err, ok = _close(logits["cuda"], logits["cpu"], 2e-2, 2e-2)
        log(f"detector card vs cpu: logits {logits['cuda'].tolist()} vs "
            f"{logits['cpu'].tolist()}, max |Δ| {err:.3g}")
        check(ok, f"card and CPU logits differ by {err}")
    finally:
        _set_env(AVD_DETECTOR=None, AVD_ATTN_FUSED=None,
                 AVD_DETECTOR_PRESET=None)
    return launches


def phase_fused_iter(frames):
    """The video path with AVD_PALLAS_ITER=1 against the unfused run."""
    import torch
    from avd_tpu_torch import pipeline
    from avd_tpu_torch.ingest import video_reader
    from avd_tpu_torch.ops import video_features
    cuda = torch.device(DEV)
    clip = frames[:FRAMES_FUSED]
    fps = 30.0
    dur = FRAMES_FUSED * video_reader.sampling_step(fps) / fps
    fb = video_reader.FrameBatch(clip, FRAMES_FUSED, fps, W_MAIN, H_MAIN,
                                 dur)
    wav = speech_like(3.0, seed=6)
    meta = clip_meta(W_MAIN, H_MAIN, fps, dur)
    windows = -(-FRAMES_FUSED // video_features._DEFAULT_CHUNK)
    want = windows * len(LEVELS) * ROUNDS
    env, launches, dev_s, per_window = {}, {}, {}, {}
    _, prepped = _device_pass(clip)
    try:
        for fused in ("1", "0"):
            _set_env(AVD_PALLAS_ITER=fused)
            _reset_counters()
            env[fused] = pipeline.analyze_decoded(fb, wav, 16000, dict(meta),
                                                  device=cuda)
            launches[fused] = _counters()
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                _device_pass(clip, prepped)
                times.append(time.perf_counter() - t0)
            dev_s[fused] = min(times)
            # one full 49-frame window under the profiler
            one = clip[:video_features._DEFAULT_CHUNK]
            busy, n_dev, _ = device_profile(
                lambda: _device_pass(one, prepped[:1]))
            per_window[fused] = (busy, n_dev)
    finally:
        _set_env(AVD_PALLAS_ITER=None)
    log(f"fused iteration launches: on {launches['1']}, off {launches['0']}")
    on, off = launches["1"], launches["0"]
    check(on["solve_iteration"] == want,
          f"flow_iter launched {on['solve_iteration']} times, expected "
          f"{want} ({windows} windows x 4 levels x 3 rounds)")
    check(on["warp_bilinear"] == 0 and on["box_blur_solve"] == 0,
          "the fused path launched the warp or the blur+solve kernel")
    check(off["solve_iteration"] == 0 and off["warp_bilinear"] == want
          and off["box_blur_solve"] == want, f"unfused launches {off}")
    s_on = env["1"]["video"]["summary"]
    s_off = env["0"]["video"]["summary"]
    rel_m = abs(s_on["flow_mean"] - s_off["flow_mean"]) / s_off["flow_mean"]
    rel_v = abs(s_on["flow_var"] - s_off["flow_var"]) / \
        max(s_off["flow_var"], 1e-12)
    d_ai = abs(np.mean(env["1"]["timeline_binned"])
               - np.mean(env["0"]["timeline_binned"]))
    log(f"fused iteration vs unfused on the card: flow_mean "
        f"{s_on['flow_mean']:.7f} vs {s_off['flow_mean']:.7f} (rel "
        f"{rel_m:.3g}), flow_var rel {rel_v:.3g}, |Δai_score| {d_ai:.3g}")
    check(rel_m <= 1e-3, f"flow_mean differs by {rel_m} relative")
    check(rel_v <= 1e-2 or abs(s_on["flow_var"] - s_off["flow_var"]) <= 1e-4,
          f"flow_var differs by {rel_v} relative")
    check(d_ai <= 1e-3, f"ai_score differs by {d_ai}")
    check(env["1"]["result"]["label"] == env["0"]["result"]["label"],
          "labels differ")
    log(f"fused iteration device pass ({FRAMES_FUSED} frames, prep "
        f"precomputed): fused {dev_s['1']:.4f} s, unfused "
        f"{dev_s['0']:.4f} s; one 49-frame window: fused "
        f"{per_window['1'][1]} device kernels and copies, "
        f"{per_window['1'][0]:.3f} ms busy; unfused {per_window['0'][1]}, "
        f"{per_window['0'][0]:.3f} ms busy")
    return on


def _equal_planes(a, b):
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def phase_host_runtime(frames, fb, busy_ms):
    """The C++ host prep against its numpy plain version, bit for bit, and
    both timed on the 145 frames; then the main path's steady state, warm:
    ``analyze_batch``, its host prep and device pass, the card's idle share
    against phase 7's device-busy time, and a host profile of one call."""
    import cProfile
    import pstats

    import torch
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.ops import host_prep
    cases = {f"{FRAMES_MAIN} x {H_MAIN}x{W_MAIN}": frames}
    for i, (h, w) in enumerate([(720, 1280), (360, 640), (33, 47)]):
        cases[f"8 x {h}x{w}"] = pan_frames(8, h, w, seed=10 + i)
    times = {}
    for name, f in cases.items():
        t0 = time.perf_counter()
        nat = host_prep.host_prep(f)
        t1 = time.perf_counter()
        plain = host_prep.host_prep_plain(f)
        t2 = time.perf_counter()
        check(_equal_planes(nat, plain),
              f"host prep {name}: native and plain outputs differ")
        times[name] = (t1 - t0, t2 - t1)
        log(f"host runtime {name}: native equals plain on all three "
            f"outputs (native {t1 - t0:.3f} s, plain {t2 - t1:.3f} s)")
    best = []
    for _ in range(2):
        t0 = time.perf_counter()
        host_prep.host_prep(frames)
        best.append(time.perf_counter() - t0)
    nat_s, plain_s = min(best + [times[next(iter(cases))][0]]), \
        times[next(iter(cases))][1]

    cuda = torch.device(DEV)
    e2e = []
    for _ in range(7):
        t0 = time.perf_counter()
        video_an.analyze_batch(fb, device=cuda)
        e2e.append(time.perf_counter() - t0)
    dev = []
    _, prepped = _device_pass(frames)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _device_pass(frames, prepped)
        dev.append(time.perf_counter() - t0)
    e2e_s = min(e2e)
    idle = 1 - busy_ms / 1e3 / e2e_s
    log(f"host runtime: host prep of the {FRAMES_MAIN} 1080p frames native "
        f"{nat_s:.3f} s, numpy plain {plain_s:.3f} s ({plain_s / nat_s:.1f}x)"
        f", threads {os.cpu_count()}")
    log(f"host runtime: main path steady (warm) analyze_batch {e2e_s:.3f} s "
        f"= {FRAMES_MAIN / e2e_s:.2f} frames/s (median "
        f"{statistics.median(e2e):.3f} s; runs "
        f"{', '.join(f'{t:.3f}' for t in e2e)}), device pass (prep "
        f"precomputed) {min(dev):.3f} s; card idle share {idle:.4f} "
        f"({busy_ms:.3f} ms busy, phase 7)")

    # where the host's time goes in one warm call
    prof = cProfile.Profile()
    prof.enable()
    video_an.analyze_batch(fb, device=cuda)
    prof.disable()
    path = os.path.join("chiprun_out", "analyze_batch_cprofile.txt")
    with open(path, "w") as f:
        pstats.Stats(prof, stream=f).sort_stats("tottime").print_stats(40)
    top = sorted(pstats.Stats(prof).stats.items(),
                 key=lambda kv: -kv[1][2])[:6]
    log("host runtime: one analyze_batch, host time by function (tottime): "
        + "; ".join(f"{os.path.basename(k[0])}:{k[2]} {v[2]:.4f} s "
                    f"in {v[1]} calls" for k, v in top) + f"; all in {path}")


def phase_bf16_kernels(gen, warp32, blur32):
    """The bf16 instances of warp and blur+solve against their plain
    versions at the full window's levels, timed beside the float32
    instances of phases 3 and 4."""
    import torch
    from avd_tpu_torch.ops import flow as flow_ops
    from avd_tpu_torch.ops.kernels import blur_solve, warp
    f32_warp = {r[0]: r for r in warp32}
    f32_blur = {r[0]: r for r in blur32}
    wrows, brows, werr, berr = [], [], 0.0, 0.0
    for h in LEVELS:
        src32, cases = _warp_cases(h, gen)
        src = src32.bfloat16()
        for name, fl in cases.items():
            out = warp.warp_bilinear(src, fl)
            ref = warp.warp_bilinear_plain(src, fl)
            inb = flow_ops._in_bounds(fl)[:, None].expand_as(out)
            err = float((out - ref)[inb].abs().max()) if inb.any() else 0.0
            check(err <= 1e-5, f"warp bf16 {h} {name}: in-bounds |Δ| {err}")
            check(not bool(out[~inb].any()),
                  f"warp bf16 {h} {name}: out-of-bounds pixels not 0")
            check(out.dtype == torch.float32, "warp bf16 output type")
            werr = max(werr, err)
        fl = cases["smooth"]
        n_inb = int(flow_ops._in_bounds(fl).sum())
        ms = time_ms(lambda: warp.warp_bilinear(src, fl))
        plain = time_ms(lambda: warp.warp_bilinear_plain(src, fl))
        px = PAIRS * h * h
        bnd, by = bound_ms(px * (5 * 2 + 2 * 4 + 5 * 4),
                           px * 10 + n_inb * 35)
        wrows.append((h, ms, plain, None, bnd, by))
        log(f"warp bf16 [{PAIRS},5,{h},{h}]: kernel {ms:.4f} ms (float32 "
            f"{f32_warp[h][1]:.4f}), plain {plain:.4f} ms, bound {bnd:.4f} "
            f"ms ({by}; float32 {f32_warp[h][4]:.4f}); max in-bounds |Δ| "
            f"{werr:.3g}")
    for h in LEVELS:
        m = _psd_m(gen, PAIRS, h, h).bfloat16()
        out = blur_solve.box_blur_solve(m)
        ref = blur_solve.box_blur_solve_plain(m)
        err, ok = _close(out, ref, 2e-4, 1e-3)
        check(ok and torch.equal(out, ref),
              f"blur+solve bf16 [{PAIRS},5,{h},{h}]: |Δ| {err}, not equal to "
              "the plain version")
        berr = max(berr, err)
        ms = time_ms(lambda: blur_solve.box_blur_solve(m))
        plain = time_ms(lambda: blur_solve.box_blur_solve_plain(m))
        px = PAIRS * h * h
        bnd, by = bound_ms(px * (5 * 2 + 2 * 4), px * 170)
        brows.append((h, ms, plain, None, bnd, by))
        log(f"blur_solve bf16 [{PAIRS},5,{h},{h}]: kernel {ms:.4f} ms "
            f"(float32 {f32_blur[h][1]:.4f}), plain {plain:.4f} ms, bound "
            f"{bnd:.4f} ms ({by}; float32 {f32_blur[h][4]:.4f}); max |Δ| "
            f"{err:.3g}")
    for line in ptxas_lines("blur_solve", "blur_solve_kernel"):
        log(f"ptxas: {line}")
    for line in ptxas_lines("warp", "warp_bilinear_kernel"):
        log(f"ptxas: {line}")
    return wrows, werr, brows, berr


def _flow_pairs_of(feats):
    return np.asarray(feats["flow_means"]), np.asarray(feats["flow_vars"])


def phase_modes(frames):
    """AVD_FLOW_BF16, AVD_PREP=device, AVD_CHANGE_GATE and
    AVD_FREQ_FORENSICS on the 61-frame clip, each against the default."""
    import torch
    from avd_tpu_torch import pipeline
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.ingest import video_reader
    from avd_tpu_torch.ops import forensic_freq, video_features
    cuda = torch.device(DEV)
    clip = frames[:FRAMES_FUSED]
    fps = 30.0
    dur = FRAMES_FUSED * video_reader.sampling_step(fps) / fps
    fb = video_reader.FrameBatch(clip, FRAMES_FUSED, fps, W_MAIN, H_MAIN,
                                 dur)
    wav = speech_like(3.0, seed=6)
    meta = clip_meta(W_MAIN, H_MAIN, fps, dur)
    want = -(-FRAMES_FUSED // video_features._DEFAULT_CHUNK) * \
        len(LEVELS) * ROUNDS

    def drive(**env):
        """The envelope with ``env`` set, the launches of that run, and the
        best of two steady ``analyze_batch`` calls."""
        _set_env(**env)
        _reset_counters()
        out = pipeline.analyze_decoded(fb, wav, 16000, dict(meta),
                                       device=cuda)
        launches = _counters()
        best = 1e9
        for _ in range(2):
            t0 = time.perf_counter()
            video_an.analyze_batch(fb, device=cuda)
            best = min(best, time.perf_counter() - t0)
        return out, launches, best

    def ai(env):
        return env["result"]["ai_score"], env["result"]["label"]

    try:
        base, base_n, base_s = drive()
        f32 = video_features.compute_features(clip, device=cuda)

        bf, bf_n, bf_s = drive(AVD_FLOW_BF16="1")
        log(f"mode AVD_FLOW_BF16=1 launches: {bf_n}")
        for name in ("warp_bilinear", "box_blur_solve"):
            check(bf_n[f"{name}_bf16"] == want and bf_n[name] == want,
                  f"AVD_FLOW_BF16=1: {name} launched {bf_n[name]} times, "
                  f"{bf_n[f'{name}_bf16']} on bf16; expected {want}, all bf16")
        bf_feats = video_features.compute_features(clip, device=cuda)
        (m32, v32), (m16, v16) = _flow_pairs_of(f32), _flow_pairs_of(bf_feats)
        dm, dv = float(np.abs(m16 - m32).max()), float(np.abs(v16 - v32).max())
        log(f"mode AVD_FLOW_BF16=1 against float32 over {m32.size} pairs: "
            f"max |Δ flow mean| {dm:.3g}, max |Δ flow var| {dv:.3g}, "
            f"ai_score {ai(bf)} vs {ai(base)}; analyze_batch {bf_s:.3f} s "
            f"(float32 {base_s:.3f} s)")
        check(dm < 0.05 and dv < 0.08 and
              np.array_equal(v16 > 0.5, v32 > 0.5),
              "AVD_FLOW_BF16=1 outside the study bound of the float32 flow")

        dev, dev_n, dev_s = drive(AVD_FLOW_BF16=None, AVD_PREP="device")
        d_ai = abs(ai(dev)[0] - ai(base)[0])
        log(f"mode AVD_PREP=device: ai_score {ai(dev)} vs host prep "
            f"{ai(base)} (|Δ| {d_ai:.3g}), flow_mean "
            f"{dev['video']['summary']['flow_mean']:.6f} vs "
            f"{base['video']['summary']['flow_mean']:.6f}; launches {dev_n}; "
            f"analyze_batch {dev_s:.3f} s (host prep {base_s:.3f} s)")
        check(d_ai <= 1e-3 and ai(dev)[1] == ai(base)[1],
              f"AVD_PREP=device: ai_score differs by {d_ai} or the label")
        check(dev_n["warp_bilinear"] == want
              and dev_n["box_blur_solve"] == want,
              f"AVD_PREP=device launches {dev_n}")

        # a 20-frame static run in front of the moving frames
        gclip = np.concatenate([np.repeat(clip[:1], 20, axis=0),
                                clip[:FRAMES_FUSED - 20]])
        _set_env(AVD_PREP=None)
        ungated = video_features.compute_features(gclip, device=cuda)
        _set_env(AVD_CHANGE_GATE="1")
        _reset_counters()
        gated = video_features.compute_features(gclip, device=cuda)
        g_n = _counters()
        (mu, vu), (mg, vg) = _flow_pairs_of(ungated), _flow_pairs_of(gated)
        moving = mg != 0.0
        skipped = gated["skipped_pairs"]
        rel = float(np.max(np.abs(mg[moving] - mu[moving])
                           / np.abs(mu[moving]))) if moving.any() else 0.0
        log(f"mode AVD_CHANGE_GATE=1: {skipped} of {mg.size} pairs skipped, "
            f"{int(moving.sum())} moving pairs within rel {rel:.3g} of the "
            f"ungated flow mean; dup {gated['dup']} vs {ungated['dup']}; "
            f"launches {g_n}")
        check(skipped >= 19 and int(moving.sum()) == mg.size - skipped,
              f"AVD_CHANGE_GATE=1 skipped {skipped} pairs")
        check(rel <= 1e-3 and np.allclose(vg[moving], vu[moving], rtol=1e-3,
                                           atol=1e-5),
              f"AVD_CHANGE_GATE=1: moving pairs differ by {rel} relative")
        check(gated["dup"] == ungated["dup"], "gated duplicates differ")
        check(g_n["warp_bilinear"] > 0, "the gated flow ran no warp kernel")

        _set_env(AVD_CHANGE_GATE=None, AVD_FREQ_FORENSICS="1")
        t0 = time.perf_counter()
        freq = video_an.analyze_batch(fb, device=cuda)["summary"]["freq"]
        freq_s = time.perf_counter() - t0
        gray = video_features._to_gray_host(clip)
        t0 = time.perf_counter()
        on_cpu = forensic_freq.summarize(gray, device="cpu")
        cpu_s = time.perf_counter() - t0
        worst = max(abs(freq[k] - on_cpu[k]) / max(abs(on_cpu[k]), 1e-12)
                    for k in on_cpu)
        log(f"mode AVD_FREQ_FORENSICS=1: {json.dumps(freq)}; card against "
            f"CPU max rel {worst:.3g} (analyze_batch with it {freq_s:.3f} s, "
            f"the statistics on the CPU {cpu_s:.3f} s)")
        check(set(freq) == set(on_cpu) and worst <= 1e-4,
              f"AVD_FREQ_FORENSICS=1: card and CPU differ by {worst}")
        check(all(np.isfinite(v) for v in freq.values()), "freq not finite")
    finally:
        _set_env(AVD_FLOW_BF16=None, AVD_PREP=None, AVD_CHANGE_GATE=None,
                 AVD_FREQ_FORENSICS=None)
    return bf_n


# ---------------------------------------------------------------------------
# the file path
# ---------------------------------------------------------------------------

MEDIA_DIR = os.path.join("build", "chip_smoke_media")
CORPUS_MP4 = os.path.join("tests", "data", "corpus_v1", "ai",
                          "clip_00_crf23.mp4")
FRESH_TREE = os.path.join("build", "fresh_tree")
SLAB = 64                    # AVD_DETECTOR_SLAB of the streaming phase
CHUNK_STREAM = 32            # sampled frames per decode chunk (video.py)


def write_wav(path, wav, sr=16000):
    """Mono 16-bit PCM WAV (the waveform is on the 1/32768 grid)."""
    import wave
    pcm = np.clip(np.round(wav * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return path


def decode_routes():
    """What this host can decode with, in avd_tpu's route order."""
    import importlib.util
    import shutil
    from avd_tpu_torch.native import decode
    lib = decode.lib()
    return {"ffprobe": shutil.which("ffprobe"),
            "ffmpeg": shutil.which("ffmpeg"),
            "exiftool": shutil.which("exiftool"),
            "libav": lib is not None, "libav_why": decode.unavailable(),
            "cv2": importlib.util.find_spec("cv2") is not None}


def phase_wav_path():
    """analyze_path on a WAV the script writes: the audio analyzer on the
    card against the same call on the CPU."""
    import torch
    from avd_tpu_torch import pipeline, schema
    from avd_tpu_torch.ops import audio_features
    routes = decode_routes()
    log(f"decode routes: ffprobe {routes['ffprobe']}, ffmpeg "
        f"{routes['ffmpeg']}, exiftool {routes['exiftool']}, cv2 "
        f"{'present' if routes['cv2'] else 'absent'}, libav decode "
        f"{'built' if routes['libav'] else 'unavailable'}")
    if not routes["libav"]:
        why = [x for x in routes["libav_why"].splitlines() if "error" in x]
        log(f"libav decode unavailable because: "
            f"{(why or routes['libav_why'].splitlines())[0][:300]}")
    if routes["cv2"]:
        import cv2
        io = [x.strip() for x in cv2.getBuildInformation().splitlines()
              if x.strip().startswith(("FFMPEG:", "GStreamer:", "avcodec:",
                                       "avformat:"))]
        log(f"cv2 {cv2.__version__}, video I/O: {io}")
    os.makedirs(MEDIA_DIR, exist_ok=True)
    wav_path = write_wav(os.path.join(MEDIA_DIR, "speech_like_5s.wav"),
                         speech_like(5.0))
    seen = []
    real = audio_features.analyze_waveform

    def spy(wav, sr, device=None):
        seen.append(torch.device(device).type)
        return real(wav, sr, device=device)

    out, secs = {}, {}
    with mock.patch.object(audio_features, "analyze_waveform", spy):
        for dev in (DEV, "cpu"):
            t0 = time.perf_counter()
            out[dev] = pipeline.analyze_path(wav_path, device=dev)
            secs[dev] = time.perf_counter() - t0
    check(seen == [DEV, "cpu"], f"the audio block ran on {seen}")
    g, c = out[DEV], out["cpu"]
    schema.validate(g)
    check("audio_error" not in g["hints"], f"audio_error {g['hints']}")
    check("error" not in g["audio"]["flags_audio"],
          f"audio fell back: {g['audio']['flags_audio']}")
    check(g["meta"]["duration"] == 5.0 and g["meta"]["acodec"] == "pcm_s16le",
          f"WAV meta {g['meta']}")
    # the video block avd_tpu gives for a WAV: with no cv2 the readers'
    # import fails (ModuleNotFoundError); with cv2 the container does not
    # open (the empty result)
    if routes["cv2"]:
        want = {"timeline": [], "summary": {}, "timeline_ai": []}
        check("video_error" not in g["hints"], f"video_error {g['hints']}")
    else:
        want = {"timeline": [0.5] * 5,
                "summary": {"error": "ModuleNotFoundError"},
                "timeline_ai": [0.5] * 5}
        check(g["hints"].get("video_error") == "ModuleNotFoundError",
              f"video_error {g['hints'].get('video_error')}")
    check(g["video"] == want, f"WAV video block {g['video']}")
    d_tl = float(np.max(np.abs(np.subtract(g["audio"]["timeline"],
                                           c["audio"]["timeline"]))))
    d_ai = abs(np.mean(g["timeline_binned"]) - np.mean(c["timeline_binned"]))
    check(len(g["audio"]["timeline"]) == len(c["audio"]["timeline"]) == 5
          and d_tl <= 2e-2, f"audio timeline card vs CPU |Δ| {d_tl}")
    check(d_ai <= 1e-3 and g["result"]["label"] == c["result"]["label"],
          f"ai_score card vs CPU |Δ| {d_ai}")
    for key in ("meta", "hints", "video"):
        check(g[key] == c[key], f"{key} differs card vs CPU")
    log(f"analyze_path WAV: audio on {seen[0]}, label "
        f"{g['result']['label']} ai_score {g['result']['ai_score']}, audio "
        f"timeline card vs CPU max |Δ| {d_tl:.3g}, |Δai_score| {d_ai:.3g}; "
        f"video block {g['video']['summary']} as avd_tpu gives it here; "
        f"wall {secs[DEV]:.3f} s on the card (first call), "
        f"{secs['cpu']:.3f} s on the CPU")
    return wav_path, routes, secs[DEV]


def _no_decoder():
    """The decode routes patched away in this process, as on a host with
    none: no ffprobe, ffmpeg or exiftool, no libav* library, no cv2."""
    import contextlib
    import shutil
    from avd_tpu_torch.native import decode
    which = shutil.which
    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(
        shutil, "which", lambda name, *a, **k: None
        if name in ("ffprobe", "ffmpeg", "exiftool") else which(name, *a,
                                                                **k)))
    stack.enter_context(mock.patch.object(decode, "lib", lambda: None))
    had, saved = "cv2" in sys.modules, sys.modules.get("cv2")
    sys.modules["cv2"] = None  # import cv2 raises ModuleNotFoundError
    stack.callback(lambda: sys.modules.__setitem__("cv2", saved) if had
                   else sys.modules.pop("cv2", None))
    return stack


def phase_mp4_path(routes, wav_path):
    """analyze_path on a corpus mp4 through the routes this host has, card
    against CPU; then the mp4 and the WAV with the decode routes patched
    away: the envelope avd_tpu gives on a host with no decoder."""
    from avd_tpu_torch import pipeline, schema
    t0 = time.perf_counter()
    env = pipeline.analyze_path(CORPUS_MP4, device=DEV)
    secs = time.perf_counter() - t0
    cpu = pipeline.analyze_path(CORPUS_MP4, device="cpu")
    schema.validate(env)
    r = routes
    log(f"analyze_path mp4 routes taken: probe "
        f"{'ffprobe' if r['ffprobe'] else 'libav' if r['libav'] else 'cv2' if r['cv2'] else 'none (empty meta)'}"
        f"; audio {'ffmpeg' if r['ffmpeg'] else 'libav' if r['libav'] else 'none (ffmpeg_convert_failed)'}"
        f"; video {'libav GOP-skip sampler' if r['libav'] else 'cv2 walk' if r['cv2'] else 'none (ModuleNotFoundError)'}"
        f"; forensic {'exiftool' if r['exiftool'] else 'BMFF scan'}")
    check(env["forensic"] == {"c2pa": {"present": False}, "exif_quick": {}},
          f"forensic block {env.get('forensic')}")
    for key in ("meta", "hints", "audio", "forensic"):
        check(env[key] == cpu[key], f"mp4 {key} differs card vs CPU")
    d_ai = abs(np.mean(env["timeline_binned"])
               - np.mean(cpu["timeline_binned"]))
    check(d_ai <= 1e-3 and env["result"]["label"] == cpu["result"]["label"],
          f"mp4 ai_score card vs CPU |Δ| {d_ai}")
    decoded = "video_error" not in env["hints"]
    check(decoded == (routes["libav"] or routes["cv2"]),
          f"mp4 video_error {env['hints'].get('video_error')} with routes "
          f"libav {routes['libav']}, cv2 {routes['cv2']}")
    check("audio_error" not in env["hints"], "mp4 audio_error")
    log(f"analyze_path mp4: frames decoded: "
        f"{'yes, ' + str(env['meta']['width']) + 'x' + str(env['meta']['height']) + ' by ' + ('libav' if routes['libav'] else 'cv2') if decoded else 'no (' + env['hints']['video_error'] + ')'}; "
        f"label {env['result']['label']} ai_score "
        f"{env['result']['ai_score']}, card vs CPU |Δai_score| {d_ai:.3g}; "
        f"audio {env['audio']['flags_audio']}; wall {secs:.3f} s")

    with _no_decoder():
        bare = {p: pipeline.analyze_path(p, device=DEV)
                for p in (CORPUS_MP4, wav_path)}
    mp4, wav = bare[CORPUS_MP4], bare[wav_path]
    for e in (mp4, wav):
        schema.validate(e)
        check(e["hints"].get("video_error") == "ModuleNotFoundError",
              f"no-decoder video_error {e['hints'].get('video_error')}")
    check(mp4["video"] == {"timeline": [0.5],
                           "summary": {"error": "ModuleNotFoundError"},
                           "timeline_ai": [0.5]},
          f"no-decoder mp4 video block {mp4['video']}")
    check(mp4["audio"]["flags_audio"] == {"error": "ffmpeg_convert_failed"},
          f"no-decoder mp4 audio block {mp4['audio']}")
    check(mp4["meta"]["width"] == 0 and mp4["meta"]["duration"] == 0.0
          and mp4["meta"]["format_name"] is None,
          f"no-decoder mp4 meta {mp4['meta']}")
    check(mp4["forensic"] == env["forensic"], "no-decoder forensic block")
    check(wav["video"]["timeline"] == [0.5] * 5
          and "error" not in wav["audio"]["flags_audio"],
          f"no-decoder WAV {wav['video']} {wav['audio']['flags_audio']}")
    log(f"analyze_path with the decode routes patched away (no ffprobe, "
        f"ffmpeg, exiftool, libav or cv2; no frame decoded): mp4 video "
        f"{mp4['video']}, audio {mp4['audio']['flags_audio']}, meta width "
        f"{mp4['meta']['width']}, forensic {mp4['forensic']} (BMFF scan); "
        f"WAV audio analyzed on the card, video_error "
        f"{wav['hints']['video_error']}")
    return secs


def phase_mp4_1080p(frames, fps=2.0):
    """A 1080p mp4 written with cv2 (mp4v) from the pan frames at 2 fps
    (step 1: every frame sampled) through analyze_path on the card with
    the detector: decode by the cv2 walk, the streaming analyzer, the
    shipped weights; held to the batch path (AVD_STREAM=0)."""
    import cv2
    import torch
    from avd_tpu_torch import pipeline, schema
    path = os.path.join(MEDIA_DIR, "pan_1080p_2fps.mp4")
    t0 = time.perf_counter()
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                         (W_MAIN, H_MAIN))
    if not vw.isOpened():
        log("mp4 1080p: cv2 cannot write mp4v here; phase skipped")
        return None
    for f in frames:
        vw.write(f)
    vw.release()
    log(f"mp4 1080p: wrote {frames.shape[0]} frames with cv2 in "
        f"{time.perf_counter() - t0:.2f} s ({os.path.getsize(path)} bytes)")
    cuda = torch.device(DEV)
    out, secs, launches = {}, {}, {}
    _set_env(AVD_DETECTOR="1", AVD_ATTN_FUSED="1", AVD_DETECTOR_PRESET=None,
             AVD_DETECTOR_CKPT=None, AVD_DETECTOR_BLEND=None,
             AVD_DETECTOR_SLAB=None)
    try:
        for stream in ("1", "0", "1", "0"):
            _set_env(AVD_STREAM=stream)
            _reset_counters()
            t0 = time.perf_counter()
            res = pipeline.analyze_path(path, device=cuda)
            secs.setdefault(stream, []).append(time.perf_counter() - t0)
            launches.setdefault(stream, _counters())
            out[stream] = res
    finally:
        _set_env(AVD_DETECTOR=None, AVD_ATTN_FUSED=None, AVD_STREAM=None)
    st, ba = out["1"], out["0"]
    for r in (st, ba):
        schema.validate(r)
        for key in ("video_error", "audio_error"):
            check(key not in r["hints"], f"mp4 1080p {key}: "
                  f"{r['hints'].get(key)}")
        check("detector_error" not in r["video"],
              f"mp4 1080p detector_error {r['video'].get('detector_error')}")
    n = frames.shape[0]
    check(st["meta"]["width"] == W_MAIN and st["meta"]["height"] == H_MAIN,
          f"mp4 1080p meta {st['meta']}")
    check(len(st["video"]["detector"]["timeline"]) == n,
          f"{len(st['video']['detector']['timeline'])} frames scored")
    check(st["video"]["summary"]["dup_density"]
          == ba["video"]["summary"]["dup_density"], "dup_density")
    d_tl = float(np.max(np.abs(np.subtract(st["video"]["timeline"],
                                           ba["video"]["timeline"]))))
    d_det = float(np.max(np.abs(np.subtract(
        st["video"]["detector"]["timeline"],
        ba["video"]["detector"]["timeline"]))))
    check(d_tl <= 1e-6 and d_det <= 2e-2,
          f"mp4 1080p stream vs batch |Δ| {d_tl} / detector {d_det}")
    for mode, ls in launches.items():
        check(ls["warp_bilinear"] > 0 and ls["box_blur_solve"] > 0
              and ls["mha"] > 0, f"mp4 1080p AVD_STREAM={mode} launches {ls}")
    log(f"mp4 1080p through analyze_path on the card (cv2 decode of {n} "
        f"frames, detector on): streaming {min(secs['1']):.3f} s "
        f"(runs {', '.join(f'{t:.3f}' for t in secs['1'])}; "
        f"{n / min(secs['1']):.2f} frames/s), batch {min(secs['0']):.3f} s "
        f"(runs {', '.join(f'{t:.3f}' for t in secs['0'])}); launches "
        f"stream {launches['1']}, batch {launches['0']}; heuristic "
        f"timeline max |Δ| {d_tl:.3g}, detector max |Δ| {d_det:.3g}; label "
        f"{st['result']['label']} ai_score {st['result']['ai_score']}")
    return min(secs["1"])


# the detector in phase 16b: off; on (the default slab of 256 frames: the
# 145-frame clip is scored after the stream); on in slabs of 64 (scored on
# the streaming thread mid-stream, beside the dispatch thread's enqueue)
STREAM_DETECTOR = {"off": {}, "on": {"AVD_DETECTOR": "1"},
                   "on, slabs of 64": {"AVD_DETECTOR": "1",
                                       "AVD_DETECTOR_SLAB": str(SLAB)}}


def phase_dispatch_streaming(dispatch):
    """The streaming analyzer as serving runs it (``analyzers.video.
    analyze``: the 1080p mp4 decoded in chunks of 32, the windows through
    the dispatch stage) in both dispatch orders, interleaved, for each
    detector setting of ``STREAM_DETECTOR``: best and median s and each
    window's enqueue ms.  The batch path's restart is patched to fail, so
    every run streamed; the orders' heuristic summaries are bit-equal,
    their detector timelines within 2e-2; warp and blur+solve launch 48
    times a run (``chiprun_out/dispatch.json``)."""
    import torch
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.ingest import probe
    cuda = torch.device(DEV)
    meta = probe.probe_basic_meta(MP4_1080P)
    names = ("AVD_DETECTOR", "AVD_DETECTOR_SLAB", "AVD_DETECTOR_PRESET",
             "AVD_DETECTOR_CKPT", "AVD_DETECTOR_BLEND", "AVD_ATTN_FUSED",
             "AVD_STREAM")

    def no_restart(*_, **__):
        raise PhaseError("the streaming analyzer restarted on the batch path")

    rows = {}
    try:
        for mode, env in STREAM_DETECTOR.items():
            _set_env(**{**dict.fromkeys(names), **env})
            res = {}
            with mock.patch.object(video_an, "analyze_batch", no_restart):
                video_an.analyze(MP4_1080P, dict(meta), device=cuda)  # warm
                for r in range(STREAM_ROUNDS):
                    k = r % len(DISPATCH_ORDERS)
                    for order in DISPATCH_ORDERS[k:] + DISPATCH_ORDERS[:k]:
                        row = rows.setdefault(mode, {}).setdefault(
                            order, {"s": [], "enqueue_ms": []})
                        _reset_counters()
                        with dispatch_order(order), \
                                timed_enqueues(row["enqueue_ms"]):
                            torch.cuda.synchronize()
                            t0 = time.perf_counter()
                            out = video_an.analyze(MP4_1080P, dict(meta),
                                                   device=cuda)
                            torch.cuda.synchronize()
                            row["s"].append(time.perf_counter() - t0)
                        n = _counters()
                        check(n["warp_bilinear"] == n["box_blur_solve"] == 48,
                              f"streaming {mode} {order}: launches {n}")
                        check("detector_error" not in out,
                              f"streaming {mode} {order}: detector_error "
                              f"{out.get('detector_error')}")
                        res.setdefault(order, out)
            a, b = res["inline"], res["pool"]
            check(a["summary"] == b["summary"],
                  f"streaming {mode}: the summaries of the orders differ")
            d_det = 0.0
            if env:
                check(len(a["detector"]["timeline"]) == FRAMES_MAIN
                      and len(b["detector"]["timeline"]) == FRAMES_MAIN,
                      f"streaming {mode}: detector timeline lengths")
                d_det = float(np.max(np.abs(np.subtract(
                    a["detector"]["timeline"], b["detector"]["timeline"]))))
                check(d_det <= 2e-2, f"streaming {mode}: detector timeline "
                      f"inline vs pool |Δ| {d_det}")
            else:
                check(a == b, f"streaming {mode}: the orders' results differ")
            for order, row in rows[mode].items():
                row["s"], row["enqueue_ms"] = (_spread(row["s"]),
                                               _spread(row["enqueue_ms"]))
                best = row["s"]["best"]
                log(f"dispatch streaming, detector {mode}, {order}: best "
                    f"{best:.4f} s median {row['s']['median']:.4f} s "
                    f"({FRAMES_MAIN / best:.2f} frames/s); a window's "
                    f"enqueue median "
                    f"{row['enqueue_ms']['median']:.2f} ms (host)")
            log(f"dispatch streaming, detector {mode}: summaries bit-equal, "
                f"detector timeline inline vs pool max |Δ| {d_det:.3g}")
    finally:
        _set_env(**dict.fromkeys(names))
    dispatch["streaming"] = {"rounds": STREAM_ROUNDS, "clip": MP4_1080P,
                             "detector": rows}
    with open(os.path.join("chiprun_out", "dispatch.json"), "w") as f:
        json.dump(dispatch, f, indent=1)


def phase_streaming(frames, fb):
    """The streaming video analyzer on the card, decode replaced by an
    in-memory source of the frames in chunks of 32, with the detector
    scoring in slabs of 64; held to analyze_batch on the same frames."""
    import torch
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.ingest import video_reader
    cuda = torch.device(DEV)
    meta = clip_meta(W_MAIN, H_MAIN, fb.fps, fb.duration)
    pulled = []

    def in_memory_chunks(path, meta, chunk=64, copy=True):
        """Stands in for decode: the frames in chunks of ``chunk``."""
        pulled.append(chunk)
        for i in range(0, frames.shape[0], chunk):
            part = frames[i:i + chunk]
            yield video_reader.FrameBatch(part, part.shape[0], fb.fps,
                                          W_MAIN, H_MAIN, fb.duration)

    log(f"streaming: decode replaced by an in-memory source of the "
        f"{FRAMES_MAIN} 1080p pan frames (a stand-in for decode: no file "
        f"is read)")
    _set_env(AVD_DETECTOR="1", AVD_ATTN_FUSED="1", AVD_DETECTOR_PRESET=None,
             AVD_DETECTOR_CKPT=None, AVD_DETECTOR_BLEND=None,
             AVD_DETECTOR_SLAB=str(SLAB), AVD_STREAM="1")
    out, secs, launches = {}, {}, {}
    try:
        with mock.patch.object(video_reader, "iter_sampled_chunks",
                               in_memory_chunks):
            for mode in ("stream", "batch", "stream", "batch"):
                _reset_counters()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode == "stream":
                    res = video_an.analyze("in-memory:pan", meta, device=cuda)
                else:
                    res = video_an.analyze_batch(fb, device=cuda)
                torch.cuda.synchronize()
                secs.setdefault(mode, []).append(time.perf_counter() - t0)
                launches.setdefault(mode, _counters())
                out[mode] = res
    finally:
        _set_env(AVD_DETECTOR=None, AVD_ATTN_FUSED=None,
                 AVD_DETECTOR_SLAB=None, AVD_STREAM=None)
    check(pulled == [CHUNK_STREAM, CHUNK_STREAM],
          f"the streaming path pulled chunks {pulled}")
    st, ba = out["stream"], out["batch"]
    for name, r in (("stream", st), ("batch", ba)):
        check("detector_error" not in r, f"{name}: detector_error "
              f"{r.get('detector_error')}")
        check(r["timeline"] is r["timeline_ai"], f"{name}: timeline alias")
    check(st["summary"]["dup_density"] == ba["summary"]["dup_density"],
          "dup_density stream vs batch")
    d_tl = float(np.max(np.abs(np.subtract(st["timeline"], ba["timeline"]))))
    check(d_tl <= 1e-6, f"heuristic timeline stream vs batch |Δ| {d_tl}")
    ds, db = st["detector"], ba["detector"]
    check(len(ds["timeline"]) == len(db["timeline"]) == FRAMES_MAIN,
          "detector timeline lengths")
    d_det = float(np.max(np.abs(np.subtract(ds["timeline"],
                                            db["timeline"]))))
    check(d_det <= 2e-2, f"detector timeline stream vs batch |Δ| {d_det}")
    check(ds["weights"] == db["weights"]
          and ds["weights"].endswith("detector_full+T1.00"),
          f"weights {ds['weights']}")
    ls, lb = launches["stream"], launches["batch"]
    slabs = [SLAB] * (FRAMES_MAIN // SLAB) + \
        ([FRAMES_MAIN % SLAB] if FRAMES_MAIN % SLAB else [])
    want_mha = VIT_DEPTH * len(slabs)
    log(f"streaming launches: stream {ls}, batch {lb}")
    for name in ("warp_bilinear", "box_blur_solve"):
        check(ls[name] == lb[name] == 48, f"{name} launched {ls[name]} "
              f"streaming, {lb[name]} batch; expected 48")
    check(ls["mha"] == want_mha and lb["mha"] == VIT_DEPTH,
          f"mha launched {ls['mha']} streaming (want {want_mha}: "
          f"{len(slabs)} slabs {slabs} x depth), {lb['mha']} batch")
    best = {m: min(v) for m, v in secs.items()}
    log(f"streaming vs batch on the card with the detector (slabs of "
        f"{SLAB}): dup_density {st['summary']['dup_density']} both, "
        f"heuristic timeline max |Δ| {d_tl:.3g}, detector timeline max "
        f"|Δ| {d_det:.3g} (bound 2e-2); streaming "
        f"{FRAMES_MAIN / best['stream']:.2f} frames/s (runs "
        f"{', '.join(f'{t:.3f}' for t in secs['stream'])} s), batch "
        f"{FRAMES_MAIN / best['batch']:.2f} frames/s (runs "
        f"{', '.join(f'{t:.3f}' for t in secs['batch'])} s)")
    return ls


def make_fresh_tree():
    """A copy of the committed files under build/: ``git archive HEAD``
    where git can make one, else a copy of the port's files (the package,
    this script, the corpus); neither holds a build directory or
    bytecode."""
    import shutil
    import tarfile
    shutil.rmtree(FRESH_TREE, ignore_errors=True)
    os.makedirs(FRESH_TREE)
    tar = os.path.join("build", "fresh_tree.tar")
    if os.path.isdir(".git") and shutil.which("git") and subprocess.run(
            ["git", "archive", "-o", tar, "HEAD"], capture_output=True,
            timeout=300).returncode == 0:
        with tarfile.open(tar) as t:
            t.extractall(FRESH_TREE, filter="data")
        os.unlink(tar)
        return "git archive HEAD"
    skip = shutil.ignore_patterns("__pycache__", "*.pyc")
    shutil.copytree("avd_tpu_torch", os.path.join(FRESH_TREE,
                                                  "avd_tpu_torch"),
                    ignore=skip)
    shutil.copytree(os.path.join("tests", "data"),
                    os.path.join(FRESH_TREE, "tests", "data"))
    shutil.copy("chip_smoke.py", FRESH_TREE)
    return "a copy of avd_tpu_torch/, tests/data/ and chip_smoke.py"


def phase_cli(wav_path):
    """The CLI in subprocesses: its first call from a fresh tree (the
    kernels and the host runtime built there), then ``--jsonl`` on the WAV
    and the mp4 from this tree."""
    from avd_tpu_torch import schema
    how = make_fresh_tree()
    wav_abs = os.path.abspath(wav_path)
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "avd_tpu_torch.analyze",
                        wav_abs], cwd=FRESH_TREE, capture_output=True,
                       text=True, timeout=600)
    first_s = time.perf_counter() - t0
    check(r.returncode == 0, f"CLI exit {r.returncode}: {r.stderr[-2000:]}")
    lines = r.stdout.strip().splitlines()
    check(len(lines) == 1, f"CLI printed {len(lines)} lines")
    env = json.loads(lines[0])
    schema.validate(env)
    check("audio_error" not in env["hints"], "CLI audio_error")
    built = os.path.isdir(os.path.join(FRESH_TREE, "build",
                                       "avd_tpu_torch_kernels"))
    check(built, "the CLI's first call built no kernels in the fresh tree")
    log(f"CLI first call (fresh tree from {how}; builds the CUDA kernels "
        f"and the host runtime there, warms every window bucket): exit 0, "
        f"one envelope, label {env['result']['label']}, {first_s:.2f} s "
        f"wall")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "avd_tpu_torch.analyze",
                        "--jsonl", wav_abs, os.path.abspath(CORPUS_MP4)],
                       capture_output=True, text=True, timeout=600)
    jsonl_s = time.perf_counter() - t0
    check(r.returncode == 0, f"CLI --jsonl exit {r.returncode}: "
          f"{r.stderr[-2000:]}")
    lines = [json.loads(x) for x in r.stdout.strip().splitlines()]
    check(len(lines) == 2 and all("response" in x for x in lines),
          f"CLI --jsonl printed {r.stdout[:500]}")
    for x in lines:
        schema.validate(x["response"])
    log(f"CLI --jsonl on the WAV and the mp4: exit 0, two lines, labels "
        f"{[x['response']['result']['label'] for x in lines]}, "
        f"{jsonl_s:.2f} s wall (kernels found built)")
    return first_s


def scoring_profile(resized, table_path):
    """One warm AVD_ATTN_FUSED=1 scoring call under the profiler: device
    busy ms, device kernels and copies, and the rows by kernel."""
    import torch
    from avd_tpu_torch.models import scoring
    cuda = torch.device(DEV)
    scoring.detector_timeline_resized(resized, device=cuda)  # warm
    busy, n_dev, avgs = device_profile(
        lambda: scoring.detector_timeline_resized(resized, device=cuda))
    os.makedirs(os.path.dirname(table_path), exist_ok=True)
    with open(table_path, "w") as f:
        f.write(avgs.table(sort_by="self_device_time_total", row_limit=60))
    rows = {e.key: [e.count, round(e.self_device_time_total / 1e3, 4)]
            for e in avgs
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep")}
    h2d_ms, h2d_n = _kernel_ms(avgs, "Memcpy HtoD")
    return {"busy_ms": busy, "launches": n_dev, "h2d_ms": h2d_ms,
            "h2d_copies": h2d_n, "rows": rows}


def scoring_probe(out_dir):
    """Entry for a subprocess: the fused scoring call on the 145 pan
    frames, resized as the detector path resizes them; prints one JSON
    line and writes the profiler table under ``out_dir``."""
    import torch
    from avd_tpu_torch.models import scoring
    os.environ.update(AVD_DETECTOR="1", AVD_ATTN_FUSED="1")
    frames = pan_frames(FRAMES_MAIN, H_MAIN, W_MAIN)
    resized = scoring.resize_frames(
        frames, scoring.input_size(torch.device(DEV)))
    tag = "fresh" if os.path.abspath(".").endswith(FRESH_TREE) else "tree"
    res = scoring_profile(resized, os.path.join(
        out_dir, f"torch_profile_scoring_subprocess_{tag}.txt"))
    res["weights"] = scoring._bundle(torch.device(DEV))[3]
    print(json.dumps(res), flush=True)
    return 0


def phase_fault3(frames):
    """The fused scoring call's device work: in this process, in a
    subprocess from this tree, and in a subprocess from the fresh tree."""
    import torch
    from avd_tpu_torch.models import scoring
    out_dir = os.path.abspath("chiprun_out")
    _set_env(AVD_DETECTOR="1", AVD_ATTN_FUSED="1", AVD_DETECTOR_PRESET=None,
             AVD_DETECTOR_CKPT=None, AVD_DETECTOR_SLAB=None)
    try:
        resized = scoring.resize_frames(frames,
                                        scoring.input_size(torch.device(DEV)))
        runs = {"in-process": scoring_profile(resized, os.path.join(
            out_dir, "torch_profile_scoring_inprocess.txt"))}
    finally:
        _set_env(AVD_DETECTOR=None, AVD_ATTN_FUSED=None)
    probe = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
             f"sys.exit(chip_smoke.scoring_probe({out_dir!r}))")
    for name, cwd in (("subprocess, this tree", "."),
                      ("subprocess, fresh tree", FRESH_TREE)):
        r = subprocess.run([sys.executable, "-c", probe], cwd=cwd,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"scoring probe ({name}) exit "
              f"{r.returncode}: {r.stderr[-2000:]}")
        runs[name] = json.loads(r.stdout.strip().splitlines()[-1])
    base = runs["in-process"]
    with open(os.path.join(out_dir, "scoring_fault3.json"), "w") as f:
        json.dump(runs, f, indent=1)
    for name, res in runs.items():
        extra = {k[:60]: v for k, v in res["rows"].items()
                 if base["rows"].get(k, [0])[0] != v[0]}
        log(f"fault 3, {name}: device busy {res['busy_ms']:.3f} ms per "
            f"scoring call, {res['launches']} device kernels and copies, of "
            f"which the batch's pageable host→device copy "
            f"{res['h2d_ms']:.3f} ms ({154.1 / max(res['h2d_ms'], 1e-9):.2f} "
            f"GB/s), kernels {res['busy_ms'] - res['h2d_ms']:.3f} ms; rows "
            f"whose count differs from in-process: {extra or 'none'}")
        check(res["h2d_copies"] == 1, f"fault 3, {name}: "
              f"{res['h2d_copies']} host→device copies traced, expected 1")
    return runs


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

MP4_1080P = os.path.join(MEDIA_DIR, "pan_1080p_2fps.mp4")
STACK_MS = (1, 2, 4, 8)      # batching._BUCKETS: the stacked-window ladder
TIMELINE_EQ = 1e-6           # "equal" heuristic timelines (phase 16's bound)


def _wall_ms(fn, reps=3):
    """Host-clock ms of ``fn()`` to a synchronized end, one per run."""
    import torch
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def phase_stacked_windows(frames):
    """``run_prep_windows`` on m = 1, 2, 4, 8 of the pan frames' 49-frame
    host-prep windows against m ``run_prep_window`` calls: Hamming exact,
    flow mean rtol 1e-4, variance rtol 1e-3; warp and blur+solve launched
    as often for one stacked call as for one window; wall ms of both."""
    import torch
    from avd_tpu_torch.ops import host_prep
    from avd_tpu_torch.ops import video_features as vf
    cuda = torch.device(DEV)
    s320, s32, _ = host_prep.host_prep(frames)
    n = vf._DEFAULT_CHUNK + 1
    stride = (frames.shape[0] - n) // (STACK_MS[-1] - 1)
    w320 = np.stack([s320[i * stride:i * stride + n]
                     for i in range(STACK_MS[-1])])
    w32 = np.stack([s32[i * stride:i * stride + n]
                    for i in range(STACK_MS[-1])])
    k = n - 1
    rows = {}
    for m in STACK_MS:
        _reset_counters()
        stacked = vf.run_prep_windows(w320[:m], w32[:m], cuda).cpu().numpy()
        c_st = _counters()
        _reset_counters()
        single = torch.stack([vf.run_prep_window(w320[i], w32[i], cuda)
                              for i in range(m)]).cpu().numpy()
        c_one = {key: v // m for key, v in _counters().items()}
        for name in ("warp_bilinear", "box_blur_solve"):
            check(c_st[name] == c_one[name] == len(LEVELS) * ROUNDS,
                  f"stacked m={m}: {name} launched {c_st[name]} times in "
                  f"one stacked call, {c_one[name]} a single window")
        check(np.array_equal(stacked[:, :k], single[:, :k]),
              f"stacked m={m}: Hamming differs")
        check(np.allclose(stacked[:, k:2 * k], single[:, k:2 * k],
                          rtol=1e-4, atol=0.0),
              f"stacked m={m}: flow mean beyond rtol 1e-4")
        check(np.allclose(stacked[:, 2 * k:], single[:, 2 * k:], rtol=1e-3,
                          atol=0.0),
              f"stacked m={m}: flow variance beyond rtol 1e-3")
        d = np.abs(stacked - single)
        st_ms = _wall_ms(lambda: vf.run_prep_windows(w320[:m], w32[:m],
                                                     cuda).cpu())
        one_ms = _wall_ms(lambda: torch.stack([
            vf.run_prep_window(w320[i], w32[i], cuda)
            for i in range(m)]).cpu())
        rows[m] = {"max_abs_mean": float(d[:, k:2 * k].max()),
                   "max_abs_var": float(d[:, 2 * k:].max()),
                   "stacked_ms": min(st_ms), "singles_ms": min(one_ms)}
        log(f"stacked windows m={m} ({m * k} pairs of 320²): Hamming equal, "
            f"flow mean max |Δ| {rows[m]['max_abs_mean']:.3g}, variance "
            f"max |Δ| {rows[m]['max_abs_var']:.3g}; warp/blur+solve "
            f"launches {c_st['warp_bilinear']}/{c_st['box_blur_solve']} "
            f"per stacked call = per window; wall ms one stacked call "
            f"{min(st_ms):.3f} (runs {', '.join(f'{t:.3f}' for t in st_ms)})"
            f" against {m} single calls {min(one_ms):.3f} (runs "
            f"{', '.join(f'{t:.3f}' for t in one_ms)})")
    return rows


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MasterProc:
    """``python -m avd_tpu_torch.serve.master --device cuda [args]`` in a
    subprocess on a free port, its log under ``chiprun_out/``."""

    def __init__(self, name, args=(), **env):
        self.port = _free_port()
        self.log_path = os.path.join("chiprun_out", f"serve_{name}.log")
        os.makedirs("chiprun_out", exist_ok=True)
        full = dict(os.environ)
        full.update({"GUNICORN_BIND": f"127.0.0.1:{self.port}",
                     "GUNICORN_GRACEFUL_TIMEOUT": "30",
                     "GUNICORN_MAX_REQUESTS": "0"})
        full.update(env)
        with open(self.log_path, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "avd_tpu_torch.serve.master",
                 "--device", "cuda", *args], env=full, stdout=f,
                stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))
        self.url = f"http://127.0.0.1:{self.port}"

    def text(self):
        with open(self.log_path) as f:
            return f.read()

    def assert_clean(self):
        text = self.text()
        check("warmup skipped" not in text and "Traceback" not in text,
              f"master log {self.log_path}:\n{text[-3000:]}")
        return text

    def wait_log(self, needle, count=1, timeout=240.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            text = self.assert_clean()
            if text.count(needle) >= count:
                return text
            check(self.proc.poll() is None,
                  f"master exited {self.proc.returncode}:\n{text[-3000:]}")
            time.sleep(0.2)
        raise PhaseError(f"{count}x {needle!r} not in {self.log_path} "
                         f"after {timeout:.0f} s:\n{self.text()[-3000:]}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(15)
            try:
                self.proc.wait(timeout=90)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=30)
        return self.text()


def _key_paths(d, prefix=""):
    """Every dict's key order, walked depth first."""
    out = [(prefix, list(d))]
    for k, v in d.items():
        if isinstance(v, dict):
            out += _key_paths(v, f"{prefix}.{k}")
    return out


def same_served(served, ref, what):
    """A served envelope against the in-process one on the same file."""
    from avd_tpu_torch import schema
    schema.validate(served)
    check(_key_paths(served) == _key_paths(ref), f"{what}: key order")
    for key in ("video_error", "audio_error"):
        check(key not in served["hints"],
              f"{what}: {key} {served['hints'].get(key)}")
    check("detector_error" not in served["video"], f"{what}: detector_error")
    check(served["result"]["label"] == ref["result"]["label"],
          f"{what}: label {served['result']} against {ref['result']}")
    d_ai = abs(served["result"]["ai_score"] - ref["result"]["ai_score"])
    check(d_ai <= 1e-3, f"{what}: |Δai_score| {d_ai}")
    a, b = served["video"]["timeline"], ref["video"]["timeline"]
    check(len(a) == len(b), f"{what}: timeline length {len(a)} / {len(b)}")
    d_tl = float(np.max(np.abs(np.subtract(a, b)))) if a else 0.0
    check(d_tl <= TIMELINE_EQ, f"{what}: heuristic timeline |Δ| {d_tl}")
    return d_ai, d_tl


def _timed_requests(client, path, clients, total):
    """``total`` uploads of ``path`` from ``clients`` threads: (wall s,
    per-request latencies s, envelopes)."""
    import concurrent.futures

    def one(_):
        t0 = time.perf_counter()
        raw = client.analyze(path).raw
        return time.perf_counter() - t0, raw

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(max_workers=clients) as ex:
        got = list(ex.map(one, range(total)))
    return (time.perf_counter() - t0, [g[0] for g in got],
            [g[1] for g in got])


def _latency_row(walls, lats, clients):
    """Requests/s over the summed walls, p50 and max over every latency
    of the rounds, and each round's requests/s."""
    n = len(lats) // len(walls)
    return {"clients": clients, "requests": len(lats), "rounds": len(walls),
            "wall_s": sum(walls), "requests_per_s": len(lats) / sum(walls),
            "round_requests_per_s": [n / w for w in walls],
            "p50_s": statistics.median(lats), "max_s": max(lats)}


def _fmt_row(r):
    return (f"{r['clients']} client(s), {r['requests']} requests in "
            f"{r['rounds']} rounds: {r['requests_per_s']:.3f} requests/s "
            "(rounds "
            + ", ".join(f"{x:.3f}" for x in r["round_requests_per_s"])
            + f"), p50 {r['p50_s']:.3f} s, max {r['max_s']:.3f} s, wall "
            f"{r['wall_s']:.3f} s")


def phase_served(wav_path, card_name):
    """A real master on the card (WEB_CONCURRENCY=2): both workers warm,
    /readyz names the card, the served WAV and 1080p mp4 equal the
    in-process envelopes, and a zero-downtime recycle whose replacement
    (forked while its sibling holds a CUDA context) warms and serves."""
    import re
    import torch
    from avd_tpu_torch import pipeline
    from avd_tpu_torch.client import Client
    check(os.path.exists(MP4_1080P), f"{MP4_1080P} was not written")
    cuda = torch.device(DEV)
    torch.cuda.empty_cache()  # the workers share the card with this process
    refs = {p: pipeline.analyze_path(p, device=cuda)
            for p in (wav_path, MP4_1080P)}
    master = MasterProc("recycle", WEB_CONCURRENCY="2",
                    GUNICORN_MAX_REQUESTS="3",
                    GUNICORN_MAX_REQUESTS_JITTER="0")
    try:
        t0 = time.perf_counter()
        master.wait_log("warmup complete", 2)
        boot_s = time.perf_counter() - t0
        c = Client(master.url, timeout=600, retries=4)
        ready = c.wait_ready(timeout_s=60, poll_s=0.5)
        check(ready["cuda"]["devices"] >= 1
              and ready["cuda"]["kind"] == card_name,
              f"/readyz cuda {ready['cuda']}, expected {card_name}")
        diffs = {}
        for p in (wav_path, MP4_1080P):
            diffs[os.path.basename(p)] = same_served(
                c.analyze(p).raw, refs[p], f"served {os.path.basename(p)}")
        # a worker at its budget (3) asks for a replacement: stop sending
        # once the master has spawned it, then wait for the handshake
        sent = 0
        while master.text().count("spawned worker") < 3:
            check(sent < 40, "no replacement spawned after 40 requests")
            c.health()
            sent += 1
        text = master.wait_log("retired (zero-downtime recycle)")
        master.wait_log("warmup complete", 3)
        text = master.wait_log("serving on", 3)
        spawned = re.findall(r"\[master\] spawned worker (\d+)", text)
        for _ in range(12):
            c.health()
        same_served(c.analyze(wav_path).raw, refs[wav_path],
                    "served WAV after the recycle")
    finally:
        text = master.stop()
    check("Traceback" not in text and "warmup skipped" not in text,
          f"master log:\n{text[-3000:]}")
    # both first workers can reach their budget together, and then two
    # replacements start; the kernel hands the shared socket's requests to
    # whichever accepts first, so one of them may serve none
    counts = {pid: re.findall(rf"\[worker {pid}\] exiting after (\d+) "
                              "requests", text) for pid in spawned[2:]}
    busy = [pid for pid, n in counts.items() if n and int(n[0]) >= 1]
    check(busy, f"no replacement served a request ({counts}):\n"
          f"{text[-3000:]}")
    replacement, served = busy[0], counts[busy[0]]
    log(f"served (master, 2 workers on the card): both warm in "
        f"{boot_s:.2f} s; /readyz cuda {ready['cuda']}; WAV |Δai_score| "
        f"{diffs[os.path.basename(wav_path)][0]:.3g}, timeline |Δ| "
        f"{diffs[os.path.basename(wav_path)][1]:.3g}; 1080p mp4 "
        f"|Δai_score| {diffs[os.path.basename(MP4_1080P)][0]:.3g}, "
        f"timeline |Δ| {diffs[os.path.basename(MP4_1080P)][1]:.3g}; "
        f"zero-downtime recycle after {sent} more requests: replacement "
        f"{replacement} warmed and served {served[0]} requests")
    return refs[MP4_1080P]


SERVE_ROUNDS = 1             # timed rounds a batching mode
SERVE_UPLOADS = {1: 4, 4: 8}  # uploads a round at each client count


def phase_batching(ref_mp4):
    """Cross-request batching on the card: one worker with 4 threads and
    AVD_BATCH_WINDOW_MS=100; 4 concurrent uploads of the 1080p mp4 fuse
    (batch_fused_jobs >= 2) and each equals the solo envelope.  Then, with
    batching on and off, SERVE_ROUNDS rounds of 4 uploads from 1 client
    and 8 from 4: requests/s, p50 and max latency over every upload of
    the rounds, every envelope held to the solo one."""
    from avd_tpu_torch.client import Client
    rows = {}
    for mode, window in (("on", "100"), ("off", "0")):
        master = MasterProc(f"batching_{mode}", WEB_CONCURRENCY="1",
                            GUNICORN_THREADS="4", AVD_BATCH_WINDOW_MS=window,
                            AVD_MAX_INFLIGHT="0")
        timed = {k: ([], []) for k in SERVE_UPLOADS}  # walls, latencies
        fused = {k: 0 for k in SERVE_UPLOADS}  # fused jobs in the rounds
        try:
            master.wait_log("warmup complete")
            c = Client(master.url, timeout=600, retries=4)
            c.wait_ready(timeout_s=60, poll_s=0.5)
            wall4, _, envs = _timed_requests(c, MP4_1080P, 4, 4)
            metrics = c.metrics()["metrics"]
            for i, env in enumerate(envs):
                same_served(env, ref_mp4,
                            f"batching {mode}, concurrent upload {i}")
            wall1, _, envs = _timed_requests(c, MP4_1080P, 1, 4)
            for i, env in enumerate(envs):
                same_served(env, ref_mp4, f"batching {mode}, upload {i}")
            for r in range(SERVE_ROUNDS):
                for clients, total in SERVE_UPLOADS.items():
                    before = c.metrics()["metrics"].get("batch_fused_jobs", 0)
                    wall, lats, envs = _timed_requests(c, MP4_1080P, clients,
                                                       total)
                    fused[clients] += c.metrics()["metrics"].get(
                        "batch_fused_jobs", 0) - before
                    timed[clients][0].append(wall)
                    timed[clients][1].extend(lats)
                    for i, env in enumerate(envs):
                        same_served(env, ref_mp4, f"batching {mode}, round "
                                    f"{r}, {clients} client(s), upload {i}")
        finally:
            master.stop()
        master.assert_clean()
        if mode == "on":
            check(metrics.get("batch_fused_jobs", 0) >= 2,
                  f"batching on: metrics {metrics}")
        rows[mode] = {"four_concurrent_wall_s": wall4,
                      "four_sequential_wall_s": wall1,
                      "batch_fused_jobs": metrics.get("batch_fused_jobs"),
                      "batches_formed": metrics.get("batches_formed"),
                      "batch_jobs_in": metrics.get("batch_jobs_in")}
        for clients, (walls, lats) in timed.items():
            rows[mode][f"clients_{clients}"] = dict(
                _latency_row(walls, lats, clients),
                fused_jobs=fused[clients] if mode == "on" else None)
        log(f"served 1080p mp4, batching {mode} (1 worker, 4 threads): 4 "
            f"concurrent uploads {wall4:.3f} s, 4 sequential {wall1:.3f} s "
            f"(batcher jobs {rows[mode]['batch_jobs_in']}, batches "
            f"{rows[mode]['batches_formed']}, fused jobs "
            f"{rows[mode]['batch_fused_jobs']}); "
            + "; ".join(f"{_fmt_row(rows[mode][f'clients_{k}'])}, fused "
                        f"jobs {fused[k] if mode == 'on' else None}"
                        for k in SERVE_UPLOADS))
    log(f"4 concurrent uploads with batching against 4 sequential without: "
        f"{rows['on']['four_concurrent_wall_s']:.3f} s against "
        f"{rows['off']['four_sequential_wall_s']:.3f} s")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "serving.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return rows


def phase_trace_route(ref_mp4):
    """The in-process app with DEBUG=1: /debug/trace/start, one upload of
    the 1080p mp4, /debug/trace/stop; the Chrome trace names
    warp_bilinear_kernel, and the request launched the flow kernels (the
    counters set to 0 just before and read just after)."""
    import threading
    import torch
    from avd_tpu_torch.client import Client
    from avd_tpu_torch.serve import app as app_mod
    from avd_tpu_torch.serve import http as http_mod
    trace_dir = os.path.join("build", "chip_smoke_trace")
    _set_env(DEBUG="1", AVD_TRACE_DIR=os.path.abspath(trace_dir))
    srv = None
    try:
        srv = http_mod.make_server(
            app_mod.build_app(device=torch.device(DEV)), "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        c = Client(f"http://127.0.0.1:{srv.server_address[1]}", timeout=600)
        c._post_form("/debug/trace/start", {})
        _reset_counters()
        t0 = time.perf_counter()
        env = c.analyze(MP4_1080P).raw
        secs = time.perf_counter() - t0
        launches = _counters()
        trace = c._post_form("/debug/trace/stop", {})["trace"]
    finally:
        if srv is not None:
            srv.shutdown()
            srv.server_close()
        _set_env(DEBUG=None, AVD_TRACE_DIR=None)
    same_served(env, ref_mp4, "in-process app, traced")
    for name in ("warp_bilinear", "box_blur_solve"):
        check(launches[name] == len(LEVELS) * ROUNDS * 4,
              f"served request launched {name} {launches[name]} times, "
              "expected 48 (4 windows x 4 levels x 3 rounds)")
    check(os.path.exists(trace), f"no trace at {trace}")
    with open(trace) as f:
        text = f.read()
    n_warp = text.count("warp_bilinear_kernel")
    check(n_warp > 0, f"trace {trace} names no warp_bilinear_kernel")
    log(f"trace route: one traced upload of the 1080p mp4 in {secs:.3f} s; "
        f"launches {launches}; Chrome trace {os.path.getsize(trace)} bytes "
        f"naming warp_bilinear_kernel {n_warp} times")
    return launches


# ---------------------------------------------------------------------------
# the detector families
# ---------------------------------------------------------------------------

# (name, settings, shipped checkpoint or None for seeded weights); every
# one scores with AVD_DETECTOR=1
FAMILY_MODES = [
    ("cnn_small", {"AVD_DETECTOR_ARCH": "cnn"}, "cnn_small"),
    ("temporal_small", {"AVD_DETECTOR_ARCH": "temporal"}, "temporal_small"),
    ("moe_small", {"AVD_DETECTOR_PRESET": "moe_small"}, "moe_small"),
    ("moe_small fused", {"AVD_DETECTOR_PRESET": "moe_small",
                         "AVD_ATTN_FUSED": "1"}, "moe_small"),
    ("vit full int8", {"AVD_DETECTOR_QUANT": "1"}, "detector_full"),
    ("cnn_small int8", {"AVD_DETECTOR_ARCH": "cnn",
                        "AVD_DETECTOR_QUANT": "1"}, "cnn_small"),
    ("cnn full", {"AVD_DETECTOR_ARCH": "cnn",
                  "AVD_DETECTOR_PRESET": "full"}, None),
    ("temporal full", {"AVD_DETECTOR_ARCH": "temporal",
                       "AVD_DETECTOR_PRESET": "full"}, None),
]
_FAMILY_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_ARCH", "AVD_DETECTOR_PRESET",
               "AVD_DETECTOR_QUANT", "AVD_ATTN_FUSED", "AVD_DETECTOR_CKPT",
               "AVD_DETECTOR_BLEND", "AVD_TEMPORAL_WINDOW",
               "AVD_DETECTOR_SLAB", "AVD_STREAM", "AVD_DETECTOR_EXPORTED")
CARD_CPU_FRAMES = 8          # frames of the card-against-CPU logits


def _family_env(settings):
    """AVD_DETECTOR=1 and ``settings``; every other detector setting off."""
    env = {k: None for k in _FAMILY_ENV}
    env.update({"AVD_DETECTOR": "1"}, **settings)
    _set_env(**env)


def _logits(bundle, batch, dev):
    """The logits of the bundle's config and parameters for a prepped
    [n, s, s, 3] batch on ``dev``: the int8 forward, a per-frame family's
    forward, or one masked temporal window (the batch padded with its
    last frame to the window)."""
    import torch
    from avd_tpu_torch.models import cnn, detector, quant, scoring, temporal
    cfg, params, probs, source = bundle
    n = batch.shape[0]
    window = getattr(probs, "clip_window", None)
    x = batch if not window else scoring._pad(batch, window)
    x = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    with torch.inference_mode():
        if source.endswith("+int8"):
            out = quant.forward(params, x, cfg)
        elif window:
            mask = torch.arange(window, device=dev) < n
            out = temporal.forward_clip(params, x, cfg, mask=mask)
        else:
            family = {detector.ViTConfig: detector,
                      cnn.CNNConfig: cnn}[type(cfg)]
            out = family.forward(params, x, cfg)
    return out[:n, 0].float().cpu()


def phase_families(frames):
    """Each family and mode scoring the 145 1080p pan frames on the card:
    card against CPU logits (2e-2), the MoE routes, the weights label, a
    scoring call's kernels and host→device copy under the profiler,
    launches and frames/s."""
    import torch
    from avd_tpu_torch.models import detector, scoring
    cuda = torch.device(DEV)
    resized, rows = {}, {}
    try:
        for name, settings, shipped in FAMILY_MODES:
            _family_env(settings)
            bundle = scoring._bundle(cuda)
            cfg, _, probs, source = bundle
            size = cfg.image_size
            if size not in resized:
                resized[size] = scoring.resize_frames(frames, size)
            rs = resized[size]
            if shipped:
                want = scoring._shipped_ckpt(
                    settings.get("AVD_DETECTOR_ARCH", "vit"),
                    settings.get("AVD_DETECTOR_PRESET",
                                 "full" if shipped == "detector_full"
                                 else "small"))
                check(want is not None and source.startswith(want)
                      and os.path.basename(want) == shipped,
                      f"{name}: weights {source}, not {shipped}")
            else:
                check(source == "random_init", f"{name}: weights {source}")
            if settings.get("AVD_DETECTOR_QUANT") == "1":
                check(source.endswith("+int8"), f"{name}: label {source}")
            # the scoring call outside any analyzer's except
            _reset_counters()
            out = scoring.detector_timeline_resized(rs, device=cuda)
            launches = _counters()
            tl = np.asarray(out["timeline"])
            check(tl.shape == (FRAMES_MAIN,) and np.isfinite(tl).all()
                  and tl.min() >= 0 and tl.max() <= 1,
                  f"{name}: timeline {tl.shape}")
            fused = settings.get("AVD_ATTN_FUSED") == "1"
            want_mha = cfg.depth if fused else 0
            check(launches["mha"] == want_mha,
                  f"{name}: mha launched {launches['mha']} times, expected "
                  f"{want_mha}")
            best = None
            for _ in range(3):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                scoring.detector_timeline_resized(rs, device=cuda)
                best = min(best or 1e9, time.perf_counter() - t0)
            busy, n_dev, avgs = device_profile(
                lambda: scoring.detector_timeline_resized(rs, device=cuda))
            h2d_ms, h2d_n = _kernel_ms(avgs, "Memcpy HtoD")
            window = getattr(probs, "clip_window", None)
            n_copies = -(-FRAMES_MAIN // window) if window else 1
            check(h2d_n == n_copies, f"{name}: {h2d_n} host→device copies "
                  f"in the scoring call's trace, expected {n_copies}")

            # card against CPU on the first frames: logits, MoE routes
            batch = rs[:CARD_CPU_FRAMES][..., ::-1].astype(np.float32) / 255
            cpu_bundle = scoring._bundle("cpu")
            got = _logits(bundle, batch, cuda)
            ref = _logits(cpu_bundle, batch, "cpu")
            err, ok = _close(got, ref, 2e-2, 2e-2)
            check(ok, f"{name}: card and CPU logits differ by {err}")
            routes = None
            if getattr(cfg, "n_experts", 0):
                x = torch.from_numpy(np.ascontiguousarray(batch))
                with torch.inference_mode():
                    r_card = detector.expert_indices(bundle[1], x.to(cuda),
                                                     cfg).cpu()
                    r_cpu = detector.expert_indices(cpu_bundle[1], x, cfg)
                routes = int((r_card != r_cpu).sum())
                check(routes == 0, f"{name}: {routes} of {r_card.numel()} "
                      "token routes differ between the card and the CPU")
            rows[name] = {
                "weights": source, "image_size": size,
                "kernels_ms": busy - h2d_ms, "h2d_ms": h2d_ms,
                "h2d_copies": h2d_n, "device_ops": n_dev,
                "mha_launches": launches["mha"],
                "frames_per_s": FRAMES_MAIN / best, "call_s": best,
                "card_cpu_max_abs": err, "routes_differing": routes}
            log(f"family {name}: weights {source}; scoring call "
                f"({FRAMES_MAIN} frames at {size}²) {best:.3f} s = "
                f"{FRAMES_MAIN / best:.2f} frames/s; device: kernels "
                f"{busy - h2d_ms:.3f} ms, host→device copy {h2d_ms:.3f} ms "
                f"in {h2d_n} copies, {n_dev} device kernels and copies; mha "
                f"launches {launches['mha']}; card vs CPU logits max |Δ| "
                f"{err:.3g} on {CARD_CPU_FRAMES} frames"
                + (f"; MoE routes differing {routes}" if routes is not None
                   else ""))
    finally:
        _set_env(**{k: None for k in _FAMILY_ENV})
    return rows


def phase_temporal_windows(frames):
    """The temporal family on the card: the streaming analyzer's slabs of
    64 give the batch path's timeline (|Δ| <= 1e-6), and with 8-frame
    windows the first 40 frames score the same in a 40- and a 70-frame
    clip (tests/test_temporal.py:231-247)."""
    import torch
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.models import scoring
    cuda = torch.device(DEV)
    try:
        _family_env({"AVD_DETECTOR_ARCH": "temporal",
                     "AVD_DETECTOR_SLAB": str(SLAB)})
        n = frames.shape[0]
        acc = video_an._DetAccum(cuda)
        for i in range(0, n, CHUNK_STREAM):
            acc.add(frames[i:i + CHUNK_STREAM])
        stream = acc.result()
        batch = scoring.detector_timeline(frames, device=cuda)
        check(stream is not None and acc.error is None,
              f"temporal streaming: {acc.error}")
        d_stream = float(np.max(np.abs(np.subtract(stream["timeline"],
                                                   batch["timeline"]))))
        check(len(stream["timeline"]) == n and d_stream <= 1e-6,
              f"temporal streaming vs batch |Δ| {d_stream}")
        _family_env({"AVD_DETECTOR_ARCH": "temporal",
                     "AVD_TEMPORAL_WINDOW": "8"})
        clip = frames[:70]
        short = scoring.detector_timeline(clip[:40], device=cuda)
        long = scoring.detector_timeline(clip, device=cuda)
        d_len = float(np.max(np.abs(np.subtract(short["timeline"][:40],
                                                long["timeline"][:40]))))
        check(d_len <= 1e-6, f"temporal window scores depend on the clip's "
              f"length: |Δ| {d_len}")
    finally:
        _set_env(**{k: None for k in _FAMILY_ENV})
    log(f"temporal windows on the card: streaming (slabs of {SLAB}) vs batch "
        f"max |Δ| {d_stream:.3g}; 40- vs 70-frame clip (windows of 8) "
        f"max |Δ| {d_len:.3g} on the first 40 frames")
    return d_stream, d_len


def _smooth(img, sigma):
    import cv2
    return cv2.GaussianBlur(img, (0, 0), sigma)


def frame_blobs(rng, size, ai_like):
    """A blob scene of the detector's training curriculum (the "blobs"
    family of avd_tpu's trainer): AI-like frames are smoothed, saturated
    and nearly noiseless, camera-like ones crisp with sensor noise."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.zeros((size, size, 3), np.float32)
    for _ in range(rng.integers(2, 5)):
        cx, cy = rng.random(2)
        r = 0.1 + 0.4 * rng.random()
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / r ** 2))
        base += blob[..., None] * rng.random(3)
    base += (0.3 * xx * rng.random() + 0.3 * yy * rng.random())[..., None]
    base /= max(1e-6, base.max())
    detail = rng.random((size, size, 3)).astype(np.float32)
    if ai_like:
        sigma = 1.2 + 2.0 * rng.random()
        img = _smooth(base + 0.10 * detail, sigma)
        img = np.clip(img * (1.05 + 0.15 * rng.random()), 0, 1)
        img += rng.normal(0, 0.004, img.shape).astype(np.float32)
    else:
        img = base + (0.15 + 0.2 * rng.random()) * detail
        img = np.clip(img, 0, 1)
        blur = _smooth(img, 1.0)
        img = np.clip(img + (0.3 * rng.random()) * (img - blur), 0, 1)
        img += rng.normal(0, 0.01 + 0.02 * rng.random(),
                          img.shape).astype(np.float32)
    return img


def write_blobs_clip(path, n=64, splice=20, size=64, seed=11):
    """The spliced clip of the served partial-AI case: camera-like blob
    frames, AI-like from ``splice`` on, at 2 fps (tests/test_serve.py)."""
    import cv2
    rng = np.random.default_rng(seed)
    frames = np.stack([np.clip(frame_blobs(rng, size, i >= splice), 0, 1)
                       for i in range(n)])
    clip = (frames * 255).astype(np.uint8)[..., ::-1]  # RGB→BGR
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 2.0,
                         (size, size))
    check(vw.isOpened(), "cv2 cannot write the blobs clip")
    for f in clip:
        vw.write(np.ascontiguousarray(f))
    vw.release()
    return path


def phase_family_paths():
    """``analyze_path`` on the 1080p mp4 with each family and mode, and one
    upload of the spliced blobs clip through the in-process app with the
    temporal family, held to the in-process envelope."""
    import threading
    import torch
    from avd_tpu_torch import pipeline, schema
    from avd_tpu_torch.client import Client
    from avd_tpu_torch.serve import app as app_mod
    from avd_tpu_torch.serve import http as http_mod
    cuda = torch.device(DEV)
    check(os.path.exists(MP4_1080P), f"{MP4_1080P} was not written")
    rows = {}
    try:
        for name, settings in (
                ("cnn", {"AVD_DETECTOR_ARCH": "cnn"}),
                ("temporal", {"AVD_DETECTOR_ARCH": "temporal"}),
                ("moe_small", {"AVD_DETECTOR_PRESET": "moe_small"}),
                ("int8", {"AVD_DETECTOR_QUANT": "1"})):
            _family_env(settings)
            secs = []
            for _ in range(2):
                t0 = time.perf_counter()
                env = pipeline.analyze_path(MP4_1080P, device=cuda)
                secs.append(time.perf_counter() - t0)
            schema.validate(env)
            video = env["video"]
            for key in ("video_error", "audio_error"):
                check(key not in env["hints"],
                      f"analyze_path {name}: {key} {env['hints'].get(key)}")
            check("detector_error" not in video,
                  f"analyze_path {name}: detector_error "
                  f"{video.get('detector_error')}")
            n = len(video["detector"]["timeline"])
            check(n == FRAMES_MAIN, f"analyze_path {name}: {n} frames scored")
            rows[name] = {"wall_s": min(secs), "runs_s": secs,
                          "frames_per_s": n / min(secs),
                          "weights": video["detector"]["weights"]}
            log(f"analyze_path 1080p mp4, {name}: {min(secs):.3f} s (runs "
                f"{', '.join(f'{t:.3f}' for t in secs)}) = "
                f"{n / min(secs):.2f} frames/s, weights "
                f"{video['detector']['weights']}, label "
                f"{env['result']['label']}")

        path = write_blobs_clip(os.path.join(MEDIA_DIR, "spliced_blobs.mp4"))
        _family_env({"AVD_DETECTOR_ARCH": "temporal",
                     "AVD_DETECTOR_BLEND": "1"})
        ref = pipeline.analyze_path(path, device=cuda)
        srv = http_mod.make_server(app_mod.build_app(device=cuda),
                                   "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            c = Client(f"http://127.0.0.1:{srv.server_address[1]}",
                       timeout=600)
            served = c.analyze(path).raw
        finally:
            srv.shutdown()
            srv.server_close()
    finally:
        _set_env(**{k: None for k in _FAMILY_ENV})
    d_ai, d_tl = same_served(served, ref, "served blobs clip, temporal")
    det, det_ref = served["video"]["detector"], ref["video"]["detector"]
    check("temporal_small" in det["weights"]
          and det["weights"] == det_ref["weights"],
          f"served weights {det['weights']}")
    d_det = float(np.max(np.abs(np.subtract(det["timeline"],
                                            det_ref["timeline"]))))
    check(d_det <= 1e-6, f"served detector timeline |Δ| {d_det}")
    t = np.asarray(det["timeline"])
    m = len(t)
    true_ai = np.zeros(m, bool)
    true_ai[int(round(20 / 64 * m)):] = True
    iou = float((true_ai & (t > 0.5)).sum() / max(1, (true_ai | (t > 0.5))
                                                  .sum()))
    # the splice floor of tests/test_torch_serve.py's served partial-AI case
    check(iou >= 0.6, f"served blobs clip: splice IoU {iou:.3f} < 0.6")
    log(f"served blobs clip (temporal, blend 1): envelope equals the "
        f"in-process one (|Δai_score| {d_ai:.3g}, timeline |Δ| {d_tl:.3g}, "
        f"detector |Δ| {d_det:.3g}); {m} frames, splice IoU {iou:.3f}, "
        f"label {served['result']['label']}")
    rows["served_blobs"] = {"iou": iou, "frames": m}
    return rows


# ---------------------------------------------------------------------------
# training and exported programs
# ---------------------------------------------------------------------------

TRAIN_STEPS = 40             # steps of the full-width fine-tune
TRAIN_POOL = 512             # samples in its device-resident pool
RESUME_AT, RESUME_STEPS = 10, 20  # the resume check: saved at 10 of 20
TIMED_STEPS = 10             # CUDA-event-timed train steps, each remat mode
GRAD_FRAMES = 8              # frames of the card-against-CPU gradient check
FAMILY_STEPS = 5             # steps of each small family at its settings
HELDOUT_N = 256              # frames of the held-out eval after the fine-tune
EVAL_TOOL_N = 64             # frames a draw of the eval tool's calibration
BENCH_BATCH = 64             # the detector bench's batch (224 px)
EXPORTS = [("vit", "full", "detector_full"), ("vit", "moe_small", "moe_small"),
           ("temporal", "small", "temporal_small")]
BENCH_MODES = ("vit", "vit-int8", "cnn", "cnn-int8", "temporal", "vit-fused",
               "vit-exported")


def _recipe(name):
    """Training arguments of a shipped checkpoint's ``train_meta.json``:
    its family, widths, batch, learning rate, schedule (the cosine over
    its whole run: ``schedule_horizon``), logit L2, families and seed."""
    from avd_tpu_torch.models import scoring
    with open(os.path.join(scoring._WEIGHTS_DIR, name,
                           "train_meta.json")) as f:
        m = json.load(f)
    kw = dict(arch=m["arch"], batch=m["batch"], lr=m["lr"],
              image_size=m["image_size"], warmup=m.get("warmup", 0),
              schedule=m.get("schedule", "const"),
              schedule_horizon=m["steps"], logit_l2=m["logit_l2"],
              families=tuple(m["families"]), seed=m["seed"])
    if m["arch"] == "vit":
        kw.update(width=m["width"], depth=m["depth"], heads=m["heads"],
                  experts=m["experts"])
    return kw


def _timed_steps(cfg, family, params, x, y, kw, steps=TIMED_STEPS,
                 profile=None):
    """Train steps on the card: {"step_ms": by CUDA events over ``steps``
    after 3 warm steps, "peak_bytes": of the timed steps}; with
    ``profile`` (a file name under ``chiprun_out/``) also one step under
    the profiler: device-busy ms, device ops, and the ms of the GEMMs
    (cuBLAS) and of the optimizer's multi-tensor kernels."""
    import torch
    from avd_tpu_torch.models import optim
    leaves = optim.leaves_of(params)
    opt = family.make_optimizer(kw["lr"], steps=kw["schedule_horizon"],
                                warmup=kw["warmup"], schedule=kw["schedule"])
    state = opt.init(leaves)
    step = family.make_train_step(cfg, opt, logit_l2=kw["logit_l2"])
    for _ in range(3):
        params, state, loss = step(params, state, x, y)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        params, state, loss = step(params, state, x, y)
    end.record()
    end.synchronize()
    check(np.isfinite(float(loss)), f"train step loss {float(loss)}")
    out = {"step_ms": start.elapsed_time(end) / steps,
           "peak_bytes": torch.cuda.max_memory_allocated()}
    if profile:
        busy, n_dev, avgs = device_profile(lambda: step(params, state, x, y))
        gemm = sum(_kernel_ms(avgs, k)[0] for k in ("gemm", "nvjet",
                                                    "xmma", "cutlass"))
        out.update(busy_ms=busy, device_ops=n_dev, gemm_ms=gemm,
                   optimizer_ms=_kernel_ms(avgs, "multi_tensor_apply")[0])
        os.makedirs("chiprun_out", exist_ok=True)
        with open(os.path.join("chiprun_out", profile), "w") as f:
            f.write(avgs.table(sort_by="self_device_time_total",
                               row_limit=40))
    return out


def phase_training(fb):
    """Phase 27: the shipped ``detector_full`` fine-tuned on the card with
    its own recipe (no codec augmentation: no libav* there), step time and
    peak memory with remat on and off, card against CPU loss and
    gradients, remat against plain gradients, resume against an
    uninterrupted run, the held-out eval, calibration by the eval tool,
    the trained directory served; then a few steps of each small shipped
    family."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from avd_tpu_torch import models
    from avd_tpu_torch.analyzers import video as video_an
    from avd_tpu_torch.models import convert, detector, optim, scoring, train
    from tools import torch_eval_detector
    cuda = torch.device(DEV)
    shipped = scoring._shipped_ckpt("vit", "full")
    check(shipped is not None, "no shipped detector_full")
    kw = _recipe("detector_full")
    rows = {"recipe": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in kw.items()}}
    cfg = detector.make_config("full")
    check((cfg.image_size, cfg.width, cfg.depth, cfg.heads) ==
          (kw["image_size"], kw["width"], kw["depth"], kw["heads"]),
          f"recipe {kw} is not the full preset")
    base = convert.load_checkpoint(shipped, cfg)
    f, y = train.synthetic_batch(np.random.default_rng(5), kw["batch"],
                                 cfg.image_size, kw["families"])
    x, lab = torch.from_numpy(f).to(cuda), torch.from_numpy(y).to(cuda)
    with torch.no_grad():
        cpu_loss = float(detector.loss_fn(base, torch.from_numpy(f),
                                          torch.from_numpy(y), cfg,
                                          logit_l2=kw["logit_l2"]))
    grads = {}
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        params = _on_device(base, cuda)
        loss, grads[remat] = _loss_and_grads(detector, c, params, x, lab,
                                             kw["logit_l2"])
        t = _timed_steps(c, detector, params, x, lab, kw,
                         profile=None if remat else "train_step_profile.txt")
        ms = t["step_ms"]
        rows[f"remat_{'on' if remat else 'off'}"] = dict(
            t, frames_per_s=kw["batch"] / ms * 1e3, loss=loss)
        log(f"train step, full ViT, batch {kw['batch']} at "
            f"{cfg.image_size}², remat {'on' if remat else 'off'}: "
            f"{ms:.3f} ms = {kw['batch'] / ms * 1e3:.1f} train frames/s, "
            f"peak {t['peak_bytes'] / 2**30:.3f} GiB; loss at the shipped "
            f"weights {loss:.6f}"
            + ("" if remat else
               f"; one step on the device: {t['busy_ms']:.3f} ms busy in "
               f"{t['device_ops']} ops (GEMMs {t['gemm_ms']:.3f} ms, "
               f"optimizer {t['optimizer_ms']:.3f} ms), idle share "
               f"{1 - t['busy_ms'] / ms:.4f}"))
    d_loss = abs(rows["remat_off"]["loss"] - cpu_loss)
    check(d_loss <= 1e-4, f"card loss {rows['remat_off']['loss']} vs CPU "
          f"{cpu_loss}: |Δ| {d_loss}")
    rel = max(_rel_l2(a, b) for a, b in zip(grads[True], grads[False]))
    check(rel <= 1e-5, f"remat gradients differ: relative L2 {rel}")
    # the backward against the CPU's on GRAD_FRAMES frames of the batch,
    # each leaf within the relative L2 the CPU is held to against JAX, at
    # a random init: at the shipped weights bf16's rounding alone moves
    # the small gradients of the well-fit model by up to 0.1 (the CPU
    # test test_full_width_bf16_gradients_against_f32), which would hide
    # a fault of the card's backward
    n = GRAD_FRAMES
    init = detector.init_params(0, cfg)
    _, g_cpu = _loss_and_grads(detector, cfg, _on_device(init, "cpu"),
                               torch.from_numpy(f[:n]),
                               torch.from_numpy(y[:n]), kw["logit_l2"])
    _, g_card = _loss_and_grads(detector, cfg, _on_device(init, cuda),
                                x[:n], lab[:n], kw["logit_l2"])
    rels = [_rel_l2(a.cpu(), b) for a, b in zip(g_card, g_cpu)]
    worst = int(np.argmax(rels))
    check(rels[worst] <= 3e-2, f"card gradients against the CPU's: leaf "
          f"{worst} relative L2 {rels[worst]}")
    rows.update(cpu_loss=cpu_loss, card_cpu_loss_abs=d_loss,
                remat_grad_rel_l2=rel, card_cpu_grad_rel_l2=rels[worst],
                card_cpu_grad_worst_leaf=worst)
    log(f"first-step loss card {rows['remat_off']['loss']:.6f} vs CPU "
        f"{cpu_loss:.6f} (|Δ| {d_loss:.3g}); remat vs plain gradients "
        f"relative L2 {rel:.3g}; card vs CPU gradients at a random init "
        f"on {n} frames, {len(rels)} leaves: relative L2 at most "
        f"{rels[worst]:.3g} (leaf {worst}), median "
        f"{float(np.median(rels)):.3g}")

    tmp = tempfile.mkdtemp(prefix="avd_train_")
    try:
        ck = os.path.join(tmp, "fine_tuned")
        t0 = time.perf_counter()
        params, losses = train.train(
            steps=TRAIN_STEPS, out=ck, init_from=shipped,
            cache_samples=TRAIN_POOL, log_every=10,
            device=cuda, **kw)
        wall = time.perf_counter() - t0
        check(len(losses) == TRAIN_STEPS and np.isfinite(losses).all(),
              f"fine-tune losses {losses}")
        rows["fine_tune"] = {"losses": losses, "wall_s": wall}
        log(f"fine-tune: {TRAIN_STEPS} steps from {shipped} in {wall:.1f} s "
            f"(pool of {TRAIN_POOL} and eval included); loss "
            f"{losses[0]:.4f} → {losses[-1]:.4f}")

        # resume: saved at RESUME_AT of RESUME_STEPS, against one run
        small = dict(kw, cache_samples=128, log_every=0,
                     device=cuda)
        straight, l_straight = train.train(steps=RESUME_STEPS,
                                           init_from=shipped, **small)
        rk = os.path.join(tmp, "resume")
        _, l_first = train.train(steps=RESUME_AT, out=rk, init_from=shipped,
                                 **small)
        resumed, l_rest = train.train(steps=RESUME_STEPS, out=rk,
                                      resume=True, **small)
        d_res_loss = float(np.max(np.abs(np.subtract(l_first + l_rest,
                                                     l_straight))))
        d_res_param = max(float((a - b).abs().max()) for a, b in zip(
            optim.leaves_of(straight), optim.leaves_of(resumed)))
        check(d_res_loss <= 1e-5 and d_res_param <= 1e-6,
              f"resumed run differs: losses |Δ| {d_res_loss}, parameters "
              f"|Δ| {d_res_param}")
        rows["resume"] = {"loss_abs": d_res_loss, "param_abs": d_res_param}
        log(f"resume at step {RESUME_AT} of {RESUME_STEPS} against the "
            f"uninterrupted run: losses max |Δ| {d_res_loss}, parameters "
            f"max |Δ| {d_res_param}")

        acc, auc = train.evaluate(params, cfg, n=HELDOUT_N,
                                  families=(train.HELDOUT_FAMILY,),
                                  device=cuda)
        rows["heldout"] = {"acc": acc, "auc": auc}
        _, fams, _, calib, _ = torch_eval_detector.eval_checkpoint(
            "vit", "full", ck, n=EVAL_TOOL_N, jpeg_qualities=(), h264_crfs=(),
            device=cuda)
        torch_eval_detector.write_calibration(ck, calib, 999)
        rows["calibration"] = calib
        log(f"held-out {train.HELDOUT_FAMILY}: accuracy {acc:.3f} AUC "
            f"{auc:.3f}; eval tool: T {calib['temperature']:.3f} "
            f"(draws {[d['kind'] for d in calib['fit']['draws']]}), "
            + ", ".join(f"{k} AUC {v[1]:.3f}" for k, v in fams.items()))

        _set_env(AVD_DETECTOR="1", AVD_DETECTOR_CKPT=ck,
                 AVD_DETECTOR_PRESET=None, AVD_ATTN_FUSED=None,
                 AVD_DETECTOR_ARCH=None, AVD_DETECTOR_BLEND=None)
        try:
            out = video_an.analyze_batch(fb, device=cuda)
        finally:
            _set_env(AVD_DETECTOR=None, AVD_DETECTOR_CKPT=None)
        check("detector_error" not in out,
              f"trained checkpoint: detector_error {out.get('detector_error')}")
        tl = np.asarray(out["detector"]["timeline"])
        check(tl.shape == (FRAMES_MAIN,) and np.isfinite(tl).all()
              and out["detector"]["weights"].startswith(ck),
              f"trained checkpoint served {tl.shape}, weights "
              f"{out['detector']['weights']}")
        log(f"trained checkpoint served through AVD_DETECTOR_CKPT: "
            f"{FRAMES_MAIN} frames, weights {out['detector']['weights']}")

        for name in ("cnn_small", "temporal_small", "moe_small"):
            fk = _recipe(name)
            fam_mod = models.family(fk["arch"])
            _, fam_losses = train.train(steps=FAMILY_STEPS,
                                        cache_samples=256, log_every=0,
                                        device=cuda, **fk)
            check(np.isfinite(fam_losses).all(),
                  f"{name}: losses {fam_losses}")
            _, fcfg = train._config(fk["arch"], fk["image_size"],
                                    fk.get("width", 256), fk.get("depth", 4),
                                    fk.get("heads", 4), fk.get("experts", 0),
                                    False)
            rng = np.random.default_rng(6)
            if fk["arch"] == "temporal":
                fx, fy = fam_mod.synthetic_sequences(
                    rng, fk["batch"], 8, fk["image_size"], fk["families"])
                n_frames = fk["batch"] * 8
            else:
                fx, fy = train.synthetic_batch(rng, fk["batch"],
                                               fk["image_size"],
                                               fk["families"])
                n_frames = fk["batch"]
            fp = _on_device(fam_mod.init_params(fk["seed"], fcfg), cuda)
            t = _timed_steps(
                fcfg, fam_mod, fp, torch.from_numpy(fx).to(cuda),
                torch.from_numpy(fy).to(cuda), fk, steps=5)
            ms = t["step_ms"]
            rows[name] = dict(t, losses=fam_losses,
                              frames_per_s=n_frames / ms * 1e3)
            log(f"train {name}: losses {fam_losses[0]:.4f} → "
                f"{fam_losses[-1]:.4f}; step {ms:.3f} ms = "
                f"{n_frames / ms * 1e3:.1f} train frames/s, peak "
                f"{t['peak_bytes'] / 2**30:.3f} GiB")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def _loss_and_grads(family, cfg, params, x, y, logit_l2):
    """(loss, f32 gradient of every leaf) of ``family.loss_fn`` at
    ``params``, which are left without ``requires_grad``."""
    import torch
    from avd_tpu_torch.models import optim
    leaves = optim.leaves_of(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = family.loss_fn(params, x, y, cfg, logit_l2=logit_l2)
    grads = [g.float() for g in torch.autograd.grad(loss, leaves)]
    for p in leaves:
        p.requires_grad_(False)
    return float(loss.detach()), grads


def _rel_l2(a, b):
    import torch
    return float(torch.linalg.norm(a - b) / max(torch.linalg.norm(b), 1e-30))


def _on_device(tree, dev):
    """A detached f32 copy of a parameter tree on ``dev``."""
    import torch
    from avd_tpu_torch.models.detector import _map_tree
    return _map_tree(lambda _, v: v.detach().to(dev, torch.float32).clone(),
                     tree)


def phase_exported(frames):
    """Phase 28: ``detector_full``, ``moe_small`` and ``temporal_small``
    exported on the card and served through ``AVD_DETECTOR_EXPORTED`` on
    the 145 frames against the eager bundle (1e-3); a tampered artifact
    raises; the exported call's ms, device-busy ms and device ops against
    the eager call's; a program traced on the CPU, moved to the card."""
    import shutil
    import tempfile

    import torch
    from avd_tpu_torch.models import export, scoring
    cuda = torch.device(DEV)
    rows = {}
    tmp = tempfile.mkdtemp(prefix="avd_export_")
    try:
        for arch, preset, name in EXPORTS:
            out = os.path.join(tmp, name)
            t0 = time.perf_counter()
            manifest = export.export_detector(out, arch=arch, preset=preset,
                                              device=cuda)
            export_s = time.perf_counter() - t0
            _family_env({"AVD_DETECTOR_ARCH": arch,
                         "AVD_DETECTOR_PRESET": preset})
            eager = scoring.detector_timeline(frames, device=cuda)
            e_bundle = scoring._bundle(cuda)
            size = e_bundle[0].image_size
            _family_env({"AVD_DETECTOR_EXPORTED": out})
            t0 = time.perf_counter()
            x_bundle = scoring._bundle(cuda)
            load_s = time.perf_counter() - t0
            served = scoring.detector_timeline(frames, device=cuda)
            check(served["weights"].startswith("exported:")
                  and served["weights"] == "exported:" + eager["weights"],
                  f"{name}: weights {served['weights']}")
            d = float(np.max(np.abs(np.subtract(served["timeline"],
                                                eager["timeline"]))))
            check(len(served["timeline"]) == FRAMES_MAIN and d <= 1e-3,
                  f"{name}: exported vs eager |Δ| {d}")
            # one call of each at the traced shape
            n = manifest.get("batch") or manifest["window"]
            batch = scoring._pad(scoring._prep_frames(frames[:n], size), n)
            xb = torch.from_numpy(np.ascontiguousarray(batch)).to(cuda)
            args = (xb, n) if "window" in manifest else (xb,)
            calls = {}
            for kind, b in (("exported", x_bundle), ("eager", e_bundle)):
                ms = time_ms(lambda: b[2](*args), reps=10)
                busy, n_dev, _ = device_profile(lambda: b[2](*args))
                calls[kind] = {"ms": ms, "busy_ms": busy, "device_ops": n_dev}
            rows[name] = {"export_s": export_s, "load_s": load_s,
                          "program_bytes": manifest["program_bytes"],
                          "max_abs": d, "shape": n, "calls": calls}
            log(f"exported {name}: traced in {export_s:.1f} s, "
                f"{manifest['program_bytes'] / 1e6:.1f} MB, loaded in "
                f"{load_s:.2f} s; {FRAMES_MAIN} frames vs eager max |Δ| "
                f"{d:.3g}; one call at {n} frames, exported / eager: "
                + ", ".join(f"{k} {calls['exported'][k]:.3f} / "
                            f"{calls['eager'][k]:.3f}"
                            for k in ("ms", "busy_ms"))
                + f", device ops {calls['exported']['device_ops']} / "
                f"{calls['eager']['device_ops']}")
        # a tampered copy of the last artifact
        bad = os.path.join(tmp, "tampered")
        shutil.copytree(out, bad)
        with open(os.path.join(bad, export.PROGRAM_FILE), "ab") as f:
            f.write(b"\0")
        try:
            export.load_bundle(bad, cuda)
            raise PhaseError("a tampered artifact loaded")
        except ValueError as e:
            check("sha256" in str(e), f"tampered artifact: {e}")
        # traced on the CPU, served on the card
        cpu_out = os.path.join(tmp, "detector_full_cpu")
        export.export_detector(cpu_out, arch="vit", preset="full",
                               device="cpu")
        _family_env({"AVD_DETECTOR_EXPORTED": cpu_out})
        moved = scoring.detector_timeline(frames, device=cuda)
        _family_env({})
        eager = scoring.detector_timeline(frames, device=cuda)
        d_cpu = float(np.max(np.abs(np.subtract(moved["timeline"],
                                                eager["timeline"]))))
        check(d_cpu <= 1e-3, f"CPU-traced program on the card |Δ| {d_cpu}")
        rows["cpu_traced_on_card_max_abs"] = d_cpu
        log(f"tampered artifact raises; detector_full traced on the CPU and "
            f"moved to the card: max |Δ| {d_cpu:.3g} against eager")
    finally:
        _set_env(**{k: None for k in _FAMILY_ENV})
        shutil.rmtree(tmp, ignore_errors=True)
    return rows


def phase_detector_bench():
    """Phase 29: ``tools/torch_bench_detector.py`` at 224 px, batch 64."""
    from tools import torch_bench_detector
    rows = {}
    for mode in BENCH_MODES:
        r = torch_bench_detector.bench(mode, BENCH_BATCH, DEV)
        check(r["frames_per_s"] > 0 and r["flops_per_frame"] > 0,
              f"bench {mode}: {r}")
        rows[mode] = r
        log("bench " + torch_bench_detector.line(r))
    return rows


# ---------------------------------------------------------------------------
# inference parallelism over a rank group
# ---------------------------------------------------------------------------

PAR_PROGRAMS = ("cp", "cp_iter", "vit_dm", "gpipe", "moe_ep", "dp_pp_tp",
                "temporal_ring", "temporal_ulysses")
PAR_RANKS = 4
PROBE_TIMEOUT_S = 120
RANKS_TIMEOUT_S = 600


def _par_programs(names):
    """dryrun's programs by name; ``cp_iter`` is ``cp`` with the fused
    Farnebäck round (``AVD_PALLAS_ITER=1``'s ``flow_iter`` kernel)."""
    return [{"name": "cp_iter", "kind": "cp", "fused_iter": True}
            if n == "cp_iter" else n for n in names]


def phase_nccl_probe():
    """Phase 30: two NCCL ranks on the one card (NCCL is expected to
    refuse them: "Duplicate GPU detected").  What NCCL said is printed;
    neither outcome fails the phase.  (Which collectives gloo takes on
    CUDA tensors unstaged: ``python -m avd_tpu_torch.parallel.dryrun
    --probe-gloo``.)"""
    from avd_tpu_torch.parallel import dryrun
    out = {}
    t0 = time.perf_counter()
    try:
        ranks = dryrun.launch(2, DEV, [{"name": "probe",
                                        "kind": "probe_all_reduce"}],
                              backend="nccl", timeout_s=PROBE_TIMEOUT_S)
        out["nccl_two_ranks"] = "accepted: psum " + str(
            ranks[0]["programs"]["probe"]["outputs"]["sum"].tolist())
    except dryrun.RankFailed as e:
        lines = [ln for ln in str(e).splitlines() if ln.strip()]
        said = [ln for ln in lines if "Duplicate GPU" in ln or "NCCL" in ln]
        out["nccl_two_ranks"] = "refused: " + " | ".join(
            (said or lines[-1:])[-3:])[:600]
    log(f"NCCL, two ranks on one card ({time.perf_counter() - t0:.1f} s): "
        f"{out['nccl_two_ranks']}")
    return out


def _par_inputs(frames):
    """The programs' arrays from the main path's 145 1080p frames: their
    host-prep planes and the frames resized to 224 and 64."""
    from avd_tpu_torch.ops import host_prep
    from avd_tpu_torch.parallel import dryrun
    spec = dryrun.full_spec()
    t0 = time.perf_counter()
    inputs = dryrun.make_inputs(spec, frames, host_prep.host_prep(frames))
    shapes = ", ".join(f"{k} {list(v.shape)}" for k, v in inputs.items())
    log(f"parallel inputs: {shapes} ({time.perf_counter() - t0:.1f} s)")
    return spec, inputs


def _par_row(rep):
    return (f"{rep['ms']:.2f} ms, collectives {rep['collectives']}, "
            f"launches {rep['launches']}")


def phase_parallel_world1(frames):
    """Phase 31: every program on a group of one rank over NCCL, in this
    process, against its single-device result."""
    import torch
    from avd_tpu_torch.parallel import dryrun
    spec, inputs = _par_inputs(frames)
    programs = _par_programs(PAR_PROGRAMS)
    t0 = time.perf_counter()
    single_ms = {}
    ref = dryrun.reference(programs + ["scoring"], inputs, spec, DEV, frames,
                           times=single_ms, reps=2)
    torch.cuda.synchronize()
    log(f"parallel: single-device references in "
        f"{time.perf_counter() - t0:.1f} s; warm ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in single_ms.items()))
    _reset_counters()
    rep = dryrun.run_in_process(programs, inputs, spec, DEV, "nccl", reps=2)
    launches = _counters()
    rows = {}
    for name, r in rep["programs"].items():
        err = dryrun.check(name, r["outputs"], ref[name])
        nccl = sum(v for k, v in r["collectives"].items()
                   if k.endswith("/nccl"))
        check(r["collectives"]["staged"] == 0, f"{name} staged on NCCL")
        rows[name] = {"ms": r["ms"], "single_device_ms": single_ms[name],
                      "max_abs_err": err, "nccl_calls": nccl,
                      "collectives": r["collectives"],
                      "launches": r["launches"], "mesh": r["mesh"]}
        log(f"world 1 NCCL {name}: {_par_row(r)}, max |Δ| {err:.3g}")
    cp, it = rows["cp"]["launches"], rows["cp_iter"]["launches"]
    check(cp["warp_bilinear"] > 0 and cp["box_blur_solve"] > 0
          and cp["solve_iteration"] == 0, f"cp launches {cp}")
    check(it["solve_iteration"] > 0 and it["warp_bilinear"] == 0,
          f"cp with the fused round: launches {it}")
    check(sum(r["nccl_calls"] for r in rows.values()) > 0,
          "no NCCL call at world 1")
    log(f"world 1 NCCL: launches over the programs {launches}")
    rows["scoring"] = {"single_device_ms": single_ms["scoring"]}
    return spec, inputs, ref, rows, launches


def phase_parallel_ranks(spec, inputs, ref):
    """Phase 32: the programs and scoring's sharded branch on 4 ranks
    sharing the card over gloo (host-staged collectives), every rank's
    result against the single-device one."""
    from avd_tpu_torch.parallel import dryrun
    programs = _par_programs(PAR_PROGRAMS) + ["scoring"]
    t0 = time.perf_counter()
    ranks = dryrun.launch(PAR_RANKS, DEV, programs, inputs=inputs, spec=spec,
                          reps=2, timeout_s=RANKS_TIMEOUT_S)
    log(f"{PAR_RANKS} ranks over gloo on one card: launch "
        f"{time.perf_counter() - t0:.1f} s")
    rows = {}
    for name in [p if isinstance(p, str) else p["name"] for p in programs]:
        per = []
        for r in ranks:
            rep = r["programs"][name]
            err = dryrun.check(name, rep["outputs"], ref[name])
            check(rep["collectives"]["staged"] > 0,
                  f"{name} on rank {r['rank']}: nothing staged over gloo")
            per.append({"ms": rep["ms"], "max_abs_err": err,
                        "collectives": rep["collectives"],
                        "launches": rep["launches"]})
            log(f"{PAR_RANKS} ranks {name} rank {r['rank']}: "
                f"{_par_row(rep)}, max |Δ| {err:.3g}")
        rows[name] = {"mesh": ranks[0]["programs"][name]["mesh"],
                      "ranks": per}
    for r in rows["cp"]["ranks"]:
        check(r["launches"]["warp_bilinear"] > 0
              and r["launches"]["box_blur_solve"] > 0,
              f"cp rank launches {r['launches']}")
    for r in rows["cp_iter"]["ranks"]:
        check(r["launches"]["solve_iteration"] > 0,
              f"cp with the fused round: rank launches {r['launches']}")
    return rows


TRAIN_PAR_PROGRAMS = ("dp_tp_train", "zero1", "fsdp", "pp_train",
                      "pp_tp_train")
# the single-device step each program is held to: the dp/tp programs share
# one (the same loss and optimizer), the pipelined ones another (BCE alone)
TRAIN_PAR_REFERENCE = {"dp_tp_train": "dp_tp_train", "zero1": "dp_tp_train",
                       "fsdp": "dp_tp_train", "pp_train": "pp_train",
                       "pp_tp_train": "pp_train"}


def _train_par_row(name, rep, ref):
    """A training program's row: held to its single-device step
    (``dryrun.check``), with warm ms per step, peak memory and the
    collectives."""
    from avd_tpu_torch.parallel import dryrun
    try:
        rel = dryrun.check(name, rep["outputs"], ref)
    except AssertionError as e:
        raise PhaseError(str(e)) from None
    info = rep["info"]
    out = rep["outputs"]
    row = {"mesh": rep["mesh"], "step_ms": info["step_ms"],
           "warm_step_ms": statistics.mean(info["step_ms"]),
           "peak_gib": info["peak_bytes"] / 2**30,
           "loss": out["loss"].tolist(),
           "loss_abs_err": float(np.max(np.abs(out["loss"] - ref["loss"]))),
           "max_leaf_rel_l2": rel,
           "max_grad_rel_l2": max(dryrun.leaf_rel_l2(out, ref, "g").values()),
           "grad_norm": float(out["grad_norm"]),
           "collectives": rep["collectives"],
           "step_collectives": info["step_collectives"],
           "launches": rep["launches"],
           **{k: info[k] for k in ("param_numel", "moment_numel",
                                   "tree_numel", "data_sliced_params",
                                   "data_sliced_moments")}}
    if "loss_replicated" in out:
        row["loss_vs_replicated_abs"] = float(np.max(np.abs(
            out["loss"] - out["loss_replicated"])))
    return row


def _train_par_log(where, name, row):
    log(f"{where} {name}: {row['warm_step_ms']:.2f} ms a step (steps "
        + ", ".join(f"{t:.2f}" for t in row["step_ms"])
        + f"), peak {row['peak_gib']:.3f} GiB, loss |Δ| "
        f"{row['loss_abs_err']:.3g}, parameters' relative L2 <= "
        f"{row['max_leaf_rel_l2']:.3g} (first gradients "
        f"{row['max_grad_rel_l2']:.3g}, clip norm {row['grad_norm']:.6g}), "
        f"collectives of the steps "
        f"{row['step_collectives']} (of the program with its gathers "
        f"{row['collectives']})")


def phase_train_parallel(spec, inputs):
    """Phase 33: rank-group training at full width: the shipped
    ``detector_full`` at batch 64 with its recipe (lr 1e-4, logit L2
    0.02), 3 steps of each of ``TRAIN_PAR_PROGRAMS`` (the second of two
    runs: warm), on one NCCL rank in this process and on 4 gloo ranks
    sharing the card, each against ``dryrun.reference``'s single-device
    steps on the card (loss 2e-2, ZeRO-1 against its replicated step at
    rtol 1e-5, every leaf's first gradient and final value 3e-2 in
    relative L2, the clip's global norm against the gathered gradients'
    rtol 1e-5); warm ms a step, peak memory a rank and collectives by
    kind and transport (``chiprun_out/train_parallel.json``).  The slice
    launches none of the hand-written kernels (training keeps the einsum
    attention, as ``avd_tpu`` does): the launches of the in-process run
    and of every rank are checked to be none."""
    import torch
    from avd_tpu_torch.parallel import dryrun
    t0 = time.perf_counter()
    single_ms = {}
    refs = dryrun.reference(sorted(set(TRAIN_PAR_REFERENCE.values())),
                            inputs, spec, DEV, times=single_ms, reps=2)
    torch.cuda.synchronize()
    log(f"rank-group training: single-device references in "
        f"{time.perf_counter() - t0:.1f} s (3 steps and one gradient each, "
        "warm: " + ", ".join(f"{k} {v:.1f} ms" for k, v in single_ms.items())
        + ")")
    rows = {"single_device_step_ms": {k: r["step_ms"].tolist()
                                      for k, r in refs.items()}}
    log("one device, ms a step (warm): " + "; ".join(
        f"{k} " + ", ".join(f"{t:.2f}" for t in v)
        for k, v in rows["single_device_step_ms"].items()))
    _reset_counters()
    t0 = time.perf_counter()
    rep = dryrun.run_in_process(list(TRAIN_PAR_PROGRAMS), inputs, spec, DEV,
                                "nccl", reps=2)
    rows["world1_nccl"] = {}
    for name in TRAIN_PAR_PROGRAMS:
        r = rep["programs"][name]
        row = _train_par_row(name, r, refs[TRAIN_PAR_REFERENCE[name]])
        check(r["collectives"]["staged"] == 0, f"{name} staged on NCCL")
        check(any(k.endswith("/nccl") for k in r["collectives"]),
              f"{name}: no NCCL call at world 1")
        rows["world1_nccl"][name] = row
        _train_par_log("world 1 NCCL", name, row)
    log(f"world 1 NCCL training: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    ranks = dryrun.launch(PAR_RANKS, DEV, TRAIN_PAR_PROGRAMS, inputs=inputs,
                          spec=spec, reps=2, timeout_s=RANKS_TIMEOUT_S)
    rows[f"ranks_{PAR_RANKS}_gloo"] = {}
    for name in TRAIN_PAR_PROGRAMS:
        per = []
        for r in ranks:
            rep_r = r["programs"][name]
            row = _train_par_row(name, rep_r, refs[TRAIN_PAR_REFERENCE[name]])
            check(rep_r["collectives"]["staged"] > 0,
                  f"{name} on rank {r['rank']}: nothing staged over gloo")
            check(not any(row["launches"].get(k) for k in _kernel_modules()),
                  f"{name} on rank {r['rank']} launched kernels: "
                  f"{row['launches']}")
            per.append(row)
            _train_par_log(f"{PAR_RANKS} ranks rank {r['rank']}", name, row)
        rows[f"ranks_{PAR_RANKS}_gloo"][name] = per
    ranks_rows = rows[f"ranks_{PAR_RANKS}_gloo"]
    moments = [r["data_sliced_moments"] for r in ranks_rows["zero1"]]
    check(min(moments) >= 8, f"ZeRO-1 moments not sliced: {moments}")
    sliced = [r["data_sliced_params"] for r in ranks_rows["fsdp"]]
    check(min(sliced) >= 8, f"FSDP parameters not sliced: {sliced}")
    launches = _counters()
    rows["kernel_launches_world1"] = launches
    check(not any(launches[k] for k in _kernel_modules()),
          f"rank-group training launched kernels: {launches}")
    log(f"{PAR_RANKS} ranks over gloo, training: "
        f"{time.perf_counter() - t0:.1f} s; peak GiB a rank (dp x tp / "
        "ZeRO-1 / FSDP): " + " / ".join(
            f"{max(r['peak_gib'] for r in ranks_rows[n]):.3f}"
            for n in ("dp_tp_train", "zero1", "fsdp")))
    return rows


# ---------------------------------------------------------------------------
# phase 34: one served worker over a rank group
# ---------------------------------------------------------------------------

GROUP_UPLOADS = 4  # concurrent uploads of the 1080p mp4 from 4 clients


def _metrics(url):
    import urllib.request
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        return json.loads(r.read())["metrics"]


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    try:  # a zombie is gone for our purposes
        with open(f"/proc/{pid}/stat") as f:
            return f.read().split(")")[-1].split()[0] != "Z"
    except OSError:
        return False


def _wait_gone(pids, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while any(_alive(p) for p in pids):
        check(time.monotonic() < deadline,
              f"{what}: pids {[p for p in pids if _alive(p)]} still alive")
        time.sleep(0.2)


def _group_of(master, exclude=(), timeout=240.0):
    """The serving group's state (``/metrics``'s ``group``) once a group
    other than ``exclude``'s leader serves."""
    deadline = time.monotonic() + timeout
    while True:
        master.assert_clean()
        try:
            g = _metrics(master.url).get("group")
        except OSError:
            g = None
        if g and g["pids"][0] not in exclude:
            return g
        check(master.proc.poll() is None,
              f"master exited {master.proc.returncode}:\n"
              f"{master.text()[-3000:]}")
        check(time.monotonic() < deadline,
              f"no group served after {timeout:.0f} s:\n"
              f"{master.text()[-3000:]}")
        time.sleep(0.25)


def _same_group_served(served, ref, what, cp=False):
    """A group's envelope against the one-card one: the label, |Δai_score|
    <= 1e-3, the detector timeline within 2e-2; the heuristic timeline
    within 1e-6 (streaming: the leader's own path) or, with the
    context-parallel pairs, the flow stats at rtol 1e-5."""
    from avd_tpu_torch import schema
    schema.validate(served)
    for key in ("video_error", "audio_error"):
        check(key not in served["hints"],
              f"{what}: {key} {served['hints'].get(key)}")
    check("detector_error" not in served["video"],
          f"{what}: detector_error {served['video'].get('detector_error')}")
    check(served["result"]["label"] == ref["result"]["label"],
          f"{what}: label {served['result']} against {ref['result']}")
    d_ai = abs(served["result"]["ai_score"] - ref["result"]["ai_score"])
    check(d_ai <= 1e-3, f"{what}: |Δai_score| {d_ai}")
    d_det = float(np.max(np.abs(np.subtract(
        served["video"]["detector"]["timeline"],
        ref["video"]["detector"]["timeline"]))))
    check(d_det <= 2e-2, f"{what}: detector timeline |Δ| {d_det}")
    a, b = served["video"]["timeline"], ref["video"]["timeline"]
    d_tl = float(np.max(np.abs(np.subtract(a, b))))
    if cp:
        for k in ("flow_mean", "flow_var"):
            x, y = served["video"]["summary"][k], ref["video"]["summary"][k]
            check(abs(x - y) <= 1e-5 * abs(y) + 1e-9,
                  f"{what}: {k} {x} against {y}")
        check(d_tl <= 1e-5, f"{what}: heuristic timeline |Δ| {d_tl}")
    else:
        check(d_tl <= TIMELINE_EQ, f"{what}: heuristic timeline |Δ| {d_tl}")
    return {"d_ai_score": d_ai, "d_detector": d_det, "d_timeline": d_tl}


def _timed_rows(client, single_s, ref, what):
    """Latency rows: 1 client from the single upload before (``single_s``),
    4 clients from one round of ``GROUP_UPLOADS`` concurrent uploads, each
    envelope held to ``ref``."""
    w, lats, raws = _timed_requests(client, MP4_1080P, 4, GROUP_UPLOADS)
    for i, raw in enumerate(raws):
        _same_group_served(raw, ref, f"{what} 4 clients #{i}")
    return {"clients_1": _latency_row([single_s], [single_s], 1),
            "clients_4": _latency_row([w], lats, 4)}


def _rank_diff(before, after, key):
    out = []
    for b, a in zip(before["ranks"], after["ranks"]):
        out.append({k: a[key].get(k, 0) - b[key].get(k, 0)
                    for k in a[key] if a[key].get(k, 0) != b[key].get(k, 0)})
    return out


def _served_group(label, args, size, refs, card, modes, kill):
    """One group (``args`` to the master) with the detector on, a master
    for each of ``modes``: ``stream`` (uploads, rounds from 1 and 4
    clients, ``kill``: a follower killed and the group respawned) and
    ``batch``, ``AVD_STREAM=0`` (the context-parallel pairs: every rank's
    launches); each stopped, no process of theirs left."""
    import re
    import torch
    from avd_tpu_torch.client import Client
    kind = torch.cuda.get_device_name(0)
    row = {"args": list(args), "size": size}
    for mode in modes:
        env = {"WEB_CONCURRENCY": "1", "GUNICORN_THREADS": "4",
               "AVD_DETECTOR": "1"}
        if mode == "batch":
            env["AVD_STREAM"] = "0"
        master = MasterProc(f"group_{label}_{mode}", args, **env)
        pids = set()
        try:
            t0 = time.perf_counter()
            g = _group_of(master)
            boot_s = time.perf_counter() - t0
            pids |= set(g["pids"])
            check(g["size"] == size and len(g["pids"]) == size,
                  f"group {label}: {g}")
            c = Client(master.url, timeout=600, retries=0)
            ready = c.wait_ready(timeout_s=60, poll_s=0.5)
            check(ready["cuda"]["devices"] == size
                  and ready["cuda"]["kind"] == kind,
                  f"group {label} /readyz {ready['cuda']}")
            before = _metrics(master.url)["group"]
            t1 = time.perf_counter()
            served = c.analyze(MP4_1080P).raw
            wall = time.perf_counter() - t1
            after = _metrics(master.url)["group"]
            res = {"boot_to_warm_s": boot_s, "upload_s": wall,
                   "backend": g["backend"], "pids": g["pids"],
                   "diff": _same_group_served(served, refs[mode],
                                              f"group {label} {mode}",
                                              cp=mode == "batch"),
                   "calls": after["calls"],
                   "launches": _rank_diff(before, after, "launches"),
                   "collectives": _rank_diff(before, after, "collectives")}
            if mode == "batch":
                for r, ls in enumerate(res["launches"]):
                    check(ls.get("warp_bilinear", 0) > 0
                          and ls.get("box_blur_solve", 0) > 0,
                          f"group {label} AVD_STREAM=0: rank {r} launches "
                          f"{res['launches']}")
                check(after["calls"]["cp_pairs"]["n"] >= 2,
                      f"group {label}: calls {after['calls']}")
                # compute over the world group's transport, the dispatch
                # (one broadcast an array: 2 planes, the frames) over gloo
                how = "nccl" if g["backend"] == "nccl" else "gloo-staged"
                for r, cs in enumerate(res["collectives"]):
                    check(cs.get(f"psum/{how}", 0) > 0
                          and cs.get(f"all_gather/{how}", 0) > 0
                          and cs.get("broadcast/gloo", 0) == 3,
                          f"group {label} AVD_STREAM=0: rank {r} "
                          f"collectives {cs}")
            else:
                res["score_call_ms"] = after["calls"]["score_resized"][
                    "last_ms"]
            if mode == "stream":
                res.update(_timed_rows(c, wall, refs[mode], f"group {label}"))
            if mode == "stream" and kill:
                dead = master.text().count("rank group failed")
                os.kill(g["pids"][1], 9)
                t2 = time.perf_counter()
                deadline = time.monotonic() + 120
                while master.text().count("rank group failed") == dead:
                    check(time.monotonic() < deadline,
                          f"group {label}: a killed follower went unseen")
                    time.sleep(0.1)
                g2 = _group_of(master, exclude=g["pids"][:1])
                pids |= set(g2["pids"])
                res["respawn_s"] = time.perf_counter() - t2
                _wait_gone(g["pids"], f"group {label}: the killed group")
                res["after_kill"] = _same_group_served(
                    c.analyze(MP4_1080P).raw, refs[mode],
                    f"group {label} after a killed follower")
                check(re.search(rf"worker {g['pids'][0]} died \(exit 4\)",
                                master.text()) is not None,
                      f"group {label}: leader exit code:\n"
                      f"{master.text()[-2000:]}")
            row[mode] = res
        finally:
            text = master.stop()
        check(master.proc.returncode == 0,
              f"group {label} master exit {master.proc.returncode}")
        _wait_gone(sorted(pids), f"group {label} {mode} after SIGTERM")
        check("Traceback" not in text and "warmup skipped" not in text,
              f"group {label} log:\n{text[-3000:]}")
    return row


def _served_one_card(refs):
    """The baseline in the same run: one worker on one card
    (``CUDA_VISIBLE_DEVICES=0``: today's path, no group), streaming with
    the detector, the same uploads as the groups'."""
    from avd_tpu_torch.client import Client
    master = MasterProc("group_one_card", (), CUDA_VISIBLE_DEVICES="0",
                        WEB_CONCURRENCY="1", GUNICORN_THREADS="4",
                        AVD_DETECTOR="1")
    try:
        t0 = time.perf_counter()
        master.wait_log("serving on")
        res = {"boot_to_warm_s": time.perf_counter() - t0}
        c = Client(master.url, timeout=600, retries=0)
        ready = c.wait_ready(timeout_s=60, poll_s=0.5)
        check(ready["cuda"]["devices"] == 1 and
              "group" not in _metrics(master.url),
              f"one-card worker: /readyz {ready['cuda']}")
        t1 = time.perf_counter()
        served = c.analyze(MP4_1080P).raw
        res["upload_s"] = time.perf_counter() - t1
        res["diff"] = _same_group_served(served, refs["stream"],
                                         "one-card worker")
        res.update(_timed_rows(c, res["upload_s"], refs["stream"],
                               "one-card worker"))
    finally:
        text = master.stop()
    check("Traceback" not in text and "rank group" not in text,
          f"one-card worker log:\n{text[-3000:]}")
    return res


def phase_served_groups(card):
    """One served worker over a rank group (``serve/group.py``): (a) one
    NCCL rank joined through a store, (b) 2 gloo ranks sharing the card,
    (c) one NCCL rank a card where there are two or more; each with the
    1080p mp4 and the shipped full ViT, streaming and ``AVD_STREAM=0``,
    against the one-card envelopes; boot-to-warm, the warm group scoring
    call against the one-card call, requests/s and latency beside a
    one-card worker's."""
    import torch
    from avd_tpu_torch import pipeline
    from avd_tpu_torch.models import scoring
    check(os.path.exists(MP4_1080P), f"{MP4_1080P} was not written")
    cuda = torch.device(DEV)
    refs = {}
    _set_env(AVD_DETECTOR="1", AVD_ATTN_FUSED=None, AVD_DETECTOR_PRESET=None,
             AVD_DETECTOR_CKPT=None, AVD_DETECTOR_BLEND=None,
             AVD_DETECTOR_SLAB=None)
    try:
        for mode, stream in (("stream", "1"), ("batch", "0")):
            _set_env(AVD_STREAM=stream)
            refs[mode] = pipeline.analyze_path(MP4_1080P, device=cuda)
        _set_env(AVD_STREAM=None)
        resized = scoring.resize_frames(
            pan_frames(FRAMES_MAIN, H_MAIN, W_MAIN),
            scoring.input_size(cuda))

        def one_card():
            scoring.detector_timeline_resized(resized, cuda)
            torch.cuda.synchronize()
        # the first call builds the bundle: the median of the warm four
        one_card_ms = statistics.median(_wall_ms(one_card, reps=5)[1:])
    finally:
        _set_env(AVD_DETECTOR=None, AVD_STREAM=None)
    torch.cuda.empty_cache()  # the groups share the card with this process
    out = {"card": card, "one_card_score_ms": one_card_ms,
           "one_card_worker": _served_one_card(refs), "groups": {}}
    base = out["one_card_worker"]
    log(f"served one-card worker (CUDA_VISIBLE_DEVICES=0, no group) on "
        f"{card}: boot-to-warm {base['boot_to_warm_s']:.2f} s; upload "
        f"{base['upload_s']:.3f} s; |Δ| {base['diff']}; "
        + "; ".join(_fmt_row(base[f"clients_{k}"]) for k in (1, 4)))
    # (a) streams only: (b) and (c) serve the context-parallel pairs
    both = ("stream", "batch")
    groups = [("a_nccl_1", ["--group-size", "1"], 1, ("stream",), False),
              ("b_gloo_2", ["--group-size", "2", "--dist-backend", "gloo"],
               2, both, True)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:  # the default: every visible card, NCCL
        groups.append((f"c_nccl_{n_cards}", [], n_cards, both, True))
    else:
        log("served groups: (c) one NCCL rank a card not run: "
            f"{n_cards} card visible")
    for label, args, size, modes, kill in groups:
        row = _served_group(label, args, size, refs, card, modes, kill)
        out["groups"][label] = row
        st = row["stream"]
        log(f"served group {label} ({size} rank(s), {st['backend']}) on "
            f"{card}: boot-to-warm {st['boot_to_warm_s']:.2f} s (streaming"
            f" master); warm group scoring call (145 frames, bucket 256) "
            f"{st['score_call_ms']:.2f} ms against {one_card_ms:.2f} ms on "
            f"one card; upload streaming {st['upload_s']:.3f} s; |Δ| "
            f"{st['diff']}")
        if "batch" in row:
            ba = row["batch"]
            log(f"served group {label} AVD_STREAM=0 on {card}: boot-to-warm "
                f"{ba['boot_to_warm_s']:.2f} s; upload {ba['upload_s']:.3f} "
                f"s; |Δ| {ba['diff']}; launches a rank {ba['launches']}; "
                f"collectives a rank {ba['collectives']}")
        for clients in (1, 4):
            if f"clients_{clients}" in st:
                log(f"served group {label} on {card}: "
                    + _fmt_row(st[f"clients_{clients}"]))
        if "respawn_s" in st:
            log(f"served group {label} on {card}: a killed follower: the "
                f"group respawned and served in {st['respawn_s']:.2f} s; "
                f"|Δ| {st['after_kill']}")
    with open(os.path.join("chiprun_out", "served_groups.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def kernel_entry(name, source, replaces, rows, max_err, launches):
    ms = ROUNDS * sum(r[1] for r in rows)
    plain = ROUNDS * sum(r[2] for r in rows)
    lib = None if rows[0][3] is None else ROUNDS * sum(r[3] for r in rows)
    bnd = ROUNDS * sum(r[4] for r in rows)
    by = "bytes" if all(r[5] == "bytes" for r in rows) else "operations"
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
            "library_ms": lib,
            "unit": f"one full window: {ROUNDS} launches at each of "
                    f"[{PAIRS},5,H,W], H=W in {list(LEVELS)}",
            "per_level_ms": {str(r[0]): r[1] for r in rows}}


def mha_entry(rows, max_err, launches):
    """The attention kernel on the detector path: ``VIT_DEPTH`` launches at
    the 256-frame bucket per 145-frame clip (the ``full`` ViT; the MoE
    scoring call's launches are added as ``moe_small_launches``)."""
    shape, ms, plain, lib, bnd, by = rows[0]
    return {"name": "mha", "route": "cuda",
            "source": "avd_tpu_torch/csrc/attention.cu",
            "replaces": "avd_tpu/ops/pallas/attention.py:64",
            "launches": launches, "max_abs_err": max_err,
            "ms": VIT_DEPTH * ms, "plain_ms": VIT_DEPTH * plain,
            "bound_ms": VIT_DEPTH * bnd, "bound_by": by,
            "library_ms": VIT_DEPTH * lib,
            "unit": f"one {FRAMES_MAIN}-frame clip: {VIT_DEPTH} launches at "
                    f"{list(shape)} bf16",
            "per_shape_ms": {str(list(r[0])): r[1] for r in rows}}


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke runs on a GPU",
              file=sys.stderr)
        return 2
    try:
        import avd_tpu_torch  # noqa: F401
        from avd_tpu_torch import device as device_mod
    except ImportError as e:
        print(f"chip_smoke: the avd_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    device_mod.resolve("cuda")
    try:
        card = phase_device()
        phase_build()
        gen = torch.Generator(device=DEV)
        gen.manual_seed(0)
        warp_rows, warp_err = phase_warp(gen)
        blur_rows, blur_err = phase_blur_solve(gen)
        launches, frames, fb, e2e_s = phase_main_path()
        dispatch = phase_dispatch(frames, fb, card)
        phase_card_vs_cpu()
        busy_ms = phase_profile(frames, e2e_s, dispatch)
        mha_rows, mha_err = phase_mha(gen)
        iter_rows, iter_err = phase_flow_iter(gen)
        det_launches = phase_detector(frames, fb)
        iter_launches = phase_fused_iter(frames)
        phase_host_runtime(frames, fb, busy_ms)
        w16_rows, w16_err, b16_rows, b16_err = phase_bf16_kernels(
            gen, warp_rows, blur_rows)
        bf16_launches = phase_modes(frames)
        wav_path, routes, wav_s = phase_wav_path()
        mp4_s = phase_mp4_path(routes, wav_path)
        if routes["cv2"] and phase_mp4_1080p(frames) is not None:
            phase_dispatch_streaming(dispatch)
        stream_launches = phase_streaming(frames, fb)
        cli_s = phase_cli(wav_path)
        phase_fault3(frames)
        stack_rows = phase_stacked_windows(frames)
        ref_mp4 = phase_served(wav_path, torch.cuda.get_device_name(0))
        serve_rows = phase_batching(ref_mp4)
        served_launches = phase_trace_route(ref_mp4)
        family_rows = phase_families(frames)
        phase_temporal_windows(frames)
        path_rows = phase_family_paths()
        train_rows = phase_training(fb)
        export_rows = phase_exported(frames)
        bench_rows = phase_detector_bench()
        probe = phase_nccl_probe()
        spec, par_inputs, par_ref, world1, w1_launches = \
            phase_parallel_world1(frames)
        par_rows = phase_parallel_ranks(spec, par_inputs, par_ref)
        train_par_rows = phase_train_parallel(spec, par_inputs)
        group_rows = phase_served_groups(card)
        torch.cuda.synchronize()
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    leaked = sorted(m for m in sys.modules if m == "jax" or
                    m.startswith(("jax.", "avd_tpu.")) or m == "avd_tpu")
    if leaked:
        print(f"chip_smoke: FAILED: imported {leaked}", file=sys.stderr)
        return 1
    kernels = [
        kernel_entry("warp_bilinear", "avd_tpu_torch/csrc/warp.cu",
                     "avd_tpu/ops/pallas/warp.py:143", warp_rows, warp_err,
                     launches["warp_bilinear"]),
        kernel_entry("box_blur_solve", "avd_tpu_torch/csrc/blur_solve.cu",
                     "avd_tpu/ops/pallas/blur_solve.py:97", blur_rows,
                     blur_err, launches["box_blur_solve"]),
        kernel_entry("solve_iteration", "avd_tpu_torch/csrc/flow_iter.cu",
                     "avd_tpu/ops/pallas/flow_iter.py:222",
                     iter_rows[:len(LEVELS)], iter_err,
                     iter_launches["solve_iteration"]),
        mha_entry(mha_rows, mha_err, det_launches["mha"]),
        kernel_entry("warp_bilinear_bf16", "avd_tpu_torch/csrc/warp.cu",
                     "avd_tpu/ops/pallas/warp.py:143", w16_rows, w16_err,
                     bf16_launches["warp_bilinear_bf16"]),
        kernel_entry("box_blur_solve_bf16", "avd_tpu_torch/csrc/blur_solve.cu",
                     "avd_tpu/ops/pallas/blur_solve.py:97", b16_rows,
                     b16_err, bf16_launches["box_blur_solve_bf16"]),
    ]
    kernels[3]["moe_small_launches"] = \
        family_rows["moe_small fused"]["mha_launches"]
    kernels[3]["moe_small_shape_ms"] = {
        k: v for k, v in zip(("ms", "plain_ms", "library_ms", "bound_ms"),
                             mha_rows[1][1:5])}
    for entry in kernels:
        entry["rank_group_training_launches"] = \
            train_par_rows["kernel_launches_world1"].get(entry["name"], 0)
        entry["streaming_launches"] = stream_launches.get(entry["name"], 0)
        entry["served_launches"] = served_launches.get(entry["name"], 0)
    # each rank's launches in a served group's AVD_STREAM=0 upload (34)
    for entry in kernels:
        entry["served_group_launches"] = {
            label: [r.get(entry["name"], 0) for r in row["batch"]["launches"]]
            for label, row in group_rows["groups"].items() if "batch" in row}
    # the parallel path: counts over the world-1 programs (phase 31) and
    # each rank's in phase 32 (programs cp and cp_iter)
    for entry in kernels[:3]:
        entry["parallel_launches"] = {
            "world1_nccl": w1_launches[entry["name"]],
            "ranks_gloo": [sum(r["launches"][entry["name"]] for r in
                               (par_rows["cp"]["ranks"][i],
                                par_rows["cp_iter"]["ranks"][i]))
                           for i in range(PAR_RANKS)]}
    # what the fused round replaces: warp kernel + PyTorch update +
    # blur+solve kernel, same unit
    kernels[2]["unfused_sequence_ms"] = ROUNDS * sum(
        r[6] for r in iter_rows[:len(LEVELS)])
    kernels[2]["tail_per_level_ms"] = {str(r[0]): r[1]
                                       for r in iter_rows[len(LEVELS):]}
    log(f"file path: analyze_path WAV {wav_s:.3f} s, mp4 {mp4_s:.3f} s "
        f"(first calls), CLI first call {cli_s:.2f} s")
    on, off = serve_rows["on"], serve_rows["off"]
    log("serving: stacked windows "
        + "; ".join(f"m={m} {r['stacked_ms']:.3f} ms against "
                    f"{r['singles_ms']:.3f}" for m, r in stack_rows.items())
        + f"; 4 concurrent 1080p uploads {on['four_concurrent_wall_s']:.3f}"
        f" s batched against {off['four_sequential_wall_s']:.3f} s "
        "sequential unbatched; requests/s 1 client on/off "
        f"{on['clients_1']['requests_per_s']:.3f}/"
        f"{off['clients_1']['requests_per_s']:.3f}, 4 clients on/off "
        f"{on['clients_4']['requests_per_s']:.3f}/"
        f"{off['clients_4']['requests_per_s']:.3f}")
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "families.json"), "w") as f:
        json.dump({"card": card, "scoring": family_rows,
                   "analyze_path": path_rows}, f, indent=1)
    with open(os.path.join("chiprun_out", "parallel.json"), "w") as f:
        json.dump({"card": card, "probe": probe, "world1_nccl": world1,
                   f"ranks_{PAR_RANKS}_gloo": par_rows}, f, indent=1)
    log("parallel (ms; one device / world 1 NCCL / each of 4 ranks over "
        "gloo): " + "; ".join(
            f"{k} {world1[k]['single_device_ms']:.2f} / "
            f"{world1[k].get('ms', float('nan')):.2f} / " + ", ".join(
                f"{r['ms']:.2f}" for r in par_rows[k]["ranks"])
            for k in world1))
    with open(os.path.join("chiprun_out", "train_parallel.json"), "w") as f:
        json.dump({"card": card, **train_par_rows}, f, indent=1)
    with open(os.path.join("chiprun_out", "training.json"), "w") as f:
        json.dump({"card": card, "training": train_rows,
                   "exported": export_rows, "bench": bench_rows}, f,
                  indent=1)
    log("families: " + "; ".join(
        f"{k} {r['frames_per_s']:.2f} frames/s (kernels "
        f"{r['kernels_ms']:.3f} ms, copy {r['h2d_ms']:.3f} ms)"
        for k, r in family_rows.items()))
    log(card)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
