"""Headline benchmark of the port: video-forensics frames/s on one card.

    python -m avd_tpu_torch.bench [--device cpu]

The port's counterpart of the root ``bench.py`` (the JAX package's
benchmark), with its environment settings and JSON keys.  It measures the
per-frame feature pipeline (grayscale, average-hash duplicates, full-size
Laplacian texture variance, 320×320 Farnebäck flow per consecutive pair,
the AI-suspicion timeline) on:

* the card: ``ops/video_features.compute_features_streaming`` over
  decode-sized chunks, the serving configuration (C++ host prep, the
  dispatch thread, the warp and blur+solve kernels);
* the card with the window already resident (``device_stage_fps``): a
  chain of ``_prep_body`` calls on one packed 49-frame window;
* the host: the port's cv2 oracle (``oracle/video_ref.compute_features``),
  the reference's per-frame loop (``cpu_fps``, the ``vs_baseline``
  denominator).

It prints one JSON line: ``metric``, ``value`` (best frames/s of the card
path), ``unit``, ``vs_baseline``, ``cpu_fps``, ``gpu_fps_reps``,
``gpu_fps_median``, ``gpu_fps_spread``, ``device_stage_fps`` and
``device`` (the card's ``name`` and ``power_limit`` as ``nvidia-smi``
reads them; ``{"name": "cpu"}`` on the CPU).  ``run()`` returns the same
dict.  ``AVD_BENCH_MODE=latency`` prints instead the median wall seconds
of ``pipeline.analyze_path`` on an mp4 of ``AVD_BENCH_CLIP_SECS`` seconds.

Settings, read when ``run`` is called: ``AVD_BENCH_FRAMES`` (145),
``AVD_BENCH_RES`` (1080p, 4k, 720p), ``AVD_BENCH_CONTENT`` (pan, static,
noise), ``AVD_BENCH_REPS`` (5), ``AVD_BENCH_CPU_FRAMES`` (31),
``AVD_BENCH_CPU_REPS`` (3), ``AVD_BENCH_DEVICE_STAGE`` (1; 0 skips the
resident stage and reports 0.0), ``AVD_BENCH_MODE``,
``AVD_BENCH_CLIP_SECS`` (60).

Departures from ``bench.py``:

* The card is the default device, and without CUDA the bench raises
  (``device.resolve``) unless ``--device cpu`` is given; on the CPU the
  kernels' plain versions run and no number is a device metric.
* An error in any stage ends the run with a non-zero exit; ``bench.py``
  reports an error in its device-resident stage as ``device_stage_fps:
  0.0``.  cv2 is required (``bench.py`` skips the blur without it), and an
  unknown ``AVD_BENCH_CONTENT`` raises.
* The resident chain ends in ``torch.cuda.synchronize`` (``bench.py``
  fetches a scalar); the ``tpu_fps_*`` keys are ``gpu_fps_*``; ``device``
  is added.
* Latency mode writes its clip into a fresh temporary directory every run
  (``bench.py`` reuses a file named by its length alone), names the
  resolution it ran at in ``metric``, and adds ``label`` and the three
  timed ``seconds``; it raises where the video analyzer reported an error.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from avd_tpu_torch import device as device_mod

_RES = {"1080p": (1080, 1920), "4k": (2160, 3840), "720p": (720, 1280)}
CONTENTS = ("pan", "static", "noise")
DECODE_CHUNK = 29  # frames per simulated decode chunk (streaming mode)
RESIDENT_FRAMES = 49  # the production host-prep window (48 pairs)
CHAIN = 8  # resident ``_prep_body`` calls per timed chain
LATENCY_REPS = 3
LABELS = ("real", "ai", "uncertain")


def _env_int(name: str, default: int) -> int:
    return int(os.getenv(name, str(default)))


def make_frames(n: int, res: str | None = None,
                content: str | None = None) -> np.ndarray:
    """Deterministic [n, H, W, 3] BGR uint8 frames, byte-equal to
    ``bench.py``'s (same generator, seed, pan step and blur).

    ``pan`` (default): a blurred noise canvas panning (5, 3) px a frame.
    ``static``: one blurred noise frame repeated (talking head, CCTV).
    ``noise``: uncorrelated noise per frame, the flow solver's worst case.
    ``res`` and ``content`` default to ``AVD_BENCH_RES`` and
    ``AVD_BENCH_CONTENT``, read at the call."""
    import cv2
    h, w = _RES[res or os.getenv("AVD_BENCH_RES", "1080p")]
    content = content or os.getenv("AVD_BENCH_CONTENT", "pan")
    if content not in CONTENTS:
        raise ValueError(f"AVD_BENCH_CONTENT must be one of {CONTENTS}, "
                         f"not {content!r}")
    rng = np.random.default_rng(0)
    if content == "noise":
        return rng.integers(0, 256, (n, h, w, 3), dtype=np.int16) \
                  .astype(np.uint8)
    if content == "static":
        base = rng.integers(0, 256, (h, w, 3), dtype=np.int16) \
                  .astype(np.uint8)
        base = cv2.GaussianBlur(base, (0, 0), 2)
        return np.broadcast_to(base, (n, h, w, 3)).copy()
    base = rng.integers(0, 256, (h + 64, w + 64, 3),
                        dtype=np.int16).astype(np.uint8)
    base = cv2.GaussianBlur(base, (0, 0), 2)
    frames = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        dy, dx = (i * 3) % 64, (i * 5) % 64
        frames[i] = base[dy:dy + h, dx:dx + w]
    return frames


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_gpu(frames: np.ndarray, device: torch.device, reps: int) -> list:
    """Steady-state streaming throughput: ``DECODE_CHUNK``-frame chunks
    through host prep and the dispatch thread to the kernels, as a served
    request runs.  One warm pass (kernel build, library start-up), then
    ``reps`` timed passes; returns frames/s of each."""
    from avd_tpu_torch.ops import video_features

    def chunks():
        for i in range(0, len(frames), DECODE_CHUNK):
            yield frames[i:i + DECODE_CHUNK]

    video_features.compute_features_streaming(chunks(), device=device)
    fps = []
    for _ in range(reps):
        t = time.perf_counter()
        # returns after _fetch_windows' one device→host copy of every
        # window's results (a blocking .cpu() on the caller's stream, on
        # which the dispatch thread enqueued each window): the clock
        # stops on finished work
        video_features.compute_features_streaming(chunks(), device=device)
        fps.append(len(frames) / (time.perf_counter() - t))
    return fps


def resident_window(frames: np.ndarray, device: torch.device):
    """The first ``min(RESIDENT_FRAMES, N)`` frames through host prep,
    packed and copied to ``device`` once: (flow planes [n, 320, 320] u8,
    hash planes [n, 32, 32] u8, config), both views of one device
    vector, as ``run_prep_window`` lays them out."""
    from avd_tpu_torch import config
    from avd_tpu_torch.ops import host_prep, video_features
    cfg = config.get_config()
    n = min(RESIDENT_FRAMES, len(frames))
    s320, s32, _ = host_prep.host_prep(frames[:n], native=cfg.native)
    packed = video_features._put(
        np.concatenate([s320.reshape(-1), s32.reshape(-1)]), device)
    return (packed[:s320.size].view(s320.shape),
            packed[s320.size:].view(s32.shape), cfg)


def bench_device_resident(frames: np.ndarray, device: torch.device,
                          reps: int) -> float:
    """Device-stage frames/s with the packed window resident on the
    device: best of ``reps`` chains of ``CHAIN`` ``_prep_body`` calls (the
    body of ``run_prep_window``), each chain closed by a synchronize.  It
    separates the device program from host prep and the copy, so a drop in
    the headline can be placed from the JSON alone."""
    from avd_tpu_torch.ops import video_features
    flow_u8, hash_u8, cfg = resident_window(frames, device)
    video_features._prep_body(flow_u8, hash_u8, cfg)  # warm
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        t = time.perf_counter()
        for _ in range(CHAIN):
            video_features._prep_body(flow_u8, hash_u8, cfg)
        _sync(device)
        best = min(best, time.perf_counter() - t)
    return flow_u8.shape[0] * CHAIN / best


def bench_cpu(frames: np.ndarray, reps: int) -> float:
    """Frames/s of the cv2 oracle on the host: median of ``reps`` runs
    (host clocks are noisy; a median of 3 over 31 frames keeps the ratio
    reproducible where a best of 2 over 13 did not)."""
    from avd_tpu_torch.oracle import video_ref
    times = []
    for _ in range(reps):
        t = time.perf_counter()
        video_ref.compute_features(frames)
        times.append(time.perf_counter() - t)
    return len(frames) / statistics.median(times)


def bench_latency(device: torch.device, secs: int, res: str) -> dict:
    """Median wall seconds of ``pipeline.analyze_path`` on a ``secs``-second
    30 fps mp4 (cv2's mp4v) of 64 ``make_frames`` frames repeated, decode
    included: one warm call, then ``LATENCY_REPS`` timed."""
    import cv2

    from avd_tpu_torch import pipeline
    h, w = _RES[res]
    with tempfile.TemporaryDirectory(prefix="avd_bench_") as tmp:
        path = os.path.join(tmp, f"avd_bench_{secs}s_{res}.mp4")
        writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 30.0, (w, h))
        if not writer.isOpened():
            raise RuntimeError(f"cv2 cannot write {path} with mp4v")
        base = make_frames(64, res)
        for i in range(secs * 30):
            writer.write(base[i % 64])
        writer.release()

        pipeline.analyze_path(path, device=device)  # warm
        times = []
        for _ in range(LATENCY_REPS):
            t = time.perf_counter()
            out = pipeline.analyze_path(path, device=device)
            times.append(time.perf_counter() - t)
    if "video_error" in out["hints"]:
        raise RuntimeError(f"the video analyzer failed: "
                           f"{out['hints']['video_error']}")
    label = out["result"]["label"]
    if label not in LABELS:
        raise RuntimeError(f"label {label!r} is not one of {LABELS}")
    return {
        "metric": f"analyze_latency_p50_{secs}s_{res}",
        "value": round(statistics.median(times), 2),
        "unit": "seconds",
        "vs_baseline": 0.0,
        "label": label,
        "seconds": times,
    }


def device_info(device: torch.device) -> dict:
    """The card's ``name`` and ``power_limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (the
    row whose UUID is the device's), or ``{"name": "cpu"}``."""
    if device.type != "cuda":
        return {"name": "cpu"}
    props = torch.cuda.get_device_properties(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=uuid,name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
    except FileNotFoundError:
        return {"name": props.name,
                "power_limit": "not read (nvidia-smi not found)"}
    rows = [[f.strip() for f in line.split(",")]
            for line in smi.stdout.splitlines() if line.strip()]
    uuid = str(getattr(props, "uuid", ""))
    mine = [r for r in rows if uuid and uuid in r[0]]
    if not mine:
        if len(rows) != 1:
            raise RuntimeError(f"no nvidia-smi row has UUID {uuid!r}: "
                               f"{smi.stdout}")
        mine = rows
    return {"name": mine[0][1], "power_limit": mine[0][2]}


def run(device=None) -> dict:
    """One benchmark run on ``device`` (default CUDA; raises without it):
    the dict ``main`` prints."""
    dev = device_mod.pinned(device)
    card = device_info(dev)
    res = os.getenv("AVD_BENCH_RES", "1080p")
    if os.getenv("AVD_BENCH_MODE") == "latency":
        out = bench_latency(dev, _env_int("AVD_BENCH_CLIP_SECS", 60), res)
        out["device"] = card
        return out

    reps = _env_int("AVD_BENCH_REPS", 5)
    frames = make_frames(_env_int("AVD_BENCH_FRAMES", 145), res)
    fps_reps = bench_gpu(frames, dev, reps)
    gpu_fps = max(fps_reps)
    device_fps = (bench_device_resident(frames, dev, reps)
                  if os.getenv("AVD_BENCH_DEVICE_STAGE", "1") != "0"
                  else 0.0)
    cpu_fps = bench_cpu(frames[:_env_int("AVD_BENCH_CPU_FRAMES", 31)],
                        _env_int("AVD_BENCH_CPU_REPS", 3))
    return {
        "metric": f"video_forensics_frames_per_sec_{res}",
        "value": round(gpu_fps, 2),
        "unit": "frames/sec/chip",
        "vs_baseline": round(gpu_fps / cpu_fps, 2),
        "cpu_fps": round(cpu_fps, 2),
        # the headline is the best rep; the median and spread say how far
        # host noise moved this run, and the resident stage places a drop
        # on the host or the device
        "gpu_fps_reps": [round(f, 1) for f in fps_reps],
        "gpu_fps_median": round(statistics.median(fps_reps), 2),
        "gpu_fps_spread": round(max(fps_reps) - min(fps_reps), 2),
        "device_stage_fps": round(device_fps, 1),
        "device": card,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions on the host)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
