"""Closed-loop clip traffic through ``pipeline.analyze_decoded``.

Set-up makes the frame pool and its wave from the seed, builds the
kernels, warms every window, audio and detector bucket on each client's
own thread, then opens the window: each client sends clip after clip and
waits for its envelope.  A clip sent before the window closes is
attempted; one whose envelope arrives by the close counts in the host's
rates and tail.  An untraced run on the card also holds a profiler
session from the idle card at the window's opening until every clip sent
in it has drained: its busy time is the card time of all of that work,
and of nothing else.  Every envelope, late ones included, is then checked:

* the frozen schema, no ``hints.video_error``, ``hints.audio_error`` or
  ``video.detector_error``, and no exception (``failed_clips``);
* the hand kernels' launch counters rose by 24 a window (12 warps and 12
  blur+solves) for every window of every clip (``launch_deficit``);
* the per-pair flow means and variances and the per-frame textures that
  the timed path computed (caught where ``analyze_frames`` hands them to
  the summary) against the plain reference from the raw frames
  (``flow_gap``, ``texture_gap``), and the count of pairs whose hashes
  agree (``dup_mismatch``);
* the envelope's host stages (video summary and timeline, hints, fusion's
  score and label) against the frozen stages applied to the clip's own
  features and audio block (``envelope_mismatch``);
* the audio block against the reference from the raw wave (``audio_gap``);
* with the detector, each frame's logit (from its probability) against
  the ViT reference's at the precision the configuration states,
  bfloat16 products and residual stream (``det_gap``, the widest
  absolute gap).

Otherwise a gap is ``|p - r| / max(|r|, median |r|)``, the worst over
every pair, frame or entry compared.
"""

from __future__ import annotations

import gc
import os
import threading
import time
from typing import Dict, List

import numpy as np

from .. import generate, media, schema
from ..reference import envelope as ref_env
from ..reference import flow as ref_flow
from ..reference import host_prep as ref_prep
from ..roofline import blur_solve as roof_blur
from ..roofline import warp as roof_warp
from ..run import Check, Run
from ..spec import ROOT

_ERROR_HINTS = ("video_error", "audio_error")


def _gap(p, r) -> float:
    p = np.asarray(p, np.float64)
    r = np.asarray(r, np.float64)
    if p.shape != r.shape:
        return float("inf")
    if r.size == 0:
        return 0.0
    floor = max(float(np.median(np.abs(r))), 1e-300)
    return float(np.max(np.abs(p - r) / np.maximum(np.abs(r), floor)))


def _windows(n: int, chunk: int) -> int:
    return -(-n // chunk)


class _Clip:
    __slots__ = ("client", "start", "n", "send", "done", "env", "feats",
                 "error")

    def __init__(self, client, start, n):
        self.client, self.start, self.n = client, start, n
        self.send = self.done = None
        self.env = self.feats = self.error = None


def run(ctx) -> Run:
    import torch
    tr, cfg = ctx.traffic, ctx.config
    dev = torch.device(ctx.device)
    from avd_tpu_torch import pipeline
    from avd_tpu_torch.ingest.video_reader import FrameBatch
    from avd_tpu_torch.ops import video_features
    from avd_tpu_torch.ops.kernels import blur_solve, warp
    from avd_tpu_torch.oracle import video_ref

    detector = cfg.get("detector") is not None
    h, w, fps = tr["height"], tr["width"], float(tr["fps"])
    sfps, sr = float(tr["sample_fps"]), int(tr["audio_sr"])
    spf = int(round(sr / sfps))  # audio samples per sampled frame
    pool_n = int(tr["pool_frames"])
    pool = media.make_frames(pool_n, h, w, ctx.seed)
    wave = media.speech_wave(pool_n / sfps, generate.rng(ctx.seed, 3)
                             .integers(1 << 62))
    ctx.log(f"pool of {pool_n} frames {h}x{w} made "
            f"({time.perf_counter() - ctx.t0:.1f} s)")

    # the features the timed path hands to the summary, per thread
    caught = threading.local()
    summarize = video_ref.summarize

    def catch(feats, *a, **k):
        caught.feats = feats
        return summarize(feats, *a, **k)

    video_ref.summarize = catch

    def analyze(clip: _Clip) -> None:
        s, n = clip.start, clip.n
        fb = FrameBatch(pool[s:s + n], n, fps, w, h, n / sfps)
        meta = media.probe_meta(n, h, w, fps, sfps)
        caught.feats = None
        clip.send = time.perf_counter()
        try:
            clip.env = pipeline.analyze_decoded(
                fb, wave[s * spf:(s + n) * spf], sr, meta, device=dev)
        except Exception as e:  # counted as a failed clip and reported
            clip.error = f"{type(e).__name__}: {e}"
        clip.done = time.perf_counter()
        clip.feats = caught.feats

    if dev.type == "cuda":
        video_features.warm_device(dev)
    if ctx.trace:
        from ..trace import prime
        prime()
    clients = int(tr["clients"])
    barrier = threading.Barrier(clients + 1)
    window: Dict[str, float] = {}
    records: List[List[_Clip]] = [[] for _ in range(clients)]
    warm_errors: List[str] = []

    def client(k: int) -> None:
        for n in tr["warm_frames"]:
            c = _Clip(k, 0, min(int(n), pool_n))
            analyze(c)
            if c.error:
                warm_errors.append(c.error)
        barrier.wait()
        stream = generate.clips(tr, ctx.seed, k)
        while time.perf_counter() < window["end"]:
            s, n = next(stream)
            c = _Clip(k, s, n)
            records[k].append(c)
            analyze(c)

    threads = [threading.Thread(target=client, args=(k,), daemon=True,
                                name=f"bench-client-{k}")
               for k in range(clients)]
    for t in threads:
        t.start()
    try:
        # the window opens when every client has warmed up
        window["end"] = float("inf")
        sl = busy = None
        if ctx.trace or dev.type == "cuda":
            # the profiler starts while the clients wait at the barrier
            # and the card is idle (a traced slice's warm-up lasts until
            # the slice; an untraced run's session spans the window)
            from ..trace import Busy, Slicer
            while barrier.n_waiting < clients and all(
                    t.is_alive() for t in threads):
                time.sleep(0.01)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if ctx.trace:
                sl = Slicer(0.0, float(cfg["trace"]["seconds"]), 0.0,
                            ctx.log)
                sl.begin()
            else:
                busy = Busy(named=(roof_warp.KERNEL,) + roof_blur.KERNELS)
                busy.start()
        launches0 = warp.LAUNCHES + blur_solve.LAUNCHES
        barrier.wait()
        if busy is not None:
            busy.open()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_open = time.perf_counter()
        window["end"] = t_open + ctx.seconds
        setup_s = t_open - ctx.t0
        ctx.log(f"set-up {setup_s:.2f} s; window open")
        if sl is not None:
            sl.t_next = t_open + float(cfg["trace"]["at"]) * ctx.seconds
            sl.t_end = window["end"]
            while not sl.done:
                time.sleep(min(sl.poll(time.perf_counter()), 1.0))
        for t in threads:
            t.join(timeout=ctx.seconds + 240)
        stuck = [t.name for t in threads if t.is_alive()]
        if stuck:
            raise RuntimeError(f"clients still running: {stuck}")
        launches = warp.LAUNCHES + blur_solve.LAUNCHES - launches0
        if busy is not None:
            # every clip sent in the window has drained: the session holds
            # all their device work and nothing else
            torch.cuda.synchronize(dev)
            busy.close()
            t_stop = time.perf_counter()
            busy.expect = launches  # the program's own count of its kernels
            busy.stop()
            ctx.log(f"card busy {busy.busy_s:.4f} s of {busy.span_s:.3f} s "
                    f"(window and drain); {busy.launches} launches, "
                    f"{100 * busy.lost_share:.2f} % without their kernel, "
                    f"{busy.counted} flow kernels of {launches} launched, "
                    f"longest pause {busy.gap_s:.3f} s; read in "
                    f"{time.perf_counter() - t_stop:.1f} s")
    finally:
        video_ref.summarize = summarize
    t_close = window["end"]
    clips = [c for rec in records for c in rec]

    run = Run(setup_s=setup_s, window_s=ctx.seconds, attempted=len(clips))
    why = {id(c): _failure(c, detector) for c in clips}
    bad = [c for c in clips if why[id(c)]]
    run.failed = len(bad)
    for c in bad[:3]:
        ctx.log(f"failed clip {c.start}+{c.n}: {why[id(c)]}")
    good = [c for c in clips if not why[id(c)]]
    in_window = [c for c in good if c.done <= t_close]
    run.data = {
        "frames_done": sum(c.n for c in in_window),
        "clips_done": len(in_window),
        "latencies": [c.done - c.send for c in in_window],
        # every clip sent in the window, drained, and the card's time
        "frames_sent": sum(c.n for c in clips),
        "card_busy_s": (busy.busy_s if busy is not None and busy.complete
                        else None),
    }
    ctx.log(f"{len(in_window)} clips ({run.data['frames_done']} frames) in "
            f"{ctx.seconds} s, {len(clips)} attempted, {run.failed} failed")
    if sl is not None and sl.trace is not None:
        done = [c for c in good if sl.t0 <= c.done <= sl.t1]
        run.trace = sl.trace
        run.trace.work = {
            "frames": sum(c.n for c in done),
            "pairs": sum(c.n - 1 for c in done),
            "clips": len(done),
            "model": cfg.get("detector"),
        }
    if dev.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    # ---------------------------------------------------------- the check
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    run.checks.append(Check("failed_clips", float(run.failed + len(
        warm_errors)), 0.0))
    if dev.type == "cuda":
        chunk = int(os.environ.get("AVD_VIDEO_CHUNK", "48"))
        expected = 24 * sum(_windows(c.n, chunk) for c in clips)
        run.checks.append(Check("launch_deficit",
                                float(max(0, expected - launches)), 0.0))
    _compare(ctx, run, good, pool, wave, spf, sr, dev, detector)
    ctx.log(f"reference and comparison {time.perf_counter() - t_ref:.1f} s")
    return run


def _failure(c: _Clip, detector: bool):
    """Why a clip's envelope counts as failed, or None."""
    if c.error:
        return c.error
    if c.env is None or c.feats is None:
        return "no envelope"
    hints, video = c.env.get("hints", {}), c.env.get("video", {})
    for k in _ERROR_HINTS:
        if k in hints:
            return f"hints.{k}={hints[k]}"
    if "detector_error" in video:
        return f"video.detector_error={video['detector_error']}"
    if detector and "detector" not in video:
        return "no detector timeline"
    try:
        schema.validate(c.env)
    except schema.SchemaError as e:
        return f"schema: {e}"
    return None


def _compare(ctx, run: Run, clips: List[_Clip], pool, wave, spf, sr, dev,
             detector: bool) -> None:
    import torch
    tr = ctx.traffic
    h, w, fps = tr["height"], tr["width"], float(tr["fps"])
    sfps = float(tr["sample_fps"])
    if not clips:
        run.checks.append(Check("clips_checked", 0.0, -1.0))
        return
    a = min(c.start for c in clips)
    b = max(c.start + c.n for c in clips)
    s320, s32, tex_r = ref_prep.prep(pool[a:b])
    fmean_r, fvar_r = ref_flow.pair_features(s320, dev)
    same_r = ref_flow.hamming(s32) == 0
    del s320
    probs_r = None
    if detector:
        from ..reference import vit as ref_vit
        d = ctx.config["detector"]
        size = int(d["image_size"])
        rgb = ref_prep.resize_area(pool[a:b], size)[..., ::-1] \
            .astype(np.float32) / 255.0
        params = ref_vit.load(os.path.join(ROOT, d["weights"]), dev)
        # at the precision the configuration states, and in float32 for
        # the log
        probs_r, probs_f32 = (ref_vit.probabilities(
            params, rgb, int(d["heads"]), int(d["patch"]), dev,
            dtype=getattr(torch, dt)) for dt in (d["dtype"], "float32"))
        del params, rgb
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    gaps = {"flow_gap": 0.0, "texture_gap": 0.0, "audio_gap": 0.0}
    if detector:
        gaps["det_gap"] = 0.0
    dup_mismatch = envelope_mismatch = 0
    det_pairs = []
    hints_r = ref_env.hints(media.probe_meta(1, h, w, fps, sfps))
    for c in clips:
        s, n, env, feats = c.start - a, c.n, c.env, c.feats
        fm, fv = fmean_r[s:s + n - 1], fvar_r[s:s + n - 1]
        gaps["flow_gap"] = max(gaps["flow_gap"],
                               _gap(feats["flow_means"], fm),
                               _gap(feats["flow_vars"], fv))
        gaps["texture_gap"] = max(gaps["texture_gap"],
                                  _gap(feats["textures"], tex_r[s:s + n]))
        dup_mismatch += int(feats["dup"] != int(same_r[s:s + n - 1].sum()))
        dur = n / sfps
        # the host stages, from the clip's own features and audio block
        vid = ref_env.video(feats["textures"], feats["dup"],
                            feats["flow_means"], feats["flow_vars"],
                            w, h, fps, dur)
        fused = ref_env.fuse(env["audio"], vid, hints_r)
        same = (vid["timeline"] == env["video"]["timeline"]
                and vid["summary"] == env["video"]["summary"]
                and env["hints"] == hints_r
                and env["result"]["ai_score"] == round(fused["score"], 2)
                and env["result"]["label"] == fused["label"])
        envelope_mismatch += int(not same)
        # the audio block from the raw wave
        seg = wave[(c.start) * spf:(c.start + n) * spf]
        aud_p = env["audio"]
        if ctx.control:  # the reference in bfloat16 in the program's place
            seg16 = torch.from_numpy(seg).to(torch.bfloat16).float().numpy()
            aud_p = ref_env.audio(ref_env.audio_windows(seg16, sr), dur)
        aud_r = ref_env.audio(ref_env.audio_windows(seg, sr), dur)
        gaps["audio_gap"] = max(
            gaps["audio_gap"], _gap(aud_p["timeline"], aud_r["timeline"]),
            _gap(list(aud_p["flags_audio"].values()),
                 list(aud_r["flags_audio"].values())))
        if detector:
            pair = np.stack([env["video"]["detector"]["timeline"],
                             probs_r[s:s + n], probs_f32[s:s + n]])
            gaps["det_gap"] = max(gaps["det_gap"], float(np.max(np.abs(
                _logit(pair[0]) - _logit(pair[1])))))
            det_pairs.append(pair)
    if det_pairs:
        _log_det(ctx, np.concatenate(det_pairs, axis=1))
    lim = ctx.config["limits"]
    for name, value in gaps.items():
        run.checks.append(Check(name, value, float(lim[name])))
    run.checks.append(Check("dup_mismatch", float(dup_mismatch), 0.0))
    run.checks.append(Check("envelope_mismatch", float(envelope_mismatch),
                            0.0))
    ctx.log(f"checked {len(clips)} clips over pool frames {a}..{b}")


def _logit(p) -> np.ndarray:
    p = np.clip(np.asarray(p, np.float64), 1e-7, 1 - 1e-7)
    return np.log(p / (1 - p))


def _log_det(ctx, prr) -> None:
    """Where the detector's logit gaps lie, against the reference at the
    stated precision and in float32."""
    p, r, r32 = prr

    def q(x):
        return " ".join(f"{v:.3g}" for v in np.percentile(x, [50, 90, 99,
                                                              100]))

    for name, ref in (("stated", r), ("float32", r32)):
        dz = _logit(p) - _logit(ref)
        ctx.log(f"detector against the {name} reference: {p.size} frames; "
                f"p50/p90/p99/max {q(ref)}; |dlogit| {q(np.abs(dz))}; "
                f"mean {dz.mean():.4g} rms {np.sqrt((dz ** 2).mean()):.4g}")
