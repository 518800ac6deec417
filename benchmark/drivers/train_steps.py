"""The ViT detector's training step in a loop (``kind: train_steps``).

Set-up makes the weights and a device-resident pool of labelled frames on
the card from the seed, builds the step as ``models/train.train`` builds
it for the ``vit`` family (``detector.make_train_step`` over
``optim.AdamW`` with the recipe's schedule and ``logit_l2``), and drives
that one object through its first steps: step k trains on the pool rows
that ``generate.step_rows`` assigns it, all different within a step.  The
window then runs the same object on, step after step, and ends in a
synchronize; the host's rate is every step's frames over the whole
window.  An untraced run on the card also holds a profiler session from
the idle card at the window's opening to its final synchronize: its busy
time over the window's steps is the card time a step.

``correct`` compares the first three steps with the plain float32
reference (``reference/train.py``) from the same weights and rows: each
step's loss (``loss_gap``, the worst step) and the parameters' change
after three steps (``update_gap``).  The first gradient as the optimizer
got it, worked out from its first moment after one step, is read and
printed beside them; it is not compared, since neither the control nor a
planted fault reads three or ten times what sound seeds do.  Norms are
taken leaf by leaf as the gap between the two norms, over the
reference's norm of that leaf or of the median leaf, whichever is
larger; the number is the median leaf's gap, since the worst leaf's
swings with the bfloat16 noise of the smallest leaves (the class token
and the positions).  A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left
out.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np

from .. import generate
from ..reference import train as ref_train
from ..reference import vit as ref_vit
from ..run import Check, Run

B1 = 0.9
CHECKED_STEPS = 3


def make_weights(dims: Dict, seed: int, device):
    """The parameter tree on ``device`` from the seed: one normal draw for
    every leaf, scaled as the port's initialiser does (weights by
    1/√fan-in, embeddings by 0.02, LayerNorm scales 1, biases 0)."""
    import torch
    shapes = ref_vit.shapes(**dims)
    sizes = [int(np.prod(s)) for _, s in ref_vit.named(shapes)]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    it = iter(torch.split(flat, sizes))

    def build(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, list):
                out[k] = [build(lp) for lp in v]
                continue
            x = next(it).view(v)
            if k.endswith("_scale"):
                x = torch.ones_like(x)
            elif k in ("pos_emb", "cls_tok"):
                x = x * 0.02
            elif k.endswith("_w"):
                x = x / float(np.sqrt(v[-2]))
            else:
                x = torch.zeros_like(x)
            out[k] = x.contiguous()
        return out

    return build(shapes)


def make_pool(n: int, size: int, seed: int, device, chunk: int = 256):
    """[n, size, size, 3] float32 frames in [0, 1] and [n] labels, made on
    the card: label 1 (generated-looking) frames are smooth fields, label
    0 frames carry fine texture over them, both with seeded strengths."""
    import torch
    import torch.nn.functional as F
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63) ^ 1)
    labels = (torch.rand(n, generator=gen, device=device) < 0.5).float()
    frames = torch.empty((n, size, size, 3), device=device)
    for s in range(0, n, chunk):
        k = min(chunk, n - s)
        low = F.interpolate(torch.randn(k, 3, size // 16, size // 16,
                                        generator=gen, device=device),
                            size=(size, size), mode="bilinear",
                            align_corners=False)
        fine = torch.randn(k, 3, size, size, generator=gen, device=device)
        amp = torch.rand(k, 1, 1, 1, generator=gen, device=device)
        texture = (1.0 - labels[s:s + k]).view(k, 1, 1, 1) * (0.05 + 0.2 * amp)
        x = 0.5 + 0.2 * low + texture * fine
        frames[s:s + k] = x.clamp(0.0, 1.0).permute(0, 2, 3, 1)
    return frames, labels


def _norms(tensors) -> np.ndarray:
    import torch
    return torch.stack([t.float().norm() for t in tensors]).double().cpu() \
        .numpy()


def _leaf_gaps(p: np.ndarray, r: np.ndarray) -> np.ndarray:
    return np.abs(p - r) / np.maximum(r, float(np.median(r)))


def run(ctx) -> Run:
    import torch
    from avd_tpu_torch.models import detector, optim

    dev = torch.device(ctx.device)
    tr, cfg = ctx.traffic, ctx.config
    dims = {k: cfg["detector"][k] for k in ("image_size", "patch", "width",
                                            "heads", "mlp", "depth")}
    recipe = cfg["train"]
    batch, pool_n = int(tr["batch"]), int(tr["pool"])
    params = make_weights(dims, ctx.seed, dev)
    weights0 = {n: p.detach().clone() for n, p in ref_vit.named(params)}
    frames, labels = make_pool(pool_n, dims["image_size"], ctx.seed, dev)
    rows = torch.from_numpy(generate.step_rows(
        ctx.seed, pool_n, batch, int(tr["max_steps"]))).to(dev)

    vcfg = detector.make_config(
        "full", image_size=dims["image_size"], patch=dims["patch"],
        width=dims["width"], heads=dims["heads"], depth=dims["depth"],
        mlp_ratio=dims["mlp"] // dims["width"])
    optimizer = optim.make_optimizer(
        recipe["lr"], steps=recipe["steps"], warmup=recipe["warmup"],
        schedule=recipe["schedule"])
    step_fn = detector.make_train_step(vcfg, optimizer,
                                       logit_l2=recipe["logit_l2"])
    leaves = optim.leaves_of(params)
    opt_state = optimizer.init(leaves)

    def batch_of(k: int):
        idx = rows[k % rows.shape[0]]
        return frames.index_select(0, idx), labels.index_select(0, idx)

    # the first steps, which the reference follows, are the warm-up too
    losses, grad1 = [], None
    k = 0
    for k in range(CHECKED_STEPS):
        params, opt_state, loss = step_fn(params, opt_state, *batch_of(k))
        losses.append(loss)
        if k == 0:
            grad1 = _norms(opt_state["mu"]) / (1 - B1)
    delta3 = [p.detach() - weights0[n] for n, p in ref_vit.named(params)]
    losses = [float(x) for x in losses]
    for k in range(CHECKED_STEPS, CHECKED_STEPS + int(tr["warm_steps"])):
        params, opt_state, _ = step_fn(params, opt_state, *batch_of(k))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    from ..trace import Busy, Slicer, prime
    if ctx.trace:
        prime()
    sync()
    busy = None
    if dev.type == "cuda" and not ctx.trace:
        # one profiler session from the idle card to the window's final
        # synchronize holds all of the window's steps and nothing else
        busy = Busy()
        busy.start()
    k0 = k + 1

    t_open = time.perf_counter()
    setup_s = t_open - ctx.t0
    if busy is not None:
        busy.open()
    ctx.log(f"set-up {setup_s:.2f} s; window open")
    end = t_open + ctx.seconds
    # the loop launches from this thread, and the profiler starts between
    # two steps, when no other thread launches; the slice records this
    # thread's operators too, so its idle share carries the profiler's
    # cost
    sl, k = None, k0
    if ctx.trace:
        sl = Slicer(t_open + float(tr["trace"]["at"]) * ctx.seconds,
                    float(tr["trace"]["seconds"]), end, ctx.log)
    while time.perf_counter() < end:
        params, opt_state, _ = step_fn(params, opt_state, *batch_of(k))
        k += 1
        if sl is not None and not sl.done:
            sl.poll(time.perf_counter(), k)
    if sl is not None:
        sl.finish(k)
    sync()
    t_close = time.perf_counter()
    run = Run(setup_s=setup_s, window_s=t_close - t_open,
              attempted=k - k0, failed=0)
    run.data = {"train_frames": (k - k0) * batch, "steps": k - k0}
    ctx.log(f"{k - k0} steps of {batch} in {run.window_s:.3f} s")
    if busy is not None:
        busy.close()
        busy.stop()
        run.data["card_busy_s"] = busy.busy_s if busy.complete else None
        ctx.log(f"card busy {busy.busy_s:.4f} s of {busy.span_s:.3f} s; "
                f"{busy.launches} launches, {100 * busy.lost_share:.2f} % "
                f"without their kernel, longest pause {busy.gap_s:.3f} s")
    if sl is not None and sl.trace is not None:
        n = sl.counts[1] - sl.counts[0]
        run.trace = sl.trace
        run.trace.work = {"steps": n, "frames": n * batch, "batch": batch,
                          "model": dims}
    if dev.type == "cuda":
        run.memory_peak_bytes = int(torch.cuda.max_memory_allocated(dev))

    # ---------------------------------------------------------- the check
    checked = [batch_of(i) for i in range(CHECKED_STEPS)]
    del params, opt_state, leaves, frames, labels, step_fn
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    got = {"loss": losses, "grad1": grad1, "delta": delta3}
    if ctx.control:  # the reference in float8 in the program's place
        got = follow(weights0, checked, recipe, dims, torch.float8_e4m3fn)
    want = follow(weights0, checked, recipe, dims, torch.float32)
    run.checks = compare(ctx, got, want)
    return run


def follow(weights0: Dict, batches: List, recipe: Dict, dims: Dict,
           dtype, keep: int = 0) -> Dict:
    """The reference's readings over the checked steps from the initial
    weights: losses, the first gradient's leaf norms, the change's leaf
    norms after the last step."""
    import torch
    params = ref_vit.shapes(**dims)
    it = iter(w.clone() for w in weights0.values())

    def build(tree):
        return {k: ([build(lp) for lp in v] if isinstance(v, list)
                    else next(it)) for k, v in tree.items()}

    params = build(params)
    t = ref_train.Trainer(params, recipe, dims["heads"], dims["patch"], dtype)
    losses, g1 = [], None
    for i, (x, y) in enumerate(batches):
        loss, grads = t.step(x, y, keep)
        losses.append(loss)
        if i == 0:
            g1 = [g.detach() for g in grads]
    delta = [p.detach() - w for p, w in zip(t.leaves, weights0.values())]
    return {"loss": losses, "grad1": _norms(g1), "g1": g1, "delta": delta}


def compare(ctx, got: Dict, want: Dict) -> List[Check]:
    """The three numbers.  Leaves whose reference gradient is under a
    thousandth of the median leaf's are left out; within a leaf, so are
    the elements whose reference gradient is under a thousandth of the
    median leaf's root-mean-square gradient (a key's bias under softmax
    has none, and Adam moves it by round-off alone) from the change."""
    lim = ctx.config["limits"]
    g_r = want["grad1"]
    keep = g_r >= 1e-3 * np.median(g_r)
    rms = np.median([float(n) / np.sqrt(g.numel())
                     for n, g in zip(g_r, want["g1"])])
    masks = [g.abs() >= 1e-3 * rms for g in want["g1"]]
    moved = {k: _norms([d * m for d, m in zip(side["delta"], masks)])
             for k, side in (("got", got), ("want", want))}
    names = [n for n, _ in ref_vit.named(ref_vit.shapes(
        **{k: ctx.config["detector"][k] for k in
           ("image_size", "patch", "width", "heads", "mlp", "depth")}))]
    left = [n for n, k in zip(names, keep) if not k]
    if left:
        ctx.log(f"leaves left out (reference gradient under 1e-3 of the "
                f"median leaf's): {left}")
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["loss"],
                                                       want["loss"]))
    grads = _leaf_gaps(got["grad1"], g_r)
    updates = _leaf_gaps(moved["got"], moved["want"])
    n_out = sum(int((~m).sum()) for m in masks)
    if n_out:
        ctx.log(f"{n_out} elements left out of the change (reference "
                f"gradient under 1e-3 of the median leaf's RMS)")
    grad_gap = float(np.median(grads[keep]))
    update_gap = float(np.median(updates[keep]))
    ctx.log(f"losses {got['loss']} against {want['loss']}")
    for what, gaps in (("grad", grads), ("update", updates)):
        worst = np.argsort(-np.where(keep, gaps, -1.0))[:3]
        ctx.log(f"worst {what} leaves: " + ", ".join(
            f"{names[i]} {gaps[i]:.3g}" for i in worst))
    # the first gradient's gap has no upper reading (the float8 control
    # and the planted faults read about what sound seeds do: PERF.md), so
    # it is printed and not compared
    ctx.log(f"first gradient, median leaf's gap {grad_gap:.4g} (read, "
            f"not compared)")
    return [Check("loss_gap", loss_gap, float(lim["loss_gap"])),
            Check("update_gap", update_gap, float(lim["update_gap"]))]
