"""The port's multi-rank programs, run and held to one device.

Counterpart of ``__graft_entry__.dryrun_multichip``: the inference
programs of ``MULTICHIP_r05.json``, each over a mesh of every rank and
each held to the single-device result at ``avd_tpu``'s tolerance:

1. ``cp``: the video path's pair features (hash Hamming, Farnebäck flow
   stats) under time-axis context parallelism (``parallel/halo.py``);
2. ``vit_dm``: the ViT forward under a (data, model) mesh (tensor
   parallelism, ``detector.forward(..., sharded=True)``);
4. ``gpipe``: the GPipe forward over (data, stage);
5. ``moe_ep``: the Switch-MoE ViT with its experts over ``model``
   (routes equal, logits within tolerance);
6. ``dp_pp_tp``: the 3-D (data, stage, model) forward;
7. ``temporal_ring`` / ``temporal_ulysses``: the temporal family with
   its time axis sequence-parallel;

and ``scoring``: ``models/scoring``'s sharded branch through
``detector_timeline_resized``, which only a group of more than one rank
takes.  Then the training programs (``TRAIN_PROGRAMS``), each some steps
of a train step from one init on one set of batches, held to the same
steps on one device (the loss at every step within 2e-2, every leaf's
first-step gradient and final value within 3e-2 in relative L2):

3. ``dp_tp_train``: the dp × tp step (``detector.make_train_step(...,
   sharded=True)``);
8. ``zero1``: the same with ZeRO-1 (``parallel/zero.py``), its loss
   against the replicated step's at rtol 1e-5 / atol 1e-6 and its moment
   leaves sliced over ``data``;
9. ``fsdp``: the same with the parameters sliced over ``data``;

and ``pp_train`` (dp × pp) and ``pp_tp_train`` (dp × pp × tp): the GPipe
step (``detector.make_pp_train_step``).

``launch(nproc, device, programs)`` spawns the ranks (one process each,
``torch.multiprocessing`` spawn, a ``FileStore`` rendezvous in a scratch
directory, every collective with a timeout), runs the programs on every
rank and returns each rank's report: per program its outputs, wall ms,
collectives by kind and transport (``parallel/collectives.py``) and
kernel launches.  A rank that raises or outlives the timeout fails the
launch with its rank and traceback.  ``run_in_process`` runs the same
programs on a group of one rank in this process (NCCL on the card: every
collective a real NCCL call).  ``reference`` computes each program's
single-device result and ``check`` holds a rank's outputs to it.

A program is a name above or a dict ``{"name", "kind", ...options}``
(``mesh``: ``[axes, shape]``; ``model``, ``batch``, ``n_micro``, ``tp``,
``impl``, ``seq``; for ``train``: ``mode``, ``steps``, ``lr``,
``logit_l2``, ``grad_clip``, ``accum``, ``replicated``); a kind is one
of ``KINDS`` or ``"module:function"``,
called as ``fn(ctx, opts)`` and returning a dict of arrays.  ``spec``
names the models (family, config, weights directory or seed) and sizes;
``inputs`` holds the arrays (frames as uint8 BGR at each model's size,
the host-prep planes of the video path).

    python -m avd_tpu_torch.parallel.dryrun --nproc 4 --device cuda
    python -m avd_tpu_torch.parallel.dryrun --nproc 4 --device cpu --small
    python -m avd_tpu_torch.parallel.dryrun --nproc 4 --device cpu --small
        --programs dp_tp_train,zero1,fsdp,pp_train,pp_tp_train  (one line)

This module imports the rest of the port inside functions: a spawned
rank applies its environment before anything reads it.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional

import numpy as np

PROGRAMS = ("cp", "vit_dm", "gpipe", "moe_ep", "dp_pp_tp", "temporal_ring",
            "temporal_ulysses", "scoring")
TRAIN_PROGRAMS = ("dp_tp_train", "zero1", "fsdp", "pp_train", "pp_tp_train")
LOGIT_ATOL = 2e-2          # bf16 logits (tests/test_parallel.py:84)
CP_RTOL, CP_ATOL = 1e-5, 1e-6  # flow stats (tests/test_parallel.py:153-158)
TIMELINE_ATOL = 1e-6
# training programs (__graft_entry__.py:130-160, 241-304): the loss against
# one device's step at each step, ZeRO-1's against the replicated step's
# (rtol/atol), every leaf's first gradient and final value in relative L2,
# the clip's global norm against that of the gathered first gradients
LOSS_ATOL = 2e-2
ZERO1_RTOL, ZERO1_ATOL = 1e-5, 1e-6
LEAF_REL = 3e-2
NORM_RTOL = 1e-5

_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "models", "weights")


def full_spec() -> Dict[str, Any]:
    """The widths of the shipped models: the ``full`` ViT (224 px, width
    384, depth 6, 6 heads), ``moe_small`` (4 experts), ``temporal_small``
    at the serving window T = 32, each on its shipped weights."""
    return {
        "vit": {"family": "vit", "preset": "full",
                "weights": os.path.join(_WEIGHTS, "detector_full")},
        "moe": {"family": "vit", "preset": "moe_small",
                "weights": os.path.join(_WEIGHTS, "moe_small")},
        "temporal": {"family": "temporal", "preset": "small",
                     "weights": os.path.join(_WEIGHTS, "temporal_small")},
        "pp_batch": 32, "n_micro": 4, "temporal_t": 32,
        "scoring_env": {}, "scoring_size": 224,
        # the shipped detector_full's fine-tune recipe (train_meta.json)
        "train": {"batch": 64, "steps": 3, "lr": 1e-4, "logit_l2": 0.02},
    }


def small_spec() -> Dict[str, Any]:
    """Seeded models at the widths of ``avd_tpu``'s own parallel tests and
    dry run (32 px: 5 tokens; width 256, the temporal family 128), for CPU
    runs; the temporal window 8."""
    return {
        "vit": {"family": "vit", "preset": "small",
                "over": {"image_size": 32, "width": 256, "depth": 4,
                         "heads": 4}, "seed": 0},
        "moe": {"family": "vit", "preset": "small",
                "over": {"image_size": 32, "width": 256, "depth": 2,
                         "heads": 4, "n_experts": 4}, "seed": 1},
        "temporal": {"family": "temporal", "preset": "small",
                     "over": {"image_size": 32, "width": 128, "depth": 2,
                              "frame_depth": 1, "heads": 4}, "seed": 2},
        "pp_batch": 8, "n_micro": 4, "temporal_t": 8,
        "scoring_env": {"AVD_DETECTOR_PRESET": "small"}, "scoring_size": 64,
        # the training programs fine-tune the shipped detector_small: from
        # a seeded tree's zero biases Adam's sign-normalised steps on
        # rounding-level gradients (the key bias, which the softmax
        # ignores) differ between any two implementations
        "trained": {"family": "vit", "preset": "small",
                    "weights": os.path.join(_WEIGHTS, "detector_small")},
        "train": {"batch": 8, "steps": 3, "lr": 1e-4, "logit_l2": 0.02,
                  "model": "trained"},
    }


# ---------------------------------------------------------------------------
# models and inputs
# ---------------------------------------------------------------------------

def model(entry: Dict[str, Any]):
    """(family module, config, f32 CPU tree) of a spec entry."""
    from avd_tpu_torch import models
    from avd_tpu_torch.models import convert
    family = models.family(entry["family"])
    cfg = model_config(entry)
    if entry.get("weights"):
        params = convert.load_checkpoint(entry["weights"], cfg)
    else:
        params = family.init_params(entry.get("seed", 0), cfg)
    return family, cfg, params


def rgb(bgr: np.ndarray) -> np.ndarray:
    """uint8 BGR → f32 RGB in [0, 1], as ``scoring`` preps frames."""
    return bgr[..., ::-1].astype(np.float32) / 255.0


def make_inputs(spec: Dict[str, Any], frames_bgr: np.ndarray,
                prepped=None) -> Dict[str, np.ndarray]:
    """The arrays of the programs from one clip of uint8 BGR frames: the
    host-prep planes and textures of the video path (``prepped`` when the
    caller has them) and the frames resized to each model's input
    (``scoring.resize_frames``)."""
    from avd_tpu_torch.models import scoring
    from avd_tpu_torch.ops import host_prep
    s320, s32, tex = prepped if prepped is not None else \
        host_prep.host_prep(frames_bgr)
    out = {"s320": s320, "s32": s32, "tex": tex}
    sizes = {model_size(spec[k]) for k in ("vit", "moe", "temporal",
                                           "trained") if k in spec}
    for size in sorted(sizes | {spec["scoring_size"]}):
        out[f"bgr{size}"] = scoring.resize_frames(frames_bgr, size)
    return out


def model_config(entry: Dict[str, Any]):
    """The config of a spec entry (lists of the JSON spec as tuples)."""
    from avd_tpu_torch import models
    over = {k: tuple(v) if isinstance(v, list) else v
            for k, v in entry.get("over", {}).items()}
    return models.family(entry["family"]).make_config(entry["preset"],
                                                      **over)


def model_size(entry: Dict[str, Any]) -> int:
    return model_config(entry).image_size


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Ctx:
    """What a program sees: its rank, the group's size, the rank's device,
    the arrays, the spec, and a cache of meshes and models."""
    rank: int
    world: int
    device: Any
    inputs: Dict[str, np.ndarray]
    spec: Dict[str, Any]
    cache: Dict[Any, Any] = dataclasses.field(default_factory=dict)

    def mesh(self, axes, shape):
        from avd_tpu_torch.parallel import mesh as mesh_mod
        key = ("mesh", tuple(axes), tuple(shape))
        if key not in self.cache:
            self.cache[key] = mesh_mod.make_mesh(None, tuple(axes),
                                                 tuple(shape))
        return self.cache[key]

    def model(self, key):
        if ("model", key) not in self.cache:
            self.cache[("model", key)] = model(self.spec[key])
        return self.cache[("model", key)]


def _largest_divisor(n: int, of: int) -> int:
    return max(d for d in range(1, n + 1) if n % d == 0 and of % d == 0)


def resolve(program, world: int, spec: Dict[str, Any]) -> Dict[str, Any]:
    """A program name or dict → its options with the mesh filled in."""
    if isinstance(program, dict):
        opts = dict(program)
    else:
        opts = {"name": program}
        opts.update({
            "cp": {"kind": "cp"},
            "vit_dm": {"kind": "vit_sharded", "model": "vit"},
            "gpipe": {"kind": "gpipe", "model": "vit"},
            "moe_ep": {"kind": "vit_sharded", "model": "moe"},
            "dp_pp_tp": {"kind": "gpipe", "model": "vit", "tp": True},
            "temporal_ring": {"kind": "temporal", "impl": "ring"},
            "temporal_ulysses": {"kind": "temporal", "impl": "ulysses"},
            "scoring": {"kind": "scoring"},
            "dp_tp_train": {"kind": "train", "mode": "replicated"},
            "zero1": {"kind": "train", "mode": "zero1", "replicated": True},
            "fsdp": {"kind": "train", "mode": "fsdp"},
            "pp_train": {"kind": "train", "mode": "pp"},
            "pp_tp_train": {"kind": "train", "mode": "pp", "tp": True},
        }[program])
    kind = opts["kind"]
    if kind == "train":
        opts.setdefault("model", spec["train"].get("model", "vit"))
        if opts["mode"] == "pp":
            kind = "gpipe"
    if "mesh" not in opts:
        from avd_tpu_torch.parallel import mesh as mesh_mod
        if kind in ("cp", "temporal", "cp_compute"):
            opts["mesh"] = [["time"], [world]]
        elif kind == "vit_sharded" and opts["model"] == "moe":
            e = model_config(spec["moe"]).n_experts
            m = _largest_divisor(world, e)
            opts["mesh"] = [["data", "model"], [world // m, m]]
        elif kind == "train" and opts["model"] == "temporal":
            opts["mesh"] = [["data", "model"], [world, 1]]
        elif kind in ("vit_sharded", "cnn_sharded", "scoring", "train"):
            opts["mesh"] = [["data", "model"], list(mesh_mod.factor2(world))]
        elif kind == "gpipe" and opts.get("tp"):
            m = 2 if world % 2 == 0 else 1
            s = 2 if (world // m) % 2 == 0 else 1
            opts["mesh"] = [["data", "stage", "model"], [world // m // s, s,
                                                         m]]
        elif kind == "gpipe":
            s = 2 if world % 2 == 0 else 1
            opts["mesh"] = [["data", "stage"], [world // s, s]]
    return opts


def _flow_config(opts):
    """The feature config in force, with the fused Farnebäck round
    (``AVD_PALLAS_ITER=1``'s ``flow_iter`` kernel) when ``opts`` asks."""
    from avd_tpu_torch import config
    cfg = config.get_config()
    if opts.get("fused_iter"):
        cfg = dataclasses.replace(cfg, fused_flow_iter=True)
    return cfg


def _cp(ctx: Ctx, opts):
    from avd_tpu_torch.ops import video_features
    mesh = ctx.mesh(*opts["mesh"])
    feats = video_features.cp_features_prepped(
        ctx.inputs["s320"], ctx.inputs["s32"], ctx.inputs["tex"], mesh,
        ctx.device, _flow_config(opts))
    return _feat_arrays(feats)


def _feat_arrays(feats):
    return {"flow_means": np.asarray(feats["flow_means"]),
            "flow_vars": np.asarray(feats["flow_vars"]),
            "timeline_ai": np.asarray(feats["timeline_ai"]),
            "dup": np.asarray(feats["dup"]),
            "total": np.asarray(feats["total"])}


def _cp_compute(ctx: Ctx, opts):
    """``compute_features`` on uint8 BGR frames: its own branch picks the
    context-parallel path in a group (``distributed.cp_mesh``)."""
    from avd_tpu_torch.ops import video_features
    return _feat_arrays(video_features.compute_features(
        ctx.inputs[opts.get("input", "cp_bgr")], device=ctx.device))


def _sharded(ctx: Ctx, opts):
    """A per-frame family's ``forward(..., sharded=True)`` over (data,
    model) on the first ``batch`` frames (all by default), padded with the
    last frame to a multiple of the data axis; an MoE config also returns
    every token's expert."""
    import torch
    family, cfg, params = ctx.model(opts["model"])
    mesh = ctx.mesh(*opts["mesh"])
    key = ("shards", opts["name"])
    if key not in ctx.cache:
        ctx.cache[key] = family.cast_for_inference(
            family.shard(mesh, params, cfg), ctx.device)
    frames = torch.from_numpy(_frames_of(ctx.inputs, ctx.spec, opts["model"],
                                         opts.get("batch", 0)))
    n = frames.shape[0]
    from avd_tpu_torch.parallel import collectives
    d = collectives.axis_size(mesh, "data")
    pad = -(-n // d) * d
    if pad != n:
        frames = torch.cat([frames, frames[-1:].expand(pad - n,
                                                       *frames.shape[1:])])
    seq = {"seq_sharded": True} if opts.get("seq") else {}
    with torch.inference_mode():
        logits = family.forward(ctx.cache[key], frames, cfg, sharded=True,
                                mesh=mesh, **seq)[:n]
        out = {"logits": logits.float().cpu().numpy()}
        if getattr(cfg, "n_experts", 0):
            out["routes"] = family.expert_indices(
                ctx.cache[key], frames[:n].to(ctx.device), cfg).cpu().numpy()
    return out


def _gpipe(ctx: Ctx, opts):
    import torch
    family, cfg, params = ctx.model(opts["model"])
    mesh = ctx.mesh(*opts["mesh"])
    key = ("cast", opts["model"])
    if key not in ctx.cache:
        ctx.cache[key] = family.cast_for_inference(params, ctx.device)
    frames = torch.from_numpy(_frames_of(
        ctx.inputs, ctx.spec, opts["model"],
        opts.get("batch", ctx.spec["pp_batch"])))
    with torch.inference_mode():
        logits = family.forward_pipelined(
            ctx.cache[key], frames, cfg, mesh,
            n_micro=opts.get("n_micro", ctx.spec["n_micro"]),
            tp=opts.get("tp", False))
    return {"logits": logits.float().cpu().numpy()}


def _temporal(ctx: Ctx, opts):
    import torch
    family, cfg, params = ctx.model("temporal")
    mesh = ctx.mesh(*opts["mesh"])
    key = ("cast", "temporal")
    if key not in ctx.cache:
        ctx.cache[key] = family.cast_for_inference(params, ctx.device)
    clip = torch.from_numpy(_frames_of(ctx.inputs, ctx.spec, "temporal",
                                       ctx.spec["temporal_t"]))[None]
    with torch.inference_mode():
        logits = family.forward_time_sharded(ctx.cache[key], clip, cfg, mesh,
                                             impl=opts["impl"])
    return {"logits": logits.float().cpu().numpy()}


def train_batches(inputs, spec, key: str, batch: int, steps: int):
    """Each step's (frames, labels) from the model's frames: ``batch``
    consecutive frames (wrapping) from ``step * batch``, labels alternating
    by step; for the temporal family ``batch`` clips of
    ``spec["temporal_t"]`` frames with per-frame labels."""
    x = _frames_of(inputs, spec, key)
    temporal = model_config(spec[key]).__class__.__name__.startswith("Temp")
    per = spec["temporal_t"] if temporal else 1
    out = []
    for i in range(steps):
        idx = (i * batch * per + np.arange(batch * per)) % x.shape[0]
        f = x[idx]
        y = ((np.arange(batch * per) // 3 + i) % 2).astype(np.int32)
        if temporal:
            f = f.reshape((batch, per) + f.shape[1:])
            y = y.reshape(batch, per)
        out.append((f, y))
    return out


def _flat_named(tree, prefix=""):
    from avd_tpu_torch.models import convert
    return {name: v for name, _, v in convert._flatten(tree, prefix)}


def _train_opts(ctx_spec, opts):
    t = dict(ctx_spec["train"])
    t.update({k: opts[k] for k in ("batch", "steps", "lr", "logit_l2")
              if k in opts})
    t.pop("model", None)
    return t


def _run_steps(step, local, state, batches, dev, host: bool = True):
    """The steps → (losses, per-step ms, state); ``host``: the batches
    stay on the host (a sharded step moves its slice), else they go to
    ``dev`` first (one device's step)."""
    import torch
    losses, ms = [], []
    for f, y in batches:
        _sync(dev)
        t0 = time.perf_counter()
        f, y = torch.from_numpy(f), torch.from_numpy(y)
        if not host:
            f, y = f.to(dev), y.to(dev)
        local, state, loss = step(local, state, f, y)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms, state


def _train(ctx: Ctx, opts):
    """A training program (module docstring) on this rank: the losses, the
    first step's gradients and the final parameters (gathered to whole
    trees), and in ``info`` the per-step ms, the peak device memory, and
    what this rank holds sliced."""
    import torch
    from avd_tpu_torch.models import detector, optim
    from avd_tpu_torch.parallel import collectives as col
    from avd_tpu_torch.parallel import zero
    family, cfg, params = ctx.model(opts["model"])
    mesh = ctx.mesh(*opts["mesh"])
    t = _train_opts(ctx.spec, opts)
    dev = ctx.device
    batches = train_batches(ctx.inputs, ctx.spec, opts["model"], t["batch"],
                            t["steps"])
    mode = opts["mode"]

    def build(mode):
        optimizer = family.make_optimizer(
            t["lr"], grad_clip=opts.get("grad_clip", 0.0),
            accum=opts.get("accum", 1))
        if mode == "pp":
            step = detector.make_pp_train_step(
                cfg, optimizer, mesh, opts.get("n_micro",
                                               ctx.spec["n_micro"]),
                tp=opts.get("tp", False))
            lay = step.layout
        elif mode == "zero1":
            lay = family.layout(mesh, cfg)
            step = zero.zero1_train_step(family, cfg, optimizer, mesh,
                                         t["logit_l2"])
        else:
            zkw = {"zero_mode": "fsdp"} if mode == "fsdp" else {}
            lay = family.layout(mesh, cfg, fsdp=mode == "fsdp")
            step = family.make_train_step(cfg, optimizer,
                                          logit_l2=t["logit_l2"],
                                          sharded=True, mesh=mesh, **zkw)
        local = detector._map_tree(lambda _, v: v.to(dev), lay.shard(params))
        leaves = optim.leaves_of(local)
        return step, lay, local, leaves, step.dp.init(leaves)

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    step, lay, local, leaves, state = build(mode)
    col.reset_counts()
    losses, ms, state = _run_steps(step, local, state, batches[:1], dev)
    calls = dict(col.COUNTS)
    grads = lay.gather(optim.unflatten(local, step.dp.full_grads(leaves)))
    grad_norm = float(step.dp.global_norm(leaves))
    col.reset_counts()
    more, ms2, state = _run_steps(step, local, state, batches[1:], dev)
    for k, v in calls.items():  # the steps' calls, not the gathers'
        col.COUNTS[k] = col.COUNTS.get(k, 0) + v
    step_calls = col.counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    out = {"loss": np.asarray(losses + more),
           "grad_norm": np.asarray(grad_norm)}
    out.update({f"p/{k}": v.float().cpu().numpy() for k, v in
                _flat_named(lay.gather(local)).items()})
    out.update({f"g/{k}": v.float().cpu().numpy() for k, v in
                _flat_named(grads).items()})
    info = {"step_ms": ms + ms2, "peak_bytes": peak, "mode": mode,
            "step_collectives": step_calls,
            # what this rank holds: its leaves' and moments' elements
            # against the whole tree's, and the leaves cut over data
            "param_numel": sum(p.numel() for p in leaves),
            "moment_numel": sum(m.numel() for m in state["mu"]),
            "tree_numel": sum(p.numel() for p in optim.leaves_of(params)),
            "data_sliced_params": sum(
                int(p.numel() < w.numel()) for p, w, s in zip(
                    leaves, optim.leaves_of(lay.permute(params)),
                    zero.spec_leaves(lay.specs)) if "data" in s),
            "data_sliced_moments": sum(int(m.numel() < p.numel()) for m, p
                                       in zip(state["mu"], leaves)),
            "leaves": len(leaves)}
    # program 8's and 9's shard checks (where the data axis can shard)
    if mode == "zero1" and col.axis_size(mesh, "data") > 1:
        out["sliced_moments"] = np.asarray(info["data_sliced_moments"])
    if mode == "fsdp" and col.axis_size(mesh, "data") > 1:
        out["sliced_params"] = np.asarray(info["data_sliced_params"])
    if opts.get("replicated"):  # ZeRO-1's yardstick: the replicated step
        step_r, _, local_r, _, state_r = build("replicated")
        out["loss_replicated"] = np.asarray(
            _run_steps(step_r, local_r, state_r, batches, dev)[0])
    out["info"] = info
    return out


@contextlib.contextmanager
def _env(env: Dict[str, str], reset):
    """``env`` set in ``os.environ`` around the block, ``reset()`` called
    on entry and on exit (a cache that read the old settings)."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset()
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        reset()


def _score(spec, inputs, device) -> Dict[str, np.ndarray]:
    """``scoring.detector_timeline_resized`` with the detector on
    (``spec["scoring_env"]`` adds settings)."""
    from avd_tpu_torch.models import scoring
    env = {"AVD_DETECTOR": "1", **spec.get("scoring_env", {})}
    with _env(env, scoring._bundle.cache_clear):
        res = scoring.detector_timeline_resized(
            inputs[f"bgr{spec['scoring_size']}"], device)
    return {"probs": np.asarray(res["timeline"], np.float64)}


def _scoring(ctx: Ctx, opts):
    """``scoring.detector_timeline_resized`` with the detector on: the
    sharded branch in a group of more than one rank."""
    return _score(ctx.spec, ctx.inputs, ctx.device)


def _probe_all_reduce(ctx: Ctx, opts):
    """One ``psum`` over every rank (the NCCL probe of two ranks on one
    card)."""
    import torch
    from avd_tpu_torch.parallel import collectives
    mesh = ctx.mesh(["world"], [ctx.world])
    x = torch.full((4,), float(ctx.rank + 1), device=ctx.device)
    return {"sum": collectives.psum(x, mesh, "world").cpu().numpy()}


def _probe_gloo(ctx: Ctx, opts):
    from avd_tpu_torch.parallel import collectives
    return {"info": collectives.probe_gloo_cuda(ctx.device,
                                                opts["collective"])}


def probe_gloo(device: str = "cuda", timeout_s: float = 120.0
               ) -> Dict[str, str]:
    """Which collectives gloo takes on ``device`` tensors unstaged: each
    kind on two fresh ranks (a refusal may abort the process) →
    ``{kind: "ok" | what went wrong}``."""
    from avd_tpu_torch.parallel import collectives
    out = {}
    for kind in collectives.PROBE_KINDS:
        try:
            ranks = launch(2, device, [{"name": kind, "kind": "probe_gloo",
                                        "collective": kind}],
                           backend="gloo", timeout_s=timeout_s)
            said = {r["programs"][kind]["info"] for r in ranks}
            out[kind] = " / ".join(sorted(said))
        except RankFailed as e:
            lines = [ln for ln in str(e).splitlines() if ln.strip()]
            out[kind] = f"{lines[0]} {lines[-1]}"[:300]
    return out


KINDS = {"cp": _cp, "cp_compute": _cp_compute, "vit_sharded": _sharded,
         "cnn_sharded": _sharded, "gpipe": _gpipe, "train": _train,
         "temporal": _temporal, "scoring": _scoring,
         "probe_all_reduce": _probe_all_reduce, "probe_gloo": _probe_gloo}


def _kind_fn(kind: str):
    if kind in KINDS:
        return KINDS[kind]
    mod, _, fn = kind.partition(":")
    return getattr(importlib.import_module(mod), fn)


def _kernel_counts() -> Dict[str, int]:
    from avd_tpu_torch.ops.kernels import (attention, blur_solve, flow_iter,
                                           warp)
    return {"warp_bilinear": warp.LAUNCHES,
            "box_blur_solve": blur_solve.LAUNCHES,
            "solve_iteration": flow_iter.LAUNCHES, "mha": attention.LAUNCHES}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_programs(ctx: Ctx, programs, reps: int = 1):
    """Run each program ``reps`` times on this rank (the last run is the
    one timed, counted and kept) → (report, outputs)."""
    from avd_tpu_torch.parallel import collectives
    report, outputs = {}, {}
    for program in programs:
        opts = resolve(program, ctx.world, ctx.spec)
        fn = _kind_fn(opts["kind"])
        for _ in range(reps):
            collectives.barrier(ctx.device)
            _sync(ctx.device)
            before = _kernel_counts()
            collectives.reset_counts()
            t0 = time.perf_counter()
            out = fn(ctx, opts)
            _sync(ctx.device)
            ms = (time.perf_counter() - t0) * 1e3
        after = _kernel_counts()
        info = out.pop("info", None)
        report[opts["name"]] = {
            "ms": ms, "collectives": collectives.counts(),
            "launches": {k: after[k] - before[k] for k in after},
            "mesh": opts.get("mesh"), "info": info}
        outputs[opts["name"]] = {k: np.asarray(v) for k, v in out.items()}
    return report, outputs


# ---------------------------------------------------------------------------
# single-device references and checks
# ---------------------------------------------------------------------------

def reference(programs, inputs: Dict[str, np.ndarray], spec: Dict[str, Any],
              device, frames_bgr: Optional[np.ndarray] = None,
              times: Optional[Dict[str, float]] = None, reps: int = 1):
    """Each program's single-device result on ``device``, in this process
    (no group).  ``cp``'s is ``compute_features`` on ``frames_bgr`` when
    given (the clip the planes came from; with ``fused_iter`` under
    ``AVD_PALLAS_ITER=1``), else one device window over all the planes
    (``run_prep_window``).  Each runs ``reps`` times; ``times`` receives
    the last run's wall ms by program."""
    import torch
    dev = torch.device(device)
    out = {}
    cache: Dict[Any, Any] = {}

    def cast(key):
        if key not in cache:
            family, cfg, params = model(spec[key])
            cache[key] = (family, cfg, family.cast_for_inference(params, dev))
        return cache[key]

    def logits(key, n=0):
        family, cfg, params = cast(key)
        x = torch.from_numpy(_frames_of(inputs, spec, key, n))
        with torch.inference_mode():
            if family.__name__.endswith("temporal"):
                return family.forward(params, x[None].to(dev), cfg)
            return family.forward(params, x.to(dev), cfg)

    for program in programs:
        opts = resolve(program, 1, spec)
        for _ in range(reps):
            _sync(dev)
            t0 = time.perf_counter()
            out[opts["name"]] = _reference_one(opts, inputs, spec, dev,
                                               frames_bgr, cast, logits)
            _sync(dev)
        if times is not None:
            times[opts["name"]] = (time.perf_counter() - t0) * 1e3
    return out


def _reference_one(opts, inputs, spec, dev, frames_bgr, cast, logits):
    import torch
    from avd_tpu_torch import config
    from avd_tpu_torch.ops import video_features
    kind = opts["kind"]
    if kind == "cp":
        if frames_bgr is not None:
            env = {"AVD_PALLAS_ITER": "1" if opts.get("fused_iter") else "0"}
            with _env(env, config.reset_config):
                return _feat_arrays(video_features.compute_features(
                    frames_bgr, dev))
        s320, s32, tex = inputs["s320"], inputs["s32"], inputs["tex"]
        vec = video_features.run_prep_window(
            s320, s32, dev, _flow_config(opts)).cpu().numpy()
        k = s320.shape[0] - 1
        return _feat_arrays(video_features._assemble(
            {"dup": 0, "total": k + 1}, list(tex), vec[:k].tolist(),
            vec[k:2 * k].tolist(), vec[2 * k:].tolist()))
    if kind in ("vit_sharded", "cnn_sharded"):
        out = {"logits": logits(opts["model"], opts.get("batch", 0))
               .float().cpu().numpy()}
        family, cfg, params = cast(opts["model"])
        if getattr(cfg, "n_experts", 0):
            x = torch.from_numpy(_frames_of(inputs, spec, opts["model"],
                                            opts.get("batch", 0)))
            out["routes"] = family.expert_indices(params, x.to(dev),
                                                  cfg).cpu().numpy()
        return out
    if kind == "gpipe":
        return {"logits": logits(opts["model"], opts.get(
            "batch", spec["pp_batch"])).float().cpu().numpy()}
    if kind == "temporal":
        return {"logits": logits("temporal", spec["temporal_t"])
                .float().cpu().numpy()}
    if kind == "scoring":
        return _score(spec, inputs, dev)
    if kind == "train":
        return _train_reference(opts, inputs, spec, dev)
    raise ValueError(f"no single-device reference for kind {kind!r}")


def _train_reference(opts, inputs, spec, dev):
    """A training program's steps on one device (the pipelined loss is the
    BCE alone, as ``make_pp_train_step``'s)."""
    import torch
    from avd_tpu_torch.models import detector, optim
    family, cfg, params = model(spec[opts["model"]])
    t = _train_opts(spec, opts)
    l2 = 0.0 if opts["mode"] == "pp" else t["logit_l2"]
    optimizer = family.make_optimizer(t["lr"],
                                      grad_clip=opts.get("grad_clip", 0.0),
                                      accum=opts.get("accum", 1))
    step = family.make_train_step(cfg, optimizer, logit_l2=l2)
    p = detector._map_tree(
        lambda _, v: v.detach().to(dev, torch.float32).clone(), params)
    leaves = optim.leaves_of(p)
    state = optimizer.init(leaves)
    batches = train_batches(inputs, spec, opts["model"], t["batch"],
                            t["steps"])
    f0, y0 = (torch.from_numpy(a).to(dev) for a in batches[0])
    for x in leaves:
        x.requires_grad_(True)
    grads = torch.autograd.grad(family.loss_fn(p, f0, y0, cfg, logit_l2=l2),
                                leaves, materialize_grads=True)
    losses, ms, _ = _run_steps(step, p, state, batches, dev, host=False)
    out = {"loss": np.asarray(losses), "step_ms": np.asarray(ms)}
    out.update({f"p/{k}": v.detach().float().cpu().numpy()
                for k, v in _flat_named(p).items()})
    out.update({f"g/{k}": v.float().cpu().numpy() for k, v in
                _flat_named(optim.unflatten(p, list(grads))).items()})
    return out


def leaf_rel_l2(got: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                prefix: str) -> Dict[str, float]:
    """``|got - ref| / |ref|`` (L2) of every leaf named ``prefix/...``."""
    out = {}
    for k in ref:
        if k.startswith(prefix + "/"):
            a = np.asarray(got[k], np.float64)
            b = np.asarray(ref[k], np.float64)
            scale = float(np.linalg.norm(b))
            err = float(np.linalg.norm(a - b))
            out[k] = err / scale if scale > 0 else (0.0 if err == 0
                                                     else float("inf"))
    return out


def _frames_of(inputs, spec, key, n=0) -> np.ndarray:
    """The first ``n`` (all by default) frames at model ``key``'s size,
    f32 RGB."""
    bgr = inputs[f"bgr{model_size(spec[key])}"]
    return rgb(bgr[:n] if n else bgr)


def check(name: str, got: Dict[str, np.ndarray],
          ref: Dict[str, np.ndarray]) -> float:
    """Hold one program's outputs to its single-device result → the
    largest |Δ|; raises AssertionError naming the program."""
    try:
        if "loss" in ref:
            return _check_train(got, ref)
        if "flow_means" in ref:
            assert int(got["total"]) == int(ref["total"])
            assert int(got["dup"]) == int(ref["dup"]), (got["dup"],
                                                        ref["dup"])
            for k in ("flow_means", "flow_vars"):
                np.testing.assert_allclose(got[k], ref[k], rtol=CP_RTOL,
                                           atol=CP_ATOL, err_msg=k)
            np.testing.assert_allclose(got["timeline_ai"],
                                       ref["timeline_ai"],
                                       atol=TIMELINE_ATOL)
            keys = ("flow_means", "flow_vars", "timeline_ai")
        else:
            if "routes" in ref:
                np.testing.assert_array_equal(got["routes"], ref["routes"])
            keys = [k for k in ("logits", "probs") if k in ref]
            for k in keys:
                np.testing.assert_allclose(got[k], ref[k], atol=LOGIT_ATOL)
    except AssertionError as e:
        raise AssertionError(f"program {name}: {e}") from None
    return max(float(np.max(np.abs(np.asarray(got[k], np.float64)
                                   - np.asarray(ref[k], np.float64))))
               for k in keys)


def _check_train(got, ref) -> float:
    """A training program against one device → its largest per-leaf
    relative L2 of the updated parameters.  The first step's gradients are
    held leaf by leaf too (Adam's update hardly changes with the scale of
    a gradient, so only they show a backward pass off by a factor), and
    the clip's global norm (``DataParallel.global_norm``, summed over the
    shards) against the norm of the same gradients gathered to whole
    leaves, at ``NORM_RTOL``: a leaf counted once per member of an axis
    that holds it alike, or a shard left out of the sum, moves it."""
    np.testing.assert_allclose(got["loss"], ref["loss"], atol=LOSS_ATOL,
                               rtol=0, err_msg="loss against one device")
    if "loss_replicated" in got:
        np.testing.assert_allclose(got["loss"], got["loss_replicated"],
                                   rtol=ZERO1_RTOL, atol=ZERO1_ATOL,
                                   err_msg="loss against the replicated "
                                           "step")
    if "sliced_moments" in got:
        assert int(got["sliced_moments"]) >= 8, \
            f"only {int(got['sliced_moments'])} moment leaves data-sharded"
    if "sliced_params" in got:
        assert int(got["sliced_params"]) > 0, \
            "FSDP params not physically sharded"
    grads = leaf_rel_l2(got, ref, "g")
    worst = max(grads, key=grads.get)
    assert grads[worst] <= LEAF_REL, \
        f"first-step gradient {worst}: relative L2 {grads[worst]:.3g}"
    if "grad_norm" in got:
        gathered = np.sqrt(sum(np.sum(np.square(got[k], dtype=np.float64))
                               for k in grads))
        np.testing.assert_allclose(float(got["grad_norm"]), gathered,
                                   rtol=NORM_RTOL, err_msg="the clip's norm "
                                   "against the gathered gradients'")
    rel = leaf_rel_l2(got, ref, "p")
    worst = max(rel, key=rel.get)
    assert rel[worst] <= LEAF_REL, f"{worst}: relative L2 {rel[worst]:.3g}"
    return rel[worst]


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _save(workdir: str, rank: int, report, outputs) -> None:
    np.savez(os.path.join(workdir, f"out_{rank}.npz"),
             **{f"{p}/{k}": v for p, d in outputs.items()
                for k, v in d.items()})
    with open(os.path.join(workdir, f"report_{rank}.json"), "w") as f:
        json.dump(report, f)


def _load_inputs(workdir: str) -> Dict[str, np.ndarray]:
    path = os.path.join(workdir, "inputs.npz")
    if not os.path.exists(path):
        return {}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _rank_main(rank: int, world: int, device: str, backend, workdir: str,
               programs, spec, env, reps: int, timeout_s: float) -> None:
    os.environ.update(env)
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        import torch
        from avd_tpu_torch.parallel import distributed
        if device == "cpu":  # the ranks share the host's cores
            torch.set_num_threads(1)
        distributed.initialize(device, backend,
                               init_method=f"file://{workdir}/store",
                               world_size=world, rank=rank,
                               timeout_s=timeout_s)
        ctx = Ctx(rank, world, distributed.rank_device(),
                  _load_inputs(workdir), spec)
        report, outputs = run_programs(ctx, programs, reps)
        _save(workdir, rank, report, outputs)
        distributed.shutdown()
    except BaseException:
        with open(os.path.join(workdir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


class RankFailed(RuntimeError):
    """A rank of a launch raised, exited or timed out."""


def launch(nproc: int, device: str = "cuda", programs=PROGRAMS, *,
           inputs: Optional[Dict[str, np.ndarray]] = None,
           spec: Optional[Dict[str, Any]] = None,
           backend: Optional[str] = None, env: Optional[Dict[str, str]] = None,
           reps: int = 1, timeout_s: float = 900.0,
           collective_timeout_s: float = 120.0,
           workdir: Optional[str] = None) -> List[Dict[str, Any]]:
    """Spawn ``nproc`` ranks on ``device`` (``cuda``: each binds
    ``cuda:rank % device_count()``; several ranks share one card over
    ``gloo``), run ``programs`` on each, and return every rank's report:
    ``{"rank", "programs": {name: {"ms", "collectives", "launches",
    "mesh", "info", "outputs"}}}``.

    The backend defaults to ``gloo`` (NCCL refuses two ranks on one card;
    pass ``backend="nccl"`` for one rank a card).  A rank that raises or
    exits non-zero stops the others and raises ``RankFailed`` with its
    traceback, as does any rank still running after ``timeout_s``."""
    import multiprocessing as mp

    from avd_tpu_torch import device as device_mod
    device_mod.resolve(device)  # CUDA asked for and absent: raise here
    spec = spec or full_spec()
    env = dict(env or {})
    if os.path.isdir("/sys/class/net/lo"):
        env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    work = tempfile.mkdtemp(prefix="avd_ranks_", dir=workdir)
    procs = []
    try:
        if inputs:
            np.savez(os.path.join(work, "inputs.npz"), **inputs)
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(
            target=_rank_main,
            args=(r, nproc, device, backend or "gloo", work, list(programs),
                  spec, env, reps, collective_timeout_s))
            for r in range(nproc)]
        for p in procs:
            p.start()
        _wait(procs, work, timeout_s)
        return [_read(work, r) for r in range(nproc)]
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=30)
        shutil.rmtree(work, ignore_errors=True)


def _wait(procs, work: str, timeout_s: float) -> None:
    deadline = time.monotonic() + timeout_s
    while True:
        codes = [p.exitcode for p in procs]
        bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
        if bad:  # every rank that has failed (one's fault may stop others)
            raise RankFailed("\n".join(
                f"rank {r} of {len(procs)} failed (exit {codes[r]}):\n"
                f"{_traceback(work, r)}" for r in bad))
        if all(c == 0 for c in codes):
            return
        if time.monotonic() > deadline:
            alive = [r for r, c in enumerate(codes) if c is None]
            raise RankFailed(f"ranks {alive} of {len(procs)} still running "
                             f"after {timeout_s:.0f} s")
        time.sleep(0.05)


def _traceback(work: str, rank: int) -> str:
    path = os.path.join(work, f"error_{rank}.txt")
    if not os.path.exists(path):
        return "(no traceback: the process died)"
    with open(path) as f:
        return f.read()


def _read(work: str, rank: int) -> Dict[str, Any]:
    with open(os.path.join(work, f"report_{rank}.json")) as f:
        report = json.load(f)
    with np.load(os.path.join(work, f"out_{rank}.npz")) as z:
        for key in z.files:
            prog, name = key.split("/", 1)
            report[prog].setdefault("outputs", {})[name] = z[key]
    for prog in report.values():
        prog.setdefault("outputs", {})
    return {"rank": rank, "programs": report}


def run_in_process(programs, inputs: Dict[str, np.ndarray],
                   spec: Dict[str, Any], device: str = "cuda",
                   backend: Optional[str] = None, reps: int = 1,
                   timeout_s: float = 300.0) -> Dict[str, Any]:
    """The programs on a group of one rank in this process (``nccl`` on
    CUDA by default): every collective a real call of the backend."""
    from avd_tpu_torch.parallel import distributed
    work = tempfile.mkdtemp(prefix="avd_rank1_")
    try:
        distributed.initialize(device, backend,
                               init_method=f"file://{work}/store",
                               world_size=1, rank=0, timeout_s=timeout_s)
        try:
            ctx = Ctx(0, 1, distributed.rank_device(), inputs, spec)
            report, outputs = run_programs(ctx, programs, reps)
        finally:
            distributed.shutdown()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for name, out in outputs.items():
        report[name]["outputs"] = out
    return {"rank": 0, "programs": report}


# ---------------------------------------------------------------------------
# command line
# ---------------------------------------------------------------------------

def demo_clip(n: int = 145, h: int = 360, w: int = 640,
              seed: int = 0) -> np.ndarray:
    """A seeded panning clip of uint8 BGR frames: smooth noise shifted by
    (3, 5) px a frame."""
    rng = np.random.default_rng(seed)
    base = rng.random((h + 3 * n + 8, w + 5 * n + 8, 3)).astype(np.float32)
    for axis in (0, 1):  # a 9-tap box smooth, twice, along each axis
        for _ in range(2):
            base = sum(np.roll(base, s, axis=axis) for s in range(-4, 5)) / 9
    base = (base - base.min()) / (base.max() - base.min()) * 255.0
    return np.stack([base[3 * i:3 * i + h, 5 * i:5 * i + w]
                     for i in range(n)]).astype(np.uint8)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"))
    ap.add_argument("--small", action="store_true",
                    help="narrow seeded models and a short clip (CPU)")
    ap.add_argument("--programs", default=",".join(PROGRAMS),
                    help="comma-separated programs; the training ones: "
                         + ",".join(TRAIN_PROGRAMS))
    ap.add_argument("--probe-gloo", action="store_true",
                    help="only report which collectives gloo takes on the "
                         "device's tensors without staging")
    args = ap.parse_args(argv)
    import torch
    if args.probe_gloo:
        for kind, said in probe_gloo(args.device).items():
            print(f"gloo {kind} on {args.device} tensors: {said}")
        return 0
    spec = small_spec() if args.small else full_spec()
    programs = args.programs.split(",")
    frames = demo_clip(19, 96, 128) if args.small else demo_clip()
    inputs = make_inputs(spec, frames)
    single_ms: Dict[str, float] = {}
    ref = reference(programs, inputs, spec, args.device, frames,
                    times=single_ms, reps=2)
    ranks = launch(args.nproc, args.device, programs, inputs=inputs,
                   spec=spec, backend=args.backend, reps=2)
    if args.device == "cuda":
        import subprocess
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        name = "; ".join(smi.stdout.strip().splitlines()) or \
            torch.cuda.get_device_name(0)
    else:
        name = "cpu"
    print(f"{args.nproc} ranks over {args.backend or 'gloo'} on {name}")
    failed = False
    for prog in programs:
        if prog == "scoring" and args.nproc == 1:
            continue
        for r in ranks:
            rep = r["programs"][prog]
            try:
                err = check(prog, rep["outputs"], ref[prog])
                status = f"max |Δ| {err:.3g}"
            except AssertionError as e:
                status, failed = f"FAILED {e}", True
            print(f"{prog:17s} rank {r['rank']}: {rep['ms']:9.2f} ms "
                  f"(one device {single_ms[prog]:.2f})  {status}  "
                  f"collectives {rep['collectives']}  "
                  f"launches {rep['launches']}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
