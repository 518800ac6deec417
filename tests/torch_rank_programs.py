"""Programs the rank-group tests run on every rank.

Each is ``fn(ctx, opts) -> dict`` for ``avd_tpu_torch.parallel.dryrun``
(named ``"tests.torch_rank_programs:<fn>"``).  A rank process imports this
module and the port, never ``jax`` or ``avd_tpu``: the tests compute the
JAX side in their own process and hand the arrays over as ``.npz``.
"""

import time
import warnings

import numpy as np
import torch

from avd_tpu_torch.parallel import collectives as col
from avd_tpu_torch.parallel import distributed, halo
from avd_tpu_torch.parallel import mesh as mesh_mod


def frame_deltas(ctx, opts):
    mesh = ctx.mesh(["time"], [ctx.world])
    out = {}
    for key in sorted(k for k in ctx.inputs if k.startswith("clip")):
        feats, valid = halo.cp_frame_deltas(mesh)(
            torch.from_numpy(ctx.inputs[key]))
        out[f"{key}_feats"] = feats.numpy()
        out[f"{key}_valid"] = valid.numpy()
    return out


def attention(ctx, opts):
    """Ring and Ulysses attention on this rank's token blocks of the q, k,
    v inputs (f32 and bf16), gathered back over the token axis."""
    from avd_tpu_torch.parallel import attention as att
    n = ctx.world
    mesh = ctx.mesh(["seq"], [n])
    out = {}
    for dt in ("f32", "bf16"):
        q, k, v = (torch.from_numpy(ctx.inputs[f"{x}_{dt}"]).to(
            torch.float32 if dt == "f32" else torch.bfloat16)
            for x in "qkv")
        q, k, v = (mesh_mod.batch_slice(mesh, x.transpose(0, 2), "seq")
                   .transpose(0, 2) for x in (q, k, v))
        impls = {"ring": lambda: att.ring_attention(q, k, v, mesh, "seq", n)}
        if q.shape[1] % n == 0:
            impls["ulysses"] = lambda: att.ulysses_attention(q, k, v, mesh,
                                                             "seq")
        for name, fn in impls.items():
            o = col.all_gather(fn(), mesh, "seq", dim=2)
            out[f"{name}_{dt}"] = o.float().numpy()
    return out


def collectives(ctx, opts):
    """Each collective on rank-dependent values, and the counts it left."""
    n, r = ctx.world, ctx.rank
    mesh = ctx.mesh(["a"], [n])
    col.reset_counts()
    x = torch.arange(4, dtype=torch.float32) + 10 * r
    out = {
        "ppermute": col.ppermute(x, mesh, "a",
                                 [(i, (i + 1) % n) for i in range(n)]),
        # only 0 → 1: every other rank receives zeros
        "ppermute_partial": col.ppermute(x, mesh, "a", [(0, 1 % n)]),
        "psum": col.psum(x, mesh, "a"),
        "psum_bf16": col.psum(x.bfloat16(), mesh, "a").float(),
        "all_gather": col.all_gather(x.reshape(2, 2), mesh, "a", dim=1),
        "psum_scatter": col.psum_scatter(
            torch.arange(2 * n, dtype=torch.float32) * (r + 1), mesh, "a"),
        # [n blocks along dim 0] x 3: block j goes to rank j
        "all_to_all": col.all_to_all(
            (torch.arange(n * 3, dtype=torch.float32) + 100 * r).reshape(
                n, 3), mesh, "a", split_axis=0, concat_axis=1),
    }
    out = {k: v.numpy() for k, v in out.items()}
    out["info"] = col.counts()
    return out


GRAD_KINDS = ("all_gather0", "all_gather1", "psum_scatter", "ppermute",
              "ppermute_partial", "all_to_all", "psum", "enter")


def _grad_case(kind, x, mesh, n):
    return {
        "all_gather0": lambda: col.all_gather(x, mesh, "a", dim=0),
        "all_gather1": lambda: col.all_gather(x, mesh, "a", dim=1),
        "psum_scatter": lambda: col.psum_scatter(x, mesh, "a", dim=0),
        "ppermute": lambda: col.ppermute(
            x, mesh, "a", [(i, (i + 1) % n) for i in range(n)]),
        "ppermute_partial": lambda: col.ppermute(x, mesh, "a",
                                                 [(0, 1 % n)]),
        "all_to_all": lambda: col.all_to_all(x, mesh, "a", split_axis=0,
                                             concat_axis=1),
        "psum": lambda: col.psum(x, mesh, "a"),
        "enter": lambda: col.enter(x, mesh, "a"),
    }[kind]()


def collective_grads(ctx, opts):
    """Each collective's backward: this rank's input ``x_<dt>[rank]`` (the
    entry op's: ``x_<dt>[0]``, a value every rank holds alike) through the
    collective, this rank's share of a loss ``sum(w * y)`` with its seeded
    weights ``w_<kind>_<dt>[rank]``, and the gradient of that share with
    respect to the input; the calls each backward made, by kind."""
    n, r = ctx.world, ctx.rank
    mesh = ctx.mesh(["a"], [n])
    out, calls = {}, {}
    for dt in ("f32", "f64"):
        for kind in GRAD_KINDS:
            xs = ctx.inputs[f"x_{dt}"]
            x = torch.from_numpy(xs[0 if kind == "enter" else r].copy())
            x.requires_grad_(True)
            y = _grad_case(kind, x, mesh, n)
            w = torch.from_numpy(ctx.inputs[f"w_{kind}_{dt}"][r])
            col.reset_counts()
            (g,) = torch.autograd.grad((w * y).sum(), x)
            calls[f"{kind}_{dt}"] = col.counts()
            out[f"{kind}_{dt}"] = g.numpy()
            out[f"{kind}_{dt}_y"] = y.detach().numpy()
        with torch.no_grad():  # the forward alone: no graph, no backward
            col.reset_counts()
            col.enter(torch.from_numpy(ctx.inputs[f"x_{dt}"][r]), mesh, "a")
            calls[f"enter_no_grad_{dt}"] = col.counts()
    out["info"] = calls
    return out


def mesh_rules(ctx, opts):
    """Shapes ``make_mesh`` builds, ``cp_mesh``'s gating and the errors of
    a mesh that does not hold the group."""
    info = {}
    for axes in (("data", "model"), ("time",), ("data", "stage", "model")):
        info["/".join(axes)] = mesh_mod.mesh_shape(
            mesh_mod.make_mesh(None, axes))
    cp = distributed.cp_mesh()
    info["cp_mesh"] = None if cp is None else mesh_mod.mesh_shape(cp)
    for bad in ((ctx.world + 1, ("data",), None),
                (None, ("data", "model"), (ctx.world, 2))):
        try:
            mesh_mod.make_mesh(*bad)
            info.setdefault("errors", []).append(None)
        except ValueError as e:
            info.setdefault("errors", []).append(str(e))
    return {"info": info}


def errors(ctx, opts):
    """The shape errors of the sharded forwards, by message."""
    from avd_tpu_torch.models import detector, temporal
    msgs = {}

    def expect(name, fn):
        try:
            fn()
            msgs[name] = None
        except ValueError as e:
            msgs[name] = str(e)

    n = ctx.world
    tcfg = temporal.make_config("small", image_size=32, width=128, depth=1,
                                frame_depth=1, heads=4)
    tp = temporal.init_params(0, tcfg)
    tmesh = ctx.mesh(["time"], [n])
    clip = torch.zeros(1, 2 * n + 1, 32, 32, 3)
    expect("time_not_divisible", lambda: temporal.forward_time_sharded(
        tp, clip, tcfg, tmesh))
    tcfg3 = temporal.make_config("small", image_size=32, width=96, depth=1,
                                 frame_depth=1, heads=3)
    expect("ulysses_heads", lambda: temporal.forward_time_sharded(
        temporal.init_params(0, tcfg3), torch.zeros(1, 2 * n, 32, 32, 3),
        tcfg3, tmesh, impl="ulysses"))
    expect("unknown_impl", lambda: temporal.forward_time_sharded(
        tp, torch.zeros(1, 2 * n, 32, 32, 3), tcfg, tmesh, impl="flash"))

    smesh = ctx.mesh(["stage"], [n])
    vcfg = detector.make_config("small", image_size=32, width=64,
                                depth=n + 1, heads=4)
    vp = detector.init_params(0, vcfg)
    expect("depth", lambda: detector.forward_pipelined(
        vp, torch.zeros(8, 32, 32, 3), vcfg, smesh))
    vcfg2 = detector.make_config("small", image_size=32, width=64, depth=n,
                                 heads=4)
    vp2 = detector.init_params(0, vcfg2)
    expect("batch", lambda: detector.forward_pipelined(
        vp2, torch.zeros(6, 32, 32, 3), vcfg2, smesh, n_micro=4))
    expect("tp_needs_model", lambda: detector.forward_pipelined(
        vp2, torch.zeros(8, 32, 32, 3), vcfg2, smesh, tp=True))
    mmesh = ctx.mesh(["stage", "model"], [1, n])
    vcfg3 = detector.make_config("small", image_size=32, width=96, depth=2,
                                 heads=3)
    expect("tp_heads", lambda: detector.forward_pipelined(
        detector.init_params(0, vcfg3), torch.zeros(8, 32, 32, 3), vcfg3,
        mmesh, tp=True))
    dmesh = ctx.mesh(["data", "stage"], [n, 1])
    expect("microbatch", lambda: detector.forward_pipelined(
        vp2, torch.zeros(4, 32, 32, 3), vcfg2, dmesh, n_micro=4))
    dm = ctx.mesh(["data", "model"], [n, 1])
    expect("sharded_batch", lambda: detector.forward(
        detector.shard(dm, vp2, vcfg2), torch.zeros(n + 1, 32, 32, 3),
        vcfg2, sharded=True, mesh=dm))
    expect("sharded_mesh", lambda: detector.forward(
        vp2, torch.zeros(n, 32, 32, 3), vcfg2, sharded=True, mesh=tmesh))
    return {"info": msgs}


def scoring_case(ctx, opts):
    """``scoring.detector_timeline_resized`` under ``opts["env"]``: the
    probabilities, the warnings it raised and the weights label."""
    from avd_tpu_torch.models import scoring
    from avd_tpu_torch.parallel import dryrun
    env = {"AVD_DETECTOR": "1", **opts.get("env", {})}
    with dryrun._env(env, scoring._bundle.cache_clear), \
            warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        size = scoring.input_size(ctx.device)
        res = scoring.detector_timeline_resized(ctx.inputs[f"bgr{size}"],
                                                ctx.device)
        probs_fn = scoring._bundle(ctx.device)[2]
    return {"probs": np.asarray(res["timeline"]),
            "info": {"warnings": [str(w.message) for w in caught],
                     "weights": res["weights"],
                     "min_batch": getattr(probs_fn, "min_batch", 1)}}


def fail_on_rank(ctx, opts):
    """Rank ``opts["rank"]`` raises; the others wait in a collective."""
    if ctx.rank == opts["rank"]:
        raise ValueError(f"rank {ctx.rank} fails on purpose")
    col.barrier(ctx.device)
    return {}


def sleep_on_rank(ctx, opts):
    """Rank ``opts["rank"]`` outlives any test's launch timeout."""
    if ctx.rank == opts["rank"]:
        time.sleep(600)
    return {}


def restore(ctx, opts):
    """``load_checkpoint_sharded`` of ``opts["weights"]`` under each layout
    (tensor-parallel, FSDP, the pipeline's stacked stages with and without
    tp): every leaf this rank holds, by layout."""
    from avd_tpu_torch.models import convert, detector
    cfg = detector.make_config("small", **opts["over"])
    layouts = {
        "tp": detector.layout(ctx.mesh(["data", "model"], opts["dm"]), cfg),
        "fsdp": detector.layout(ctx.mesh(["data", "model"], opts["dm"]),
                                cfg, fsdp=True),
        "pp": detector.pp_layout(ctx.mesh(["data", "stage"], opts["ds"]),
                                 cfg),
        "pp_tp": detector.pp_layout(
            ctx.mesh(["data", "stage", "model"], opts["dsm"]), cfg, tp=True),
    }
    out = {}
    for name, lay in layouts.items():
        local = detector.load_checkpoint_sharded(opts["weights"], cfg, lay,
                                                 ctx.device)
        for key, _, v in convert._flatten(local):
            out[f"{name}/{key}"] = v.numpy()
        whole = lay.gather(local)
        for key, _, v in convert._flatten(whole):
            out[f"{name}_whole/{key}"] = v.numpy()
    return out


def trainer(ctx, opts):
    """``train.train`` on this rank of the group with ``opts["kw"]`` (the
    CPU), after copying ``opts["copy_from"]``'s save to ``kw["out"]`` when
    given: its losses and the whole trained tree it returns."""
    import shutil
    from avd_tpu_torch.models import convert, train
    if "copy_from" in opts:  # resume from a copy of an earlier save
        if ctx.rank == 0:
            out = opts["kw"]["out"]
            shutil.copytree(opts["copy_from"], out)
            shutil.copy(opts["copy_from"] + ".train", out + ".train")
        col.barrier(ctx.device)
    params, losses = train.train(device="cpu", **opts["kw"])
    out = {"loss": np.asarray(losses)}
    for key, _, v in convert._flatten(params):
        out[f"p/{key}"] = v.numpy()
    return out
