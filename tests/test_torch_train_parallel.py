"""Training over a rank group (CPU, gloo) against one device and against
``avd_tpu``.

The port's train steps run on 2 and 4 ranks spawned by
``parallel.dryrun.launch`` (the ``train`` programs of ``parallel/dryrun``;
the ranks import neither ``jax`` nor ``avd_tpu``), from the shipped trained
``small`` trees (64 px, width 256, depth 4; the ``moe_small``,
``cnn_small`` and ``temporal_small`` ones for the other families) at the
shipped recipe's rate, 1e-4, and logit L2, 0.02, for 3 steps on one set of
batches.  Trained trees, not seeded ones, because Adam moves an element by
about ±lr whatever its gradient: a zero-initialised leaf whose gradient is
rounding noise (the attention's key bias, which the softmax ignores) would
differ by O(1) relative to its own size between any two implementations
(from ``avd_tpu``'s seeded CNN the zero depthwise biases differ by 20 %
after 3 steps).
Each program is held as ``__graft_entry__.py:130-160, 241-304`` holds
``avd_tpu``'s (``dryrun.check``): the loss within 2e-2 of the port's
single-device step at every step, every leaf's first-step gradient and
final value within 3e-2 in relative L2 (the bound and form of
``tests/test_torch_train_parity.py``), the clip's global norm over the
shards equal to that of the gathered gradients (rtol 1e-5), ZeRO-1's loss
within rtol 1e-5 / atol 1e-6 of the replicated step's in the same
program:

* the dp × tp step of the dense ViT, the Switch-MoE ViT and the CNN, and
  the temporal family data-parallel;
* the GPipe step over (data, stage) and (data, stage, model);
* ZeRO-1 (plain, with ``accum=2``, with a ``grad_clip`` low enough to
  clip), its moments sliced on every rank; FSDP, its parameters sliced;
  the GPipe step over (data, stage, model) with the same clip.

Against ``avd_tpu`` on the suite's 8-device virtual mesh: 3 steps of each
family's ``make_train_step(sharded=True)`` under (data 4, model 2) and of
the ViT's ``make_pp_train_step`` under (data 2, stage 2) and (data 2,
stage 2, model 2), at the same init and batches: the loss within 2e-2 at
each step, the first-step gradients and updated parameters within 3e-2
per leaf.  Not met for the CNN's gradients: at the shipped ``cnn_small``
weights the one-device port's stem-bias gradient is already 3.4 % from
``avd_tpu``'s (a gap of the single-device numerics, ROADMAP.md §3); the
CNN's group steps are held to add nothing to that gap (0.1 %), and their
losses and parameters to the bounds.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avd_tpu.models import cnn as jcnn
from avd_tpu.models import detector as jdet
from avd_tpu.models import temporal as jtem
from avd_tpu.parallel import mesh as jmesh
from avd_tpu_torch.models import convert, optim
from avd_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "avd_tpu_torch", "models", "weights")
LOSS_ATOL, LEAF_REL = dryrun.LOSS_ATOL, dryrun.LEAF_REL
# the sharded blocks sum f32 partial products where one device rounds each
# product: the global norms differ by at most 7.8e-5 on these cases; a
# factor of an axis's size on any leaf group is caught at 1e-5 against the
# gathered gradients' norm
ONE_DEVICE_NORM_RTOL = 1e-3
TRAIN = {"batch": 8, "steps": 3, "lr": 1e-4, "logit_l2": 0.02}

SPEC = {
    "vit": {"family": "vit", "preset": "small",
            "weights": os.path.join(WEIGHTS, "detector_small")},
    "moe": {"family": "vit", "preset": "moe_small",
            "weights": os.path.join(WEIGHTS, "moe_small")},
    "cnn": {"family": "cnn", "preset": "small",
            "weights": os.path.join(WEIGHTS, "cnn_small")},
    "temporal": {"family": "temporal", "preset": "small",
                 "weights": os.path.join(WEIGHTS, "temporal_small")},
    "n_micro": 4, "temporal_t": 4, "train": TRAIN,
}


def _p(name, model, mode, axes, shape, **opts):
    return {"name": name, "kind": "train", "model": model, "mode": mode,
            "mesh": [list(axes), list(shape)], **opts}


DM, DSM = ("data", "model"), ("data", "stage", "model")
CASES = {
    4: [_p("vit", "vit", "replicated", DM, (2, 2)),
        _p("moe", "moe", "replicated", DM, (2, 2)),
        _p("cnn", "cnn", "replicated", DM, (2, 2)),
        _p("temporal", "temporal", "replicated", DM, (4, 1), batch=4),
        _p("pp", "vit", "pp", ("data", "stage"), (2, 2)),
        _p("pp_tp", "vit", "pp", DSM, (1, 2, 2), tp=True),
        _p("pp_tp_clip", "vit", "pp", DSM, (1, 2, 2), tp=True,
           grad_clip=0.05),
        _p("zero1", "vit", "zero1", DM, (2, 2), replicated=True),
        _p("zero1_accum", "vit", "zero1", DM, (2, 2), replicated=True,
           accum=2, steps=4),
        _p("zero1_clip", "vit", "zero1", DM, (2, 2), replicated=True,
           grad_clip=0.05),
        _p("fsdp", "vit", "fsdp", DM, (2, 2)),
        _p("cnn_zero1", "cnn", "zero1", DM, (4, 1), replicated=True),
        _p("cnn_fsdp", "cnn", "fsdp", DM, (2, 2))],
    2: [_p("vit", "vit", "replicated", DM, (1, 2)),
        _p("moe", "moe", "replicated", DM, (1, 2)),
        _p("cnn", "cnn", "replicated", DM, (2, 1)),
        _p("temporal", "temporal", "replicated", DM, (2, 1), batch=4),
        _p("pp", "vit", "pp", ("data", "stage"), (1, 2)),
        _p("pp_tp", "vit", "pp", DSM, (1, 1, 2), tp=True),
        _p("zero1", "vit", "zero1", DM, (2, 1), replicated=True),
        _p("fsdp", "vit", "fsdp", DM, (2, 1))],
}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(inputs, single-device references by world and case, launches)."""
    work = tmp_path_factory.mktemp("train_parallel")
    bgr = np.random.default_rng(0).integers(
        0, 256, (32, 64, 64, 3)).astype(np.uint8)
    inputs = {"bgr64": bgr}
    refs, launches = {}, {}
    for n in (4, 2):
        refs[n] = {c["name"]: dryrun.reference([dict(c, name="r")], inputs,
                                               SPEC, "cpu")["r"]
                   for c in CASES[n]}
        launches[n] = dryrun.launch(n, "cpu", CASES[n], inputs=inputs,
                                    spec=SPEC, timeout_s=600,
                                    workdir=str(work))
    return inputs, refs, launches


def _case(n, name):
    return next(c for c in CASES[n] if c["name"] == name)


def _ranks(setup, n, name):
    return [r["programs"][name] for r in setup[2][n]]


CHECKED = [(n, c["name"]) for n in (4, 2) for c in CASES[n]]


@pytest.mark.parametrize("n,name", CHECKED)
def test_group_step_equals_one_device(setup, n, name):
    ref = setup[1][n][name]
    steps = _case(n, name).get("steps", TRAIN["steps"])
    for rep in _ranks(setup, n, name):
        out = rep["outputs"]
        assert out["loss"].shape == (steps,) and np.isfinite(
            out["loss"]).all()
        dryrun.check(name, out, ref)  # the first gradients per leaf too


@pytest.mark.parametrize("n,name", [(n, c["name"]) for n in (4, 2)
                                    for c in CASES[n]
                                    if c["mode"] == "replicated"
                                    and c["model"] != "temporal"])
def test_replicated_leaves_equal_on_every_model_rank(setup, n, name):
    """The first step's reduced gradients, gathered: every rank holds the
    same whole tree (a missing entry op leaves each model rank a partial
    gradient of the LayerNorms, biases, embedding and head)."""
    reps = _ranks(setup, n, name)
    for rep in reps[1:]:
        for k, v in rep["outputs"].items():
            if k.startswith(("g/", "p/")):
                np.testing.assert_array_equal(v, reps[0]["outputs"][k],
                                              err_msg=k)


@pytest.mark.parametrize("n,name", [(4, "zero1"), (4, "zero1_accum"),
                                    (4, "zero1_clip"), (2, "zero1"),
                                    (4, "cnn_zero1")])
def test_zero1_slices_the_moments(setup, n, name):
    case = _case(n, name)
    d = case["mesh"][1][0]
    for rep in _ranks(setup, n, name):
        info = rep["info"]
        assert info["data_sliced_moments"] >= 8, info
        assert info["data_sliced_params"] == 0
        # every sliced moment holds 1/|data| of its leaf
        assert info["moment_numel"] < info["param_numel"]
        assert info["moment_numel"] > info["param_numel"] / d - 1e4
        np.testing.assert_allclose(rep["outputs"]["loss"],
                                   rep["outputs"]["loss_replicated"],
                                   rtol=dryrun.ZERO1_RTOL,
                                   atol=dryrun.ZERO1_ATOL)


def _norm(tree):
    return np.sqrt(sum(float(np.sum(v.astype(np.float64) ** 2))
                       for k, v in tree.items() if k.startswith("g/")))


@pytest.mark.parametrize("plain,clipped", [("zero1", "zero1_clip"),
                                           ("pp_tp", "pp_tp_clip")])
def test_grad_clip_clips(setup, plain, clipped):
    """The clip bound is below the first step's global gradient norm, so
    the step with it updates otherwise than without it."""
    norm = _norm(setup[1][4][clipped])
    assert norm > 4 * _case(4, clipped)["grad_clip"], norm
    ranks = setup[2][4][0]["programs"]
    assert abs(ranks[plain]["outputs"]["loss"][-1]
               - ranks[clipped]["outputs"]["loss"][-1]) > 1e-5


@pytest.mark.parametrize("n,name", CHECKED)
def test_clip_norm_is_the_logical_trees(setup, n, name):
    """The global norm the clip takes, summed over this rank's shards and
    reduced over the axes that shard them, is that of the whole gradient
    tree: on every rank it equals the norm of the gathered gradients at
    rtol 1e-5 and one device's within the gradients' bound (a replicated
    leaf counted once per member of an axis, or a shard's sum left out,
    moves it by a factor)."""
    one = _norm(setup[1][n][name])
    for rep in _ranks(setup, n, name):
        got = float(rep["outputs"]["grad_norm"])
        np.testing.assert_allclose(got, _norm(rep["outputs"]),
                                   rtol=dryrun.NORM_RTOL)
        np.testing.assert_allclose(got, one, rtol=ONE_DEVICE_NORM_RTOL)


@pytest.mark.parametrize("n,name", [(4, "fsdp"), (2, "fsdp"),
                                    (4, "cnn_fsdp")])
def test_fsdp_slices_the_parameters(setup, n, name):
    d = _case(n, name)["mesh"][1][0]
    for rep in _ranks(setup, n, name):
        info = rep["info"]
        assert info["data_sliced_params"] >= 8, info
        assert info["param_numel"] * d < info["tree_numel"] * 1.05
        assert rep["collectives"]["psum_scatter/gloo"] > 0


# ---------------------------------------------------------------------------
# against avd_tpu on its virtual mesh
# ---------------------------------------------------------------------------

def _jax_tree(key):
    cfg = dryrun.model_config(SPEC[key])
    tree = convert.load_checkpoint(SPEC[key]["weights"], cfg)
    return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)


def _jax_run(step, loss_fn, params, state, batches, shard):
    """3 jitted steps → (losses, first-step gradients, final params)."""
    f0, y0 = shard(batches[0])
    grads = jax.jit(jax.grad(loss_fn))(params, f0, y0)
    step = jax.jit(step)
    losses = []
    for b in batches:
        params, state, loss = step(params, state, *shard(b))
        losses.append(float(loss))
    return np.asarray(losses), jax.device_get(grads), jax.device_get(params)


def _flat(prefix, tree, cfg):
    port = convert.from_jax_params(
        jax.tree_util.tree_map(np.asarray, tree), cfg)
    return {f"{prefix}/{k}": v.numpy()
            for k, _, v in convert._flatten(port)}


JAX_FAMILIES = {"vit": jdet, "moe": jdet, "cnn": jcnn, "temporal": jtem}


@pytest.fixture(scope="module")
def jax_runs(setup):
    """avd_tpu's sharded steps on the 8-device mesh, from the same trees:
    each family's ``make_train_step(sharded=True)`` under (data 4, model
    2), and the ViT's ``make_pp_train_step``."""
    inputs = setup[0]
    out = {}
    opt = optax.adamw(TRAIN["lr"], weight_decay=1e-4)
    mesh = jmesh.make_mesh(8, axes=("data", "model"))
    bs = jmesh.batch_sharding(mesh)

    def shard(b):
        return tuple(jax.device_put(jnp.asarray(a), bs) for a in b)

    for key, fam in JAX_FAMILIES.items():
        cfg = fam.make_config(SPEC[key]["preset"])
        tcfg = dryrun.model_config(SPEC[key])
        batch = 4 if key == "temporal" else TRAIN["batch"]
        batches = dryrun.train_batches(inputs, SPEC, key, batch,
                                       TRAIN["steps"])
        # avd_tpu's sharded CNN step doubles the depthwise kernels'
        # gradient on a model axis of 2 (test below): its unsharded step
        # is the CNN's reference
        sharded = key != "cnn"
        params = _jax_tree(key)
        if sharded:
            params = jmesh.shard_params(mesh, params, fam.param_specs(cfg))
        with mesh:
            loss, g, p = _jax_run(
                fam.make_train_step(cfg, opt, sharded=sharded,
                                    logit_l2=TRAIN["logit_l2"]),
                lambda p, f, y: fam.loss_fn(p, f, y, cfg, sharded,
                                            TRAIN["logit_l2"]),
                params, opt.init(params), batches,
                shard if sharded else (lambda b: tuple(
                    jnp.asarray(a) for a in b)))
        out[key] = {"loss": loss, **_flat("g", g, tcfg),
                    **_flat("p", p, tcfg)}
    cfg = jdet.make_config("small")
    tcfg = dryrun.model_config(SPEC["vit"])
    batches = dryrun.train_batches(inputs, SPEC, "vit", TRAIN["batch"],
                                   TRAIN["steps"])
    for name, axes, shape, tp in (("pp", ("data", "stage"), (2, 2), False),
                                  ("pp_tp", DSM, (2, 2, 2), True)):
        pmesh = jmesh.make_mesh(int(np.prod(shape)), axes=axes, shape=shape)
        params = _jax_tree("vit")
        step = jdet.make_pp_train_step(cfg, opt, pmesh, n_micro=4, tp=tp)

        def pp_loss(p, f, y):
            logits = jdet.forward_pipelined(p, f, cfg, pmesh, 4, tp=tp)
            return jdet._bce(logits[:, 0], y)

        with pmesh:
            loss, g, p = _jax_run(step, pp_loss, params, opt.init(params),
                                  batches, lambda b: tuple(
                                      jnp.asarray(a) for a in b))
        out[name] = {"loss": loss, **_flat("g", g, tcfg),
                     **_flat("p", p, tcfg)}
    return out


@pytest.mark.parametrize("n,name,jax_name", [
    (4, "vit", "vit"), (2, "vit", "vit"), (4, "zero1", "vit"),
    (4, "fsdp", "vit"), (4, "moe", "moe"), (2, "moe", "moe"),
    (4, "cnn", "cnn"), (2, "cnn", "cnn"), (4, "cnn_zero1", "cnn"),
    (4, "cnn_fsdp", "cnn"), (4, "temporal", "temporal"),
    (2, "temporal", "temporal"), (4, "pp", "pp"), (2, "pp", "pp"),
    (4, "pp_tp", "pp_tp"), (2, "pp_tp", "pp_tp")])
def test_group_step_equals_avd_tpu(setup, jax_runs, n, name, jax_name):
    want = jax_runs[jax_name]
    one = setup[1][n][name]  # the port's single-device step
    for rep in _ranks(setup, n, name):
        got = rep["outputs"]
        np.testing.assert_allclose(got["loss"], want["loss"],
                                   atol=LOSS_ATOL, rtol=0)
        for prefix in ("g", "p"):
            rel = dryrun.leaf_rel_l2(got, want, prefix)
            bound = dict.fromkeys(rel, LEAF_REL)
            if jax_name == "cnn" and prefix == "g":
                # a leaf where the one-device port is already past the
                # bound: its own gap to avd_tpu, plus 0.1 %
                one_gap = dryrun.leaf_rel_l2(one, want, prefix)
                bound = {k: max(LEAF_REL, one_gap[k] + 1e-3) for k in rel}
            bad = {k: (v, bound[k]) for k, v in rel.items() if v > bound[k]}
            assert not bad, bad


def test_pipelined_loss_is_the_bce_alone(setup):
    """``make_pp_train_step``'s first loss is the BCE of one device's
    logits (no logit L2, as ``avd_tpu``'s pipelined loss): it equals the
    single-device reference, which the pipelined programs take without
    the regulariser."""
    got = _ranks(setup, 4, "pp")[0]["outputs"]["loss"][0]
    ref = setup[1][4]["pp"]["loss"][0]
    assert abs(got - ref) <= 1e-3
    assert abs(setup[1][4]["vit"]["loss"][0] - ref) > 1e-4


def test_optimizer_state_layout_is_unchanged():
    """``parallel/zero`` leaves ``optim.AdamW``'s state keys as they are
    (resume and the one-device path read them)."""
    opt = optim.AdamW(1e-3, accum=2)
    state = opt.init([torch.zeros(3)])
    assert sorted(state) == ["acc", "count", "mini_step", "mu", "nu"]


def test_avd_tpu_sharded_cnn_doubles_the_depthwise_gradient(setup):
    """Why the CNN is held to ``avd_tpu``'s unsharded step: under its
    (data 4, model 2) mesh ``avd_tpu``'s sharded CNN loss gives every
    depthwise kernel twice its gradient (the model axis's size) and the
    other leaves their own; the port's group gives one device's
    (``test_group_step_equals_one_device[*-cnn]``).  A fault of the
    reference, recorded in ROADMAP.md; this test shows whether it holds."""
    cfg = jcnn.make_config("small")
    params = _jax_tree("cnn")
    f, y = (jnp.asarray(a) for a in dryrun.train_batches(
        setup[0], SPEC, "cnn", TRAIN["batch"], 1)[0])
    one = jax.jit(jax.grad(lambda p: jcnn.loss_fn(p, f, y, cfg, False)))(
        params)
    mesh = jmesh.make_mesh(8, axes=("data", "model"))
    bs = jmesh.batch_sharding(mesh)
    sp = jmesh.shard_params(mesh, params, jcnn.param_specs(cfg))
    with mesh:
        two = jax.jit(jax.grad(lambda p: jcnn.loss_fn(
            p, jax.device_put(f, bs), jax.device_put(y, bs), cfg, True)))(sp)
    for si, st in enumerate(one["stages"]):
        for bi, blk in enumerate(st["blocks"]):
            a = np.asarray(blk["dw_w"])
            b = np.asarray(two["stages"][si]["blocks"][bi]["dw_w"])
            np.testing.assert_allclose(np.linalg.norm(b) / np.linalg.norm(a),
                                       2.0, rtol=2e-2)
            a = np.asarray(blk["exp_w"])
            b = np.asarray(two["stages"][si]["blocks"][bi]["exp_w"])
            assert np.linalg.norm(a - b) <= 3e-2 * np.linalg.norm(a)
