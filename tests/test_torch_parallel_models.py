"""Sharded detector forwards of the port on rank groups (CPU, gloo) against
``avd_tpu``.

The same seeded JAX trees, converted (``models/convert.py``), go through
``avd_tpu`` here (single device, and its sharded programs on the suite's
8-device virtual mesh) and through the port on 2 and 4 spawned ranks
(``parallel.dryrun.launch``; the ranks import neither ``jax`` nor
``avd_tpu``).  Held at ``avd_tpu``'s bf16 logit tolerance, atol 2e-2:

* the tensor-parallel ViT (``forward(..., sharded=True)``) and with
  sequence parallelism (``seq_sharded``; 5 tokens over 2 ranks pads)
  (``tests/test_parallel.py:66-114``);
* the expert-parallel MoE, routes equal to one device's
  (``tests/test_moe.py:129-162``);
* the sharded CNN (``tests/test_cnn.py:50-73``);
* the temporal family time-sharded, ring and Ulysses
  (``tests/test_temporal.py:94-120``);
* GPipe: pp, dp × pp, n_micro > S, MoE stages, pp × tp, dp × pp × tp, and
  the shape errors (``tests/test_pipeline_parallel.py``).

And, in this process: every family's and preset's ``param_specs`` equal
``avd_tpu``'s leaf by leaf, and the shards of converted ``avd_tpu``
weights concatenate back to the unsharded tree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avd_tpu.models import cnn as jcnn
from avd_tpu.models import detector as jdet
from avd_tpu.models import temporal as jtem
from avd_tpu.parallel import mesh as jmesh
from avd_tpu_torch.models import cnn as tcnn
from avd_tpu_torch.models import convert
from avd_tpu_torch.models import detector as tdet
from avd_tpu_torch.models import temporal as ttem
from avd_tpu_torch.parallel import dryrun
from avd_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

ATOL = 2e-2
RANKS = "tests.torch_rank_programs:"

# spec key → (JAX family module, JAX config, PRNG seed, port preset + over)
_VIT = dict(image_size=32, patch=16, width=256, heads=4)
MODELS = {
    "vit2": (jdet, jdet.ViTConfig(depth=2, **_VIT), 0, "vit",
             dict(depth=2, **_VIT)),
    "vit4": (jdet, jdet.ViTConfig(depth=4, **_VIT), 0, "vit",
             dict(depth=4, **_VIT)),
    "moe": (jdet, jdet.ViTConfig(depth=2, n_experts=4, **_VIT), 1, "vit",
            dict(depth=2, n_experts=4, **_VIT)),
    "moe4": (jdet, jdet.ViTConfig(depth=4, n_experts=4, **_VIT), 5, "vit",
             dict(depth=4, n_experts=4, **_VIT)),
    "cnn": (jcnn, jcnn.make_config("small", image_size=32, widths=(32, 64),
                                   depths=(1, 1)), 0, "cnn",
            dict(image_size=32, widths=(32, 64), depths=(1, 1))),
    "temporal": (jtem, jtem.TemporalConfig(image_size=32, patch=16,
                                           width=128, depth=2, heads=4),
                 0, "temporal", dict(image_size=32, width=128, depth=2,
                                     heads=4)),
}
N_FRAMES, T = 16, 16


def _case(name, kind, model, axes, shape, **opts):
    return {"name": name, "kind": kind, "model": model,
            "mesh": [list(axes), list(shape)], **opts}


CASES = {
    4: [_case("vit_tp", "vit_sharded", "vit2", ("data", "model"), (2, 2),
              batch=4),
        _case("vit_seq", "vit_sharded", "vit2", ("data", "model"), (2, 2),
              batch=4, seq=True),
        _case("moe_ep", "vit_sharded", "moe", ("data", "model"), (1, 4),
              batch=4),
        _case("moe_dm", "vit_sharded", "moe", ("data", "model"), (2, 2),
              batch=4),
        _case("cnn_tp", "cnn_sharded", "cnn", ("data", "model"), (2, 2),
              batch=8),
        _case("ring", "temporal", "temporal", ("time",), (4,), impl="ring"),
        _case("ulysses", "temporal", "temporal", ("time",), (4,),
              impl="ulysses"),
        _case("pp", "gpipe", "vit4", ("stage",), (4,), batch=8, n_micro=4),
        _case("dp_pp", "gpipe", "vit4", ("data", "stage"), (2, 2), batch=8,
              n_micro=4),
        _case("pp_moe", "gpipe", "moe4", ("stage",), (4,), batch=8,
              n_micro=4),
        _case("pp_tp", "gpipe", "vit2", ("stage", "model"), (2, 2), batch=4,
              n_micro=2, tp=True),
        _case("dp_pp_tp", "gpipe", "vit4", ("data", "stage", "model"),
              (1, 2, 2), batch=8, n_micro=4, tp=True),
        {"name": "errors", "kind": RANKS + "errors"}],
    2: [_case("vit_tp", "vit_sharded", "vit2", ("data", "model"), (1, 2),
              batch=4),
        _case("vit_seq", "vit_sharded", "vit2", ("data", "model"), (1, 2),
              batch=4, seq=True),
        _case("moe_ep", "vit_sharded", "moe", ("data", "model"), (1, 2),
              batch=4),
        _case("cnn_tp", "cnn_sharded", "cnn", ("data", "model"), (1, 2),
              batch=8),
        _case("ring", "temporal", "temporal", ("time",), (2,), impl="ring"),
        _case("ulysses", "temporal", "temporal", ("time",), (2,),
              impl="ulysses"),
        _case("pp_micro8", "gpipe", "vit4", ("stage",), (2,), batch=8,
              n_micro=8),
        _case("dp_pp_tp", "gpipe", "vit4", ("data", "stage", "model"),
              (1, 1, 2), batch=8, n_micro=4, tp=True),
        {"name": "errors", "kind": RANKS + "errors"}],
}


def _jax_params(key):
    fam, cfg, seed = MODELS[key][:3]
    return jax.device_get(fam.init_params(jax.random.PRNGKey(seed), cfg))


def _port_cfg(key):
    family, preset_over = MODELS[key][3], MODELS[key][4]
    mod = {"vit": tdet, "cnn": tcnn, "temporal": ttem}[family]
    return mod.make_config("small", **preset_over)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(frames f32 [16,32,32,3], JAX trees, spec, launches by world)."""
    work = tmp_path_factory.mktemp("models")
    bgr = np.random.default_rng(0).integers(
        0, 256, (N_FRAMES, 32, 32, 3)).astype(np.uint8)
    spec = {"pp_batch": 8, "n_micro": 4, "temporal_t": T}
    jparams = {}
    for key, (_, _, _, family, over) in MODELS.items():
        jparams[key] = _jax_params(key)
        cfg = _port_cfg(key)
        ckpt = str(work / key)
        convert.save_checkpoint(ckpt, convert.from_jax_params(
            jparams[key], cfg), cfg)
        spec[key] = {"family": family, "preset": "small",
                     "over": {k: list(v) if isinstance(v, tuple) else v
                              for k, v in over.items()},
                     "weights": ckpt}
    launches = {n: dryrun.launch(n, "cpu", CASES[n], inputs={"bgr32": bgr},
                                 spec=spec, timeout_s=300,
                                 workdir=str(work))
                for n in (4, 2)}
    return dryrun.rgb(bgr), jparams, spec, launches


def _jax_single(key, params, frames):
    fam, cfg = MODELS[key][:2]
    if fam is jtem:
        return np.asarray(jax.jit(lambda p, f: jtem.forward(p, f, cfg))(
            params, jnp.asarray(frames[None])))
    return np.asarray(jax.jit(lambda p, f: fam.forward(p, f, cfg))(
        params, jnp.asarray(frames)))


def _jax_sharded(key, params, frames, **kw):
    """avd_tpu's GSPMD forward on its (data 4, model 2) virtual mesh."""
    fam, cfg = MODELS[key][:2]
    mesh = jmesh.make_mesh(8, axes=("data", "model"))
    sp = jmesh.shard_params(mesh, params, fam.param_specs(cfg))
    fb = jax.device_put(jnp.asarray(frames), jmesh.batch_sharding(mesh))
    with mesh:
        return np.asarray(jax.jit(lambda p, f: fam.forward(
            p, f, cfg, sharded=True, **kw))(sp, fb))


def _jax_time_sharded(key, params, frames, impl):
    cfg = MODELS[key][1]
    mesh = jmesh.make_mesh(4, axes=("time",))
    with mesh:
        return np.asarray(jax.jit(lambda p, f: jtem.forward_time_sharded(
            p, f, cfg, mesh, impl=impl))(params, jnp.asarray(frames[None])))


def _ranks(setup, n, name):
    return [r["programs"][name] for r in setup[3][n]]


def _batch(case):
    return case.get("batch") or T


@pytest.mark.parametrize("n,name", [(4, "vit_tp"), (2, "vit_tp"),
                                    (4, "vit_seq"), (2, "vit_seq")])
def test_tensor_parallel_vit(setup, n, name):
    frames, jparams = setup[0][:4], setup[1]
    single = _jax_single("vit2", jparams["vit2"], frames)
    sharded = _jax_sharded("vit2", jparams["vit2"], frames,
                           seq_sharded=name == "vit_seq")
    for rep in _ranks(setup, n, name):
        got = rep["outputs"]["logits"]
        np.testing.assert_allclose(got, single, atol=ATOL)
        np.testing.assert_allclose(got, sharded, atol=ATOL)
        kinds = rep["collectives"]
        if name == "vit_seq":  # reduce-scatter out, all-gather in
            assert kinds["psum_scatter/gloo"] == 2 * 2
            assert "psum/gloo" not in kinds
        else:
            assert kinds["psum/gloo"] == 2 * 2
        assert rep["collectives"]["staged"] == 0


@pytest.mark.parametrize("n,name", [(4, "moe_ep"), (4, "moe_dm"),
                                    (2, "moe_ep")])
def test_expert_parallel_moe(setup, n, name):
    frames, jparams = setup[0][:4], setup[1]
    cfg = MODELS["moe"][1]
    single = _jax_single("moe", jparams["moe"], frames)
    sharded = _jax_sharded("moe", jparams["moe"], frames)
    rx = jdet._router_features(jparams["moe"], jnp.asarray(frames), cfg)
    routes = np.stack([np.asarray(jnp.argmax(jnp.round(
        (rx @ lp["router_w"]) * jdet._ROUTER_GRID), axis=-1))
        for lp in jparams["moe"]["layers"]])
    for rep in _ranks(setup, n, name):
        np.testing.assert_array_equal(rep["outputs"]["routes"], routes)
        np.testing.assert_allclose(rep["outputs"]["logits"], single,
                                   atol=ATOL)
        np.testing.assert_allclose(rep["outputs"]["logits"], sharded,
                                   atol=ATOL)


@pytest.mark.parametrize("n", [4, 2])
def test_sharded_cnn(setup, n):
    frames, jparams = setup[0][:8], setup[1]
    single = _jax_single("cnn", jparams["cnn"], frames)
    sharded = _jax_sharded("cnn", jparams["cnn"], frames)
    for rep in _ranks(setup, n, "cnn_tp"):
        np.testing.assert_allclose(rep["outputs"]["logits"], single,
                                   atol=ATOL)
        np.testing.assert_allclose(rep["outputs"]["logits"], sharded,
                                   atol=ATOL)
        assert rep["collectives"]["psum/gloo"] == 2  # one a block


@pytest.mark.parametrize("n", [4, 2])
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_time_sharded_temporal(setup, n, impl):
    frames, jparams = setup[0][:T], setup[1]
    single = _jax_single("temporal", jparams["temporal"], frames)
    sharded = _jax_time_sharded("temporal", jparams["temporal"], frames,
                                impl)
    for rep in _ranks(setup, n, impl):
        got = rep["outputs"]["logits"]
        assert got.shape == (1, T, 1)
        np.testing.assert_allclose(got, single, atol=ATOL)
        np.testing.assert_allclose(got, sharded, atol=ATOL)


PIPELINES = [(4, "pp", "vit4"), (4, "dp_pp", "vit4"),
             (2, "pp_micro8", "vit4"), (4, "pp_moe", "moe4"),
             (4, "pp_tp", "vit2"), (4, "dp_pp_tp", "vit4"),
             (2, "dp_pp_tp", "vit4")]


@pytest.mark.parametrize("n,name,key", PIPELINES)
def test_gpipe_forwards(setup, n, name, key):
    case = next(c for c in CASES[n] if c["name"] == name)
    frames, jparams = setup[0][:case["batch"]], setup[1]
    single = _jax_single(key, jparams[key], frames)
    stages = dict(zip(*case["mesh"]))["stage"]
    for rep in _ranks(setup, n, name):
        np.testing.assert_allclose(rep["outputs"]["logits"], single,
                                   atol=ATOL)
        # one hand-off a tick but the last, one psum a buffer leaf
        ticks = case["n_micro"] + stages - 1
        leaves = 2 if key.startswith("moe") else 1
        if stages > 1:
            assert rep["collectives"]["ppermute/gloo"] == \
                leaves * (ticks - 1)


@pytest.mark.parametrize("n", [4, 2])
def test_sharded_shape_errors(setup, n):
    msgs = _ranks(setup, n, "errors")[0]["info"]
    assert f"T {2 * n + 1} not divisible by time axis {n}" == \
        msgs["time_not_divisible"]
    assert "heads 3 not divisible" in msgs["ulysses_heads"]
    assert "unknown impl" in msgs["unknown_impl"]
    assert f"depth {n + 1} not divisible by {n} stages" == msgs["depth"]
    assert "batch 6 not divisible by 4 microbatches" == msgs["batch"]
    assert "needs a 'model' mesh axis" in msgs["tp_needs_model"]
    assert "not divisible by model axis" in msgs["tp_heads"]
    assert f"microbatch 1 not divisible by data axis {n}" == \
        msgs["microbatch"]
    assert f"batch {n + 1} not divisible by data axis {n}" == \
        msgs["sharded_batch"]
    assert "'data' and 'model'" in msgs["sharded_mesh"]


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_tuples(v) for v in tree]
    return tuple(tree)


@pytest.mark.parametrize("family,preset", [
    ("vit", p) for p in sorted(jdet.PRESETS)] + [
    ("cnn", p) for p in sorted(jcnn.PRESETS)] + [
    ("temporal", p) for p in sorted(jtem.PRESETS)])
def test_param_specs_equal_avd_tpu(family, preset):
    jmod, tmod = {"vit": (jdet, tdet), "cnn": (jcnn, tcnn),
                  "temporal": (jtem, ttem)}[family]
    want = _as_tuples(jmod.param_specs(jmod.make_config(preset)))
    assert tmod.param_specs(tmod.make_config(preset)) == want


@pytest.mark.parametrize("key,mesh", [("vit2", {"data": 2, "model": 2}),
                                      ("moe", {"data": 1, "model": 4}),
                                      ("cnn", {"data": 2, "model": 2})])
def test_shards_of_converted_weights_concatenate_back(key, mesh):
    """Every rank's slices (``mesh.local_slice`` at each coordinate), put
    side by side along the dims the spec names, give back the converted
    ``avd_tpu`` tree."""
    cfg = _port_cfg(key)
    tree = convert.from_jax_params(_jax_params(key), cfg)
    tmod = {"vit": tdet, "cnn": tcnn}[MODELS[key][3]]
    specs = tmod.param_specs(cfg)
    coords = [dict(zip(mesh, c)) for c in np.ndindex(*mesh.values())]

    def check(leaf, spec):
        blocks = {tuple(c.values()): tmesh.local_slice(leaf, spec, c.get,
                                                       mesh.get)
                  for c in coords}
        # rebuild along each named dim, innermost axis first
        out = blocks
        for i, axis in reversed(list(enumerate(mesh))):
            dim = list(spec).index(axis) if axis in spec else None
            grouped = {}
            for c, b in out.items():
                grouped.setdefault(c[:i], []).append(b)
            out = {c: (torch.cat(bs, dim) if dim is not None else bs[0])
                   for c, bs in grouped.items()}
            if dim is None:
                assert all(torch.equal(b, bs[0]) for bs in
                           grouped.values() for b in bs)
        assert torch.equal(out[()], leaf)

    def walk(t, s):
        if isinstance(t, dict):
            for k in t:
                walk(t[k], s[k])
        elif isinstance(t, list):
            for a, b in zip(t, s):
                walk(a, b)
        else:
            check(t, s)

    walk(tree, specs)
