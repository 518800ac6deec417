"""The port's trainer over a rank group, its ZeRO plan and its sharded
restore (CPU, gloo).

* ``parallel/zero``'s ``zero_spec``, ``zero1_param_specs`` and
  ``fsdp_param_specs`` equal ``avd_tpu``'s spec for spec, on the cases of
  ``tests/test_zero.py:20-40`` and on the ``full``, ``small`` and
  ``cnn_small`` trees.
* ``detector.load_checkpoint_sharded`` on 4 ranks under the tensor-parallel,
  FSDP and pipeline layouts: each rank holds its slices alone, and the
  slices gathered back equal the saved tree (``tests/test_train.py:52-75``).
* ``train.train`` on 2 ranks (``--zero1``, ``--fsdp --accum 2``, ``--pp
  2``) and on 4 (``--pp 2 --pp-tp 2``), against the same runs on one
  device: the loss within 2e-2 at every step
  (``tests/test_zero.py:117, 192``, ``tests/test_train.py:78``).  A run
  saved on the group resumes on one device and on the group with the
  losses of an uninterrupted run, and the optimizer state the group saves
  is the one device's (the moments per leaf within 3e-2 in relative L2).
"""

import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from avd_tpu.models import cnn as jcnn
from avd_tpu.models import detector as jdet
from avd_tpu.parallel import zero as jzero
from avd_tpu_torch.models import cnn as tcnn
from avd_tpu_torch.models import convert
from avd_tpu_torch.models import detector as tdet
from avd_tpu_torch.models import train
from avd_tpu_torch.parallel import dryrun
from avd_tpu_torch.parallel import zero as tzero

torch.set_num_threads(2)

RANKS = "tests.torch_rank_programs:"
LOSS_ATOL = dryrun.LOSS_ATOL
# the trainer's runs: avd_tpu's ZeRO tests' sizes, a small pool
RUN = dict(batch=8, lr=1e-3, image_size=32, width=64, depth=2, heads=2,
           log_every=0, cache_samples=64, seed=1)


def _spec(s):
    return tuple(s)


# ---------------------------------------------------------------------------
# the ZeRO plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec,shape,data", [
    ((None, "model"), (64, 192), 4), ((), (16, 64), 4), ((), (64, 64), 4),
    ((), (3, 5), 4), (("model",), (8,), 4), (("data",), (8, 4), 2),
    ((None, None), (6, 4), 3)])
def test_zero_spec_equals_avd_tpu(spec, shape, data):
    assert tzero.zero_spec(spec, shape, data) == \
        _spec(jzero.zero_spec(JP(*spec), shape, data))


def _trees():
    out = {}
    for name, jmod, tmod, preset in (("full", jdet, tdet, "full"),
                                     ("small", jdet, tdet, "small"),
                                     ("moe_small", jdet, tdet, "moe_small"),
                                     ("cnn_small", jcnn, tcnn, "small")):
        jcfg, tcfg = jmod.make_config(preset), tmod.make_config(preset)
        shapes = jax.eval_shape(lambda k: jmod.init_params(k, jcfg),
                                jax.random.PRNGKey(0))
        out[name] = (shapes, jmod.param_specs(jcfg), tmod.param_shapes(tcfg),
                     tmod.param_specs(tcfg))
    return out


TREES = _trees()


@pytest.mark.parametrize("data", [2, 4, 3])
@pytest.mark.parametrize("tree", sorted(TREES))
def test_zero1_and_fsdp_specs_equal_avd_tpu(tree, data):
    jshapes, jspecs, tshapes, tspecs = TREES[tree]
    want1 = {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p):
             _spec(s) for p, s in
             jzero.zero1_param_specs(jshapes, jspecs, data).items()}
    got1 = tzero.zero1_param_specs(tshapes, tspecs, data)
    assert got1 == want1
    wantf = jzero.fsdp_param_specs(jshapes, jspecs, data)
    gotf = tzero.fsdp_param_specs(tshapes, tspecs, data)
    for path in got1:
        js = wantf
        for k in path:
            js = js[k]
        assert tzero._at(gotf, path) == _spec(js), path
    # the specs in leaves_of order are the parameters' (the step pairs
    # them by position)
    assert [p for p, _ in tzero._paths(tspecs)] == \
        [p for p, _ in tzero._paths(tshapes)]


# ---------------------------------------------------------------------------
# sharded restore
# ---------------------------------------------------------------------------

OVER = dict(image_size=32, width=128, depth=2, heads=4)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The 4-rank launch of this module: the sharded restore of a seeded
    checkpoint and the trainer with ``--pp 2 --pp-tp 2``."""
    work = tmp_path_factory.mktemp("four")
    cfg = tdet.make_config("small", **OVER)
    ckpt = str(work / "ckpt")
    convert.save_checkpoint(ckpt, tdet.init_params(3, cfg), cfg)
    ranks = dryrun.launch(4, "cpu", [
        {"name": "restore", "kind": RANKS + "restore", "weights": ckpt,
         "over": OVER, "dm": [2, 2], "ds": [2, 2], "dsm": [1, 2, 2]},
        _trainer("pp_tp", steps=3, pp_stages=2, pp_tp=2)],
        spec={}, timeout_s=600, workdir=str(work))
    return cfg, ckpt, [r["programs"] for r in ranks]


@pytest.fixture(scope="module")
def restored(four):
    cfg, ckpt, ranks = four
    saved = convert.load_checkpoint(ckpt, cfg)
    return cfg, {k: v.numpy() for k, _, v in convert._flatten(saved)}, \
        [r["restore"]["outputs"] for r in ranks]


@pytest.mark.parametrize("layout", ["tp", "fsdp", "pp", "pp_tp"])
def test_restore_gathers_back_to_the_saved_tree(restored, layout):
    _, saved, ranks = restored
    for out in ranks:
        for k, v in saved.items():
            np.testing.assert_array_equal(out[f"{layout}_whole/{k}"], v,
                                          err_msg=k)


@pytest.mark.parametrize("layout,frac", [("tp", 0.75), ("fsdp", 0.35),
                                         ("pp", 0.75), ("pp_tp", 0.5)])
def test_restore_puts_only_the_ranks_slices(restored, layout, frac):
    """Every rank holds less than ``frac`` of the tree (tp: the sharded
    matrices halved; fsdp: under a third; pp: half the layers), and the
    ranks' pieces differ."""
    _, saved, ranks = restored
    total = sum(v.size for v in saved.values())
    pieces = []
    for out in ranks:
        mine = {k: v for k, v in out.items() if k.startswith(layout + "/")}
        assert sum(v.size for v in mine.values()) < frac * total
        pieces.append(mine)
    key = next(k for k in pieces[0] if "qkv_w" in k)
    assert len({p[key].tobytes() for p in pieces}) > 1


def test_restored_tp_slices_are_the_shard_of_the_tree(restored):
    cfg, _, ranks = restored
    ref = tdet.init_params(3, cfg)
    cols = tdet._tp_shuffle_qkv(ref["layers"], cfg)[0]["qkv_w"].numpy()
    # rank (data 0, model 1) holds the second half of the head-major
    # columns
    got = ranks[1]["tp/layers.0.qkv_w"]
    np.testing.assert_array_equal(got, cols[:, cols.shape[1] // 2:])


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

def _trainer(name, **kw):
    return {"name": name, "kind": RANKS + "trainer", "kw": dict(RUN, **kw)}


@pytest.fixture(scope="module")
def group(tmp_path_factory, four):
    work = tmp_path_factory.mktemp("trainer")
    saved = str(work / "saved")
    two = dryrun.launch(2, "cpu", [
        _trainer("zero1", steps=3, zero1=True),
        _trainer("fsdp_accum", steps=4, fsdp=True, accum=2),
        _trainer("pp", steps=3, pp_stages=2),
        _trainer("save", steps=2, zero1=True, out=saved),
        dict(_trainer("resume", steps=4, zero1=True, resume=True,
                      out=str(work / "resumed")), copy_from=saved),
    ], spec={}, timeout_s=600, workdir=str(work))
    return {"two": [r["programs"] for r in two], "four": four[2],
            "work": work}


def _one_device(**kw):
    return train.train(device="cpu", **dict(RUN, **kw))


@pytest.mark.parametrize("world,name,kw", [
    ("two", "zero1", dict(steps=3)),
    ("two", "fsdp_accum", dict(steps=4, accum=2)),
    ("two", "pp", dict(steps=3)),
    ("four", "pp_tp", dict(steps=3))])
def test_trainer_on_a_group_equals_one_device(group, world, name, kw):
    _, want = _one_device(**kw)
    for prog in group[world]:
        got = prog[name]["outputs"]["loss"]
        assert got.shape == (kw["steps"],) and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)


def test_group_save_resumes_on_one_device(group, tmp_path):
    """The state saved at step 2 on the group → 2 more steps on one
    device: the losses of an uninterrupted one-device run of 4 steps."""
    saved = str(group["work"] / "saved")
    copy = str(tmp_path / "resumed")
    shutil.copytree(saved, copy)
    shutil.copy(saved + ".train", copy + ".train")
    _, straight = _one_device(steps=4)
    _, resumed = _one_device(steps=4, out=copy, resume=True)
    np.testing.assert_allclose(resumed, straight[2:], atol=LOSS_ATOL, rtol=0)


def test_group_save_resumes_on_the_group(group):
    _, straight = _one_device(steps=4)
    for prog in group["two"]:
        np.testing.assert_allclose(prog["save"]["outputs"]["loss"],
                                   straight[:2], atol=LOSS_ATOL, rtol=0)
        np.testing.assert_allclose(prog["resume"]["outputs"]["loss"],
                                   straight[2:], atol=LOSS_ATOL, rtol=0)


def test_group_saves_the_one_device_state(group, tmp_path):
    """The train state a group writes is a one-device state: the whole
    tree's moments (gathered from the ZeRO slices), close to those one
    device reaches on the same steps, and ``train_meta.json`` records
    ``zero1``."""
    saved = str(group["work"] / "saved")
    state = torch.load(saved + ".train", weights_only=True)
    out = str(tmp_path / "one")
    _one_device(steps=2, out=out)
    ref = torch.load(out + ".train", weights_only=True)
    assert state["step"] == ref["step"] == 2
    assert state["opt_state"]["count"] == ref["opt_state"]["count"] == 2
    for key in ("mu", "nu"):
        assert len(state["opt_state"][key]) == len(ref["opt_state"][key])
        for a, b in zip(state["opt_state"][key], ref["opt_state"][key]):
            assert a.shape == b.shape
            err = float(torch.linalg.norm(a - b))
            assert err <= 3e-2 * float(torch.linalg.norm(b)) + 1e-12
    with open(os.path.join(saved, "train_meta.json")) as f:
        meta = json.load(f)
    assert meta["zero1"] is True and meta["world"] == 2


# ---------------------------------------------------------------------------
# one-process refusals
# ---------------------------------------------------------------------------

def test_pipelined_step_refuses_moe():
    """The pipelined loss collects no MoE loss; ``avd_tpu`` would train an
    MoE stack without it, the port raises (a departure, ROADMAP.md)."""
    cfg = tdet.make_config("moe_small")
    with pytest.raises(ValueError, match="dense configs only"):
        tdet.make_pp_train_step(cfg, tdet.make_optimizer(), None)


def test_zero_mode_needs_a_sharded_step():
    cfg = tdet.make_config("small")
    with pytest.raises(ValueError, match="needs sharded=True"):
        tdet.make_train_step(cfg, tdet.make_optimizer(), zero_mode="zero1")


def test_data_parallel_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="unknown data-parallel mode"):
        tzero.DataParallel(None, None, [], mode="zero2")
