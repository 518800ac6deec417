"""The port's training driver against ``avd_tpu``'s step, loss by loss.

From one tree (``avd_tpu``'s initialiser, converted) the port's
``train()`` runs K steps on the CPU, entered through ``--resume`` at step 0
so that both sides start from the same parameters.  Beside it the test
runs ``avd_tpu``'s single-device loop: ``jax.jit`` of the family's
``make_train_step(cfg, make_optimizer(...), sharded=False)`` on the
batches that the per-step draw ``(seed, 1_000_003 + step)`` takes from the
pool that ``avd_tpu``'s ``synthetic_batch`` / ``synthetic_sequences``
make, with the cosine horizon in optimizer steps and the EMA decayed once
per applied update, as ``avd_tpu/models/train.py`` does.  (Its ``train()``
itself is not run: on the test suite's 8-device CPU mesh it shards.)

This holds the driver's composition to the reference: the pool and its
gather, the index draws, ``horizon // accum``, the schedule, the clip,
``logit_l2``, the MoE and per-frame auxiliary terms and the EMA's timing.
Each step's loss is held within 2e-2 of the reference's, the bound of the
single-step loss test (measured at most 0.0073, the MoE).  The rate is
1e-4, so that Adam's sign amplification of near-zero gradients (an element
moves by about ±lr whatever its gradient) keeps the two parameter trees
close.  The EMA tree at the end is held within 0.1 of the reference EMA's
distance from the start, in L2: measured 0.030, where decaying it on every
mini-step of the accumulation instead gives 0.287.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avd_tpu import models as jmodels
from avd_tpu.models import temporal as jtemporal
from avd_tpu.models import train as jtrain
from avd_tpu_torch.models import convert, optim
from avd_tpu_torch.models import train as ttrain

torch.set_num_threads(2)

RUN = dict(steps=6, batch=8, lr=1e-4, image_size=32, width=64, depth=2,
           heads=2, seed=3, cache_samples=32, seq_len=4, experts=0,
           families=jtrain.TRAIN_FAMILIES, logit_l2=0.0, warmup=0,
           schedule="const", schedule_horizon=0, grad_clip=0.0, accum=1,
           ema=0.0)

CASES = {
    "vit": dict(arch="vit", logit_l2=0.02),
    "moe": dict(arch="vit", experts=4),
    "cnn": dict(arch="cnn", logit_l2=0.02),
    "temporal": dict(arch="temporal", batch=4),
    "vit-accum-cosine": dict(arch="vit", steps=8, accum=2, warmup=2,
                             schedule="cosine", schedule_horizon=12,
                             grad_clip=1.0, ema=0.9),
}


def _jax_config(arch, r):
    """``avd_tpu``'s config of a run, as its ``train()`` builds it."""
    fam = jmodels.family(arch)
    if arch == "cnn":
        return fam.make_config("small", image_size=r["image_size"])
    if arch == "temporal":
        return fam.make_config("small", image_size=r["image_size"],
                               width=r["width"], depth=r["depth"],
                               heads=r["heads"])
    return fam.make_config("full", image_size=r["image_size"], patch=16,
                           width=r["width"], depth=r["depth"],
                           heads=r["heads"], n_experts=r["experts"])


def _pool(arch, r):
    rng = np.random.default_rng(r["seed"])
    if arch == "temporal":
        return jtemporal.synthetic_sequences(
            rng, max(r["batch"], r["cache_samples"] // r["seq_len"]),
            r["seq_len"], r["image_size"], r["families"])
    pf, pl = [], []
    for _ in range(-(-r["cache_samples"] // r["batch"])):
        f, lab = jtrain.synthetic_batch(rng, r["batch"], r["image_size"],
                                        r["families"])
        pf.append(f)
        pl.append(lab)
    return np.concatenate(pf), np.concatenate(pl)


def _reference(arch, jcfg, tree, r):
    """(per-step losses, EMA tree or None) of ``avd_tpu``'s loop."""
    fam = jmodels.family(arch)
    accum = max(1, r["accum"])
    optimizer = fam.make_optimizer(
        r["lr"], steps=max(1, (r["schedule_horizon"] or r["steps"]) // accum),
        warmup=r["warmup"], schedule=r["schedule"],
        grad_clip=r["grad_clip"], accum=accum)
    params = jax.tree_util.tree_map(jnp.asarray, tree)
    opt_state = optimizer.init(params)
    step_fn = jax.jit(fam.make_train_step(jcfg, optimizer, sharded=False,
                                          logit_l2=r["logit_l2"]))
    d = r["ema"]
    ema = params if d else None
    ema_fn = jax.jit(lambda e, p: jax.tree_util.tree_map(
        lambda a, b: d * a + (1.0 - d) * b, e, p))
    frames, labels = _pool(arch, r)
    losses = []
    for step in range(r["steps"]):
        idx = np.random.default_rng((r["seed"], 1_000_003 + step)).integers(
            0, frames.shape[0], r["batch"])
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(frames[idx]),
                                          jnp.asarray(labels[idx]))
        if ema is not None and (step + 1) % accum == 0:
            ema = ema_fn(ema, params)
        losses.append(float(loss))
    return losses, ema


def _port(arch, tcfg, tree, r, out):
    """(per-step losses, EMA tree or None) of the port's ``train()``,
    resumed at step 0 from ``tree``."""
    tp = convert.from_jax_params(tree, tcfg)
    convert.save_checkpoint(out, tp, tcfg)
    state = optim.AdamW(r["lr"], accum=r["accum"]).init(optim.leaves_of(tp))
    torch.save({"step": 0, "opt_state": state, "params": tp},
               f"{out}.train")
    kw = {k: v for k, v in r.items() if k != "arch"}
    _, losses = ttrain.train(arch=arch, out=out, resume=True, log_every=0,
                             device="cpu", **kw)
    saved = torch.load(f"{out}.train", weights_only=True)
    return losses, saved.get("ema")


@pytest.mark.parametrize("name", sorted(CASES))
def test_driver_loss_trajectory_matches_avd_tpu(name, tmp_path):
    r = dict(RUN, **CASES[name])
    arch = r["arch"]
    jcfg = _jax_config(arch, r)
    _, tcfg = ttrain._config(arch, r["image_size"], r["width"], r["depth"],
                             r["heads"], r["experts"], False)
    tree = jax.tree_util.tree_map(
        np.asarray, jmodels.family(arch).init_params(jax.random.PRNGKey(1),
                                                     jcfg))
    ref, ref_ema = _reference(arch, jcfg, tree, r)
    ours, our_ema = _port(arch, tcfg, tree, r, str(tmp_path / "ckpt"))
    assert len(ours) == len(ref) == r["steps"]
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-2)
    if r["ema"]:
        start = convert.from_jax_params(tree, tcfg)
        want = convert.from_jax_params(
            jax.tree_util.tree_map(np.asarray, ref_ema), tcfg)
        got, want, start = (torch.cat([x.flatten() for x in
                                       optim.leaves_of(t)])
                            for t in (our_ema, want, start))
        moved = float(torch.linalg.norm(want - start))
        err = float(torch.linalg.norm(got - want))
        assert moved > 0 and err <= 0.1 * moved, (err, moved)
