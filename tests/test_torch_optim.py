"""The port's optimizer, schedules and resolution transfer against
``avd_tpu``'s, on the CPU.

The optimizer alone, fed the same numpy gradients as ``avd_tpu``'s
``make_optimizer`` (optax): rtol 1e-6 over five steps at lr 1e-3
(measured: equal bit for bit but for the clip's global norm, whose sum
order differs: 1.1e-7; at lr 1.0 a parameter near zero misses by 16 ulps
of the update).  The schedules at every count against optax's, and
``interpolate_pos_emb`` within 1e-6 of ``jax.image.resize``'s bilinear,
growing and shrinking the grid.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avd_tpu.models import detector as jdetector
from avd_tpu_torch.models import convert, optim
from avd_tpu_torch.models import detector as tdetector

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# the optimizer against optax
# ---------------------------------------------------------------------------

_SHAPES = {"w": (8, 8), "b": (8,), "c": (3, 4, 5)}


@pytest.mark.parametrize("kw", [
    dict(lr=1e-3),
    dict(lr=1e-3, warmup=3),
    dict(lr=1e-3, steps=4, warmup=2, schedule="cosine"),
    dict(lr=1e-3, steps=3, schedule="cosine"),
    dict(lr=1e-3, grad_clip=0.5),
    dict(lr=1e-3, accum=2),
    dict(lr=1e-3, steps=3, warmup=1, schedule="cosine", grad_clip=1.0,
         accum=2),
], ids=["const", "warmup", "cosine", "cosine-horizon", "grad_clip",
        "accum2", "all"])
def test_optimizer_matches_optax(kw):
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in _SHAPES.items()}
    accum = kw.get("accum", 1)
    grads = [{k: rng.standard_normal(s).astype(np.float32)
              for k, s in _SHAPES.items()} for _ in range(5 * accum)]
    tx = jdetector.make_optimizer(**kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    opt = tdetector.make_optimizer(**kw)
    tp = [torch.from_numpy(p0[k].copy()) for k in _SHAPES]
    ts = opt.init(tp)
    for i, g in enumerate(grads):
        up, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, jp)
        jp = optax.apply_updates(jp, up)
        moved = opt.update(tp, [torch.from_numpy(g[k]) for k in _SHAPES], ts)
        assert moved == ((i + 1) % accum == 0)
        for k, t in zip(_SHAPES, tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-9)
    assert ts["count"] == len(grads) // accum


@pytest.mark.parametrize("lr,steps,warmup,schedule", [
    (3e-4, 50, 10, "cosine"), (1e-4, 40, 0, "cosine"), (2e-3, 0, 7, "const")])
def test_schedule_values_match_optax(lr, steps, warmup, schedule):
    """The schedules ``avd_tpu``'s make_optimizer builds, at every count
    up to past the horizon."""
    if schedule == "cosine":
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=warmup,
            decay_steps=steps, end_value=lr * 0.01)
    else:
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, lr, warmup),
             optax.constant_schedule(lr)], [warmup])
    got = optim.make_schedule(lr, steps, warmup, schedule)
    for c in range(0, 61):
        np.testing.assert_allclose(float(got(c)),
                                   float(want(jnp.int32(c))), rtol=1e-6,
                                   atol=1e-12)
    assert (float(got(0)) == 0.0) == (warmup > 0)


# ---------------------------------------------------------------------------
# resolution transfer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("src,dst", [(128, 224), (224, 128), (64, 224),
                                     (160, 48)])
def test_interpolate_pos_emb_matches_jax(src, dst):
    jc = jdetector.make_config("small", image_size=src, width=64, depth=1,
                               heads=2)
    jp = jax.tree_util.tree_map(
        np.asarray, jdetector.init_params(jax.random.PRNGKey(0), jc))
    tc = tdetector.make_config("small", image_size=src, width=64, depth=1,
                               heads=2)
    tp = convert.from_jax_params(jp, tc)
    want = np.asarray(jdetector.interpolate_pos_emb(
        jp, dataclasses.replace(jc, image_size=dst))["pos_emb"])
    got = tdetector.interpolate_pos_emb(
        tp, dataclasses.replace(tc, image_size=dst))
    assert got["pos_emb"].shape == want.shape
    np.testing.assert_allclose(got["pos_emb"].numpy(), want, atol=1e-6,
                               rtol=0)
    assert got["patch_w"] is tp["patch_w"]
    assert torch.equal(got["pos_emb"][0], tp["pos_emb"][0])
    assert tdetector.interpolate_pos_emb(tp, tc) is tp
