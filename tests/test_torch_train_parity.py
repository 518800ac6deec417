"""The port's training arithmetic against ``avd_tpu``'s, on the CPU.

Adam moves an element by about ±lr whatever its gradient's size, so a
bf16-level difference in a near-zero gradient can flip a step's sign:
parameters after a step differ between any two implementations.  The
training half is therefore held in three separate parts:

* the loss and each leaf's gradient against ``jax.value_and_grad`` of
  ``avd_tpu``'s ``loss_fn`` (jitted, unsharded) on the same tree and batch:
  loss within 2e-2, each leaf's gradient within relative L2 3e-2 (measured
  at most 0.0098 and 0.0203, the CNN's first-stage leaves);
* the optimizer alone (``tests/test_torch_optim.py``);
* the driver's per-step losses against ``avd_tpu``'s jitted step on the
  same pool and index draws (``tests/test_torch_train_trajectory.py``).

The synthetic data they all train on is held equal bit for bit here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avd_tpu import models as jmodels
from avd_tpu.models import detector as jdetector
from avd_tpu.models import temporal as jtemporal
from avd_tpu.models import train as jtrain
from avd_tpu_torch import models as tmodels
from avd_tpu_torch.models import convert, optim
from avd_tpu_torch.models import detector as tdetector
from avd_tpu_torch.models import temporal as ttemporal
from avd_tpu_torch.models import train as ttrain

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# synthetic data: the same numpy draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", sorted(jtrain.GENERATOR_FAMILIES))
@pytest.mark.parametrize("ai_like", [False, True])
def test_generator_equals_avd_tpu(family, ai_like):
    for seed, size in ((0, 32), (7, 48)):
        ours = ttrain.GENERATOR_FAMILIES[family](
            np.random.default_rng(seed), size, ai_like)
        ref = jtrain.GENERATOR_FAMILIES[family](
            np.random.default_rng(seed), size, ai_like)
        np.testing.assert_array_equal(ours, ref)


def test_curriculum_constants():
    assert sorted(ttrain.GENERATOR_FAMILIES) == \
        sorted(jtrain.GENERATOR_FAMILIES)
    assert ttrain.TRAIN_FAMILIES == jtrain.TRAIN_FAMILIES
    assert ttrain.HELDOUT_FAMILY == jtrain.HELDOUT_FAMILY
    assert ttrain._VIDEO_EXTS == jtrain._VIDEO_EXTS


@pytest.mark.parametrize("families", [("blobs",), jtrain.TRAIN_FAMILIES,
                                      ("texture", "waves")])
def test_synthetic_batch_equals_avd_tpu(families):
    ours = ttrain.synthetic_batch(np.random.default_rng(3), 12, 32, families)
    ref = jtrain.synthetic_batch(np.random.default_rng(3), 12, 32, families)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_synthetic_sequences_equal_avd_tpu():
    ours = ttemporal.synthetic_sequences(np.random.default_rng(5), 6, 5, 32,
                                         jtrain.TRAIN_FAMILIES)
    ref = jtemporal.synthetic_sequences(np.random.default_rng(5), 6, 5, 32,
                                        jtrain.TRAIN_FAMILIES)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_acc_auc_equals_avd_tpu():
    rng = np.random.default_rng(0)
    p, y = rng.random(200), rng.integers(0, 2, 200)
    assert ttrain._acc_auc(p, y) == jtrain._acc_auc(p, y)


# ---------------------------------------------------------------------------
# loss and gradients against jax.value_and_grad
# ---------------------------------------------------------------------------

_FAMILIES = {
    "vit": ("vit", "full", dict(image_size=32, patch=16, width=64, depth=2,
                                heads=2), (4, 32, 32, 3), (4,)),
    "moe": ("vit", "full", dict(image_size=32, patch=16, width=64, depth=2,
                                heads=2, n_experts=4), (4, 32, 32, 3), (4,)),
    "cnn": ("cnn", "small", dict(image_size=32), (4, 32, 32, 3), (4,)),
    "temporal": ("temporal", "small", dict(image_size=32, width=64, depth=2,
                                           frame_depth=2, heads=2),
                 (2, 4, 32, 32, 3), (2, 4)),
}


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        elif isinstance(v, list):
            for i, x in enumerate(v):
                yield from _flat(x, f"{prefix}{k}.{i}.")
        else:
            yield f"{prefix}{k}", v


def _pair(name):
    """(jax family, cfg, numpy tree; port family, cfg, tree; x, y)."""
    arch, preset, over, xs, ys = _FAMILIES[name]
    jf, tf = jmodels.family(arch), tmodels.family(arch)
    jc, tc = jf.make_config(preset, **over), tf.make_config(preset, **over)
    jp = jax.tree_util.tree_map(
        np.asarray, jf.init_params(jax.random.PRNGKey(1), jc))
    tp = convert.from_jax_params(jp, tc)
    rng = np.random.default_rng(0)
    x = rng.random(xs, np.float32)
    y = rng.integers(0, 2, ys).astype(np.int32)
    return jf, jc, jp, tf, tc, tp, x, y


def _port_loss_and_grads(tf, tc, tp, x, y, logit_l2):
    leaves = optim.leaves_of(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tf.loss_fn(tp, torch.from_numpy(x), torch.from_numpy(y), tc,
                      logit_l2=logit_l2)
    return loss.detach(), torch.autograd.grad(loss, leaves,
                                             materialize_grads=True)


@pytest.mark.parametrize("name", sorted(_FAMILIES))
@pytest.mark.parametrize("logit_l2", [0.0, 0.5])
def test_loss_and_gradients_match_jax(name, logit_l2):
    jf, jc, jp, tf, tc, tp, x, y = _pair(name)
    lj, gj = jax.jit(jax.value_and_grad(jf.loss_fn),
                     static_argnums=(3, 4, 5))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
        jnp.asarray(y), jc, False, logit_l2)
    lt, gt = _port_loss_and_grads(tf, tc, tp, x, y, logit_l2)
    assert abs(float(lt) - float(lj)) <= 2e-2, (float(lt), float(lj))
    ref = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, gj),
                                  tc)
    named = list(_flat(ref))
    assert len(named) == len(gt)
    for (leaf, want), got in zip(named, gt):
        assert torch.isfinite(got).all(), leaf
        err = float(torch.linalg.norm(got - want))
        scale = float(torch.linalg.norm(want))
        assert err <= 3e-2 * scale + 1e-12, (leaf, err / max(scale, 1e-30))


def test_moe_aux_loss_matches_jax():
    """The Switch load-balancing term alone: forward(with_aux) against
    ``avd_tpu``'s (f32 router, identical routes)."""
    jf, jc, jp, tf, tc, tp, x, _ = _pair("moe")
    _, aux_j = jax.jit(lambda p, f: jdetector.forward(p, f, jc,
                                                      with_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x))
    _, aux_t = tdetector.forward(tp, torch.from_numpy(x), tc, with_aux=True)
    assert float(aux_t) > 0.5
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_temporal_aux_frame_loss_counts():
    """``aux_frame_loss`` 0 drops the per-frame head's terms: the loss
    falls and the head's weights get no gradient."""
    *_, tf, tc, tp, x, y = _pair("temporal")
    with_aux, g1 = _port_loss_and_grads(tf, tc, tp, x, y, 0.0)
    off = dataclasses.replace(tc, aux_frame_loss=0.0)
    without, g0 = _port_loss_and_grads(tf, off, tp, x, y, 0.0)
    assert float(with_aux) > float(without)
    names = [n for n, _ in _flat(tp)]
    i = names.index("aux_w")
    assert float(g1[i].abs().max()) > 0 and float(g0[i].abs().max()) == 0


@pytest.mark.parametrize("name", ["vit", "moe"])
def test_remat_gradients_equal_non_remat(name):
    *_, tc, tp, x, y = _pair(name)
    l1, g1 = _port_loss_and_grads(tdetector, tc, tp, x, y, 0.1)
    l2, g2 = _port_loss_and_grads(
        tdetector, dataclasses.replace(tc, remat=True), tp, x, y, 0.1)
    assert float(l1) == float(l2)
    for a, b in zip(g1, g2):
        assert torch.equal(a, b)


@pytest.mark.parametrize("weights,bound", [("random", 3e-2),
                                           ("shipped", 0.15),
                                           ("cnn_small", 0.1)])
def test_full_width_bf16_gradients_against_f32(weights, bound, monkeypatch):
    """The ``full`` ViT's bf16 gradients on 8 frames at 224² against the
    same loss evaluated in f32 (every bf16 rounding off), per leaf in
    relative L2.  At a random init the rounding costs at most 0.0135; at
    the shipped weights, a well-fit model (loss 0.20) whose gradients are
    small, it costs up to 0.0963 (``patch_b``), and the median leaf 0.033:
    the floor below which two bf16 evaluations, card and CPU among them,
    cannot be told apart, so ``chip_smoke.py`` holds the card's gradients
    to the CPU's at a random init.  The CNN at the shipped ``cnn_small``
    weights (64 px, its serving width) on the same frames at 64²: up to
    0.0889 (``stem_b``), median 0.082 (loss 0.20)."""
    from avd_tpu_torch.models import cnn as tcnn
    from avd_tpu_torch.models import scoring
    if weights == "cnn_small":
        family, cfg = tcnn, tcnn.make_config("small")
        tree = convert.load_checkpoint(scoring._shipped_ckpt("cnn", "small"),
                                       cfg)
    else:
        family, cfg = tdetector, tdetector.make_config("full")
        tree = (tdetector.init_params(0, cfg) if weights == "random" else
                convert.load_checkpoint(
                    scoring._shipped_ckpt("vit", "full"), cfg))
    f, y = ttrain.synthetic_batch(np.random.default_rng(5), 8,
                                  cfg.image_size,
                                  ("blobs", "geometric", "cellular"))

    def grads():
        t = tdetector._map_tree(lambda _, v: v.detach().clone(), tree)
        return _port_loss_and_grads(family, cfg, t, f, y, 0.02)[1]

    g_bf16 = grads()
    monkeypatch.setattr(tdetector, "_bf16", lambda x: x.float())
    monkeypatch.setattr(tcnn, "_bf16", lambda x: x.float())
    g_f32 = grads()
    rels = [float(torch.linalg.norm(a - b) / torch.linalg.norm(b))
            for a, b in zip(g_bf16, g_f32)]
    assert max(rels) <= bound, (int(np.argmax(rels)), max(rels))


def test_cnn_gradient_gap_to_avd_tpu_is_bf16_rounding(monkeypatch):
    """Why the one-device CNN's gradients at the shipped ``cnn_small``
    weights sit past 3e-2 of ``avd_tpu``'s on noise frames (ROADMAP §3
    item 7: 3.37 % on the stem bias when measured): rounding, not a
    fault.  What shows there is no fault is the first assertion: with
    every bf16 cast turned into f32 on both sides (the port's ``_bf16``,
    ``avd_tpu``'s ``jnp.bfloat16``) the two gradients agree to f32
    rounding on every leaf (measured at most 1e-6).  In bf16 the port's
    gradients stay within 0.011 of that exact value (its floor; 0.0044 on
    ``stem_b``), while ``avd_tpu``'s bf16 arithmetic on the CPU (XLA) moves
    its own by up to 0.073 (on ``stem_b``).  On each leaf where the
    two bf16 runs differ by more than 3e-2 (8 leaves with these frames,
    0.072 on ``stem_b``), the port's floor is at most 0.13 of that gap
    (held at 0.2): the gap is ``avd_tpu``'s rounding."""
    from avd_tpu.models import cnn as jcnn
    from avd_tpu_torch.models import cnn as tcnn
    from avd_tpu_torch.models import scoring
    cfg, jc = tcnn.make_config("small"), jcnn.make_config("small")
    tree = convert.load_checkpoint(scoring._shipped_ckpt("cnn", "small"),
                                   cfg)
    rng = np.random.default_rng(0)
    x = rng.random((8, 64, 64, 3), np.float32)
    y = rng.integers(0, 2, 8).astype(np.int32)
    jtree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.float().numpy()),
                                   tree)

    def port():
        t = tdetector._map_tree(lambda _, v: v.detach().clone().float(),
                                tree)
        return [g.numpy() for g in
                _port_loss_and_grads(tcnn, cfg, t, x, y, 0.02)[1]]

    def ref():  # traced anew on each call: jnp.bfloat16 is read then
        g = jax.jit(jax.grad(lambda p: jcnn.loss_fn(
            p, jnp.asarray(x), jnp.asarray(y), jc, False, 0.02)))(jtree)
        t = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, g),
                                    cfg)
        return [v.float().numpy() for v in optim.leaves_of(t)]

    port_bf16, ref_bf16 = port(), ref()
    monkeypatch.setattr(tcnn, "_bf16", lambda v: v.float())
    monkeypatch.setattr(jnp, "bfloat16", jnp.float32)
    port_f32, ref_f32 = port(), ref()

    def rel(a, b):  # each leaf against the exact (f32) gradient's norm
        return np.array([np.linalg.norm(p - q) / np.linalg.norm(r)
                         for p, q, r in zip(a, b, ref_f32)])

    assert rel(port_f32, ref_f32).max() <= 1e-5
    port_floor, ref_floor = rel(port_bf16, port_f32), rel(ref_bf16, ref_f32)
    assert port_floor.max() <= 2e-2, port_floor.max()
    gap = rel(port_bf16, ref_bf16)
    # the leaves past the parity bound: there the port's own rounding is
    # at most a fifth of the gap, so at least four fifths of it is
    # avd_tpu's
    past = gap > 3e-2
    assert past.any(), gap.max()
    assert np.all(port_floor[past] <= 0.2 * gap[past]), \
        (gap[past], port_floor[past])
