"""The ViT detector of the port (CPU) against ``avd_tpu.models.detector``.

The JAX parameter tree goes through ``convert.from_jax_params``; the same
numpy frames go through both forwards; logits are held to atol/rtol 2e-2
(the bf16 bound of tests/test_pallas_attention.py).  Measured max |Δlogit|:
4.6e-3 on the random tiny config, 3.0e-3 with the trained ``detector_small``
checkpoint, 2.8e-3 with the trained ``detector_full`` checkpoint.  The two
packages round to bf16 at the same places (each product, then its bias);
what is left is the order of the f32 sums inside the matmuls and the tanh
GELU, which XLA evaluates in bf16 steps and PyTorch in one f32 step.
The Switch-MoE configs (tiny here; the shipped ``moe_small`` in
``tests/test_torch_moe.py``) are held to the same bound.
"""

import dataclasses
import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avd_tpu.models import detector as jdet
from avd_tpu.ops.pallas import attention as pattn
from avd_tpu_torch import models as tmodels
from avd_tpu_torch.models import cnn as tcnn
from avd_tpu_torch.models import convert
from avd_tpu_torch.models import detector as tdet
from avd_tpu_torch.models import temporal as ttemporal

torch.set_num_threads(2)

_WEIGHTS = os.path.join(os.path.dirname(jdet.__file__), "weights")
_TINY = dict(image_size=32, patch=16, width=64, depth=2, heads=2)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(n, size, seed=1):
    return np.random.default_rng(seed).random((n, size, size, 3), np.float32)


def _jax_forward(params, frames, cfg):
    """JAX logits; a fused config runs its Pallas kernel in interpret
    mode, as tests/test_pallas_attention.py does on the CPU."""
    if not cfg.fused_attn:
        return np.asarray(jdet.forward(params, jnp.asarray(frames), cfg))
    orig = pattn.attention
    try:
        pattn.attention = functools.partial(orig, interpret=True)
        return np.asarray(jdet.forward(params, jnp.asarray(frames), cfg))
    finally:
        pattn.attention = orig


@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_avd_tpu_tiny(fused):
    jcfg = jdet.ViTConfig(**_TINY, fused_attn=fused)
    tcfg = tdet.ViTConfig(**_TINY, fused_attn=fused)
    jp = jdet.init_params(jax.random.PRNGKey(0), jcfg)
    tp = convert.from_jax_params(_numpy_tree(jp), tcfg)
    frames = _frames(3, 32)
    want = _jax_forward(jp, frames, jcfg)
    got = tdet.forward(tp, torch.from_numpy(frames), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("preset,ckpt,n", [("small", "detector_small", 4),
                                           ("full", "detector_full", 2)])
@pytest.mark.parametrize("fused", [False, True])
def test_forward_matches_avd_tpu_with_the_shipped_checkpoint(preset, ckpt, n,
                                                             fused):
    jcfg = jdet.make_config(preset)
    tcfg = tdet.make_config(preset, fused_attn=fused)
    like = jdet.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jdet.load_checkpoint(os.path.join(_WEIGHTS, ckpt), like)
    tp = convert.from_jax_params(_numpy_tree(jp), tcfg)
    frames = _frames(n, jcfg.image_size)
    want = _jax_forward(jp, frames, jcfg)
    got = tdet.forward(tp, torch.from_numpy(frames), tcfg).numpy()
    assert np.all(np.isfinite(got)) and got.shape == (n, 1)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    # the tree rounded to bf16 ahead of time gives the same logits
    cast = tdet.cast_for_inference(tp, "cpu")
    assert cast["layers"][0]["qkv_w"].dtype == torch.bfloat16
    assert cast["layers"][0]["ln1_scale"].dtype == torch.float32
    assert cast["head_w"].dtype == torch.float32
    again = tdet.forward(cast, torch.from_numpy(frames), tcfg).numpy()
    np.testing.assert_array_equal(again, got)


def test_patchify_orders_a_patch_as_row_column_channel():
    x = np.arange(2 * 32 * 48 * 3, dtype=np.float32).reshape(2, 32, 48, 3)
    want = np.asarray(jdet.patchify(jnp.asarray(x), 16))
    got = tdet.patchify(torch.from_numpy(x), 16).numpy()
    np.testing.assert_array_equal(got, want)


def test_layer_norm_and_embed_match():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 64)).astype(np.float32)
    s, b = (rng.normal(size=64).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tdet._ln(torch.from_numpy(x), torch.from_numpy(s),
                 torch.from_numpy(b)).numpy(),
        np.asarray(jdet._ln(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))),
        atol=1e-5, rtol=1e-5)
    jcfg, tcfg = jdet.ViTConfig(**_TINY), tdet.ViTConfig(**_TINY)
    jp = jdet.init_params(jax.random.PRNGKey(3), jcfg)
    tp = convert.from_jax_params(_numpy_tree(jp), tcfg)
    frames = _frames(2, 32, seed=5)
    want = np.asarray(jdet.embed(jp, jnp.asarray(frames), jcfg), np.float32)
    got = tdet.embed(tp, torch.from_numpy(frames), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("preset", ["small", "full", "moe_small"])
def test_configs_match(preset):
    j, t = jdet.make_config(preset), tdet.make_config(preset)
    for name in ("image_size", "patch", "width", "depth", "heads",
                 "mlp_ratio", "n_classes", "fused_attn", "n_experts",
                 "capacity_factor", "tokens", "head_dim", "mlp_width"):
        assert getattr(j, name) == getattr(t, name), name
    if j.n_experts:
        assert j.expert_capacity == t.expert_capacity
    assert tdet.make_config(preset, fused_attn=True).fused_attn


def test_param_shapes_are_the_jax_tree():
    for kw in (_TINY, dict(jdet.PRESETS["small"]), {},
               dict(jdet.PRESETS["moe_small"])):
        jp = jdet.init_params(jax.random.PRNGKey(0), jdet.ViTConfig(**kw))
        shapes = tdet.param_shapes(tdet.ViTConfig(**kw))
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        assert shapes == want


def test_init_params_is_seeded_and_scaled():
    cfg = tdet.make_config("small")
    a, b, c = (tdet.init_params(s, cfg) for s in (0, 0, 1))
    assert torch.equal(a["layers"][2]["qkv_w"], b["layers"][2]["qkv_w"])
    assert not torch.equal(a["patch_w"], c["patch_w"])
    assert a["patch_w"].dtype == torch.float32
    assert abs(float(a["layers"][0]["mlp_out_w"].std())
               - 1 / np.sqrt(cfg.mlp_width)) < 2e-3
    assert abs(float(a["pos_emb"].std()) - 0.02) < 2e-3
    assert float(a["ln_f_scale"].min()) == 1.0
    assert not a["layers"][1]["qkv_b"].any() and not a["head_b"].any()
    logits = tdet.forward(a, torch.from_numpy(_frames(2, 64)), cfg)
    assert torch.isfinite(logits).all()


@pytest.mark.parametrize("n_experts", [0, 4])
def test_converter_round_trips_through_npz(tmp_path, n_experts):
    cfg = tdet.ViTConfig(**_TINY, n_experts=n_experts)
    params = tdet.init_params(7, cfg)
    path = str(tmp_path / convert.PARAMS_FILE)
    convert.save_npz(path, params, cfg)
    back = convert.load_npz(path, cfg)
    bf16 = convert.stored_bf16(cfg)
    # a dense tree is stored in f32 (the int8 forward quantizes from it);
    # an MoE tree stores its attention and expert operands as bf16
    assert bool(bf16) == bool(n_experts)
    assert not set(bf16) & set(tdet._EMBED)

    def stored(k, v):  # bf16 leaves are stored as bf16 bit patterns
        return v.bfloat16().float() if k in bf16 else v

    assert sorted(back) == sorted(params)
    for k, v in params.items():
        if k != "layers":
            assert torch.equal(back[k], stored(k, v)), k
    assert len(back["layers"]) == cfg.depth
    for lp, lb in zip(params["layers"], back["layers"]):
        assert sorted(lp) == sorted(lb)
        for k in lp:
            assert torch.equal(lb[k], stored(k, lp[k])), k
    # rounding at storage is the rounding the forward does at each use
    a = tdet.cast_for_inference(params, "cpu")
    b = tdet.cast_for_inference(back, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a if k != "layers")
    # an MoE tree keeps the embedding leaves in f32 for its router
    want = torch.float32 if n_experts else torch.bfloat16
    assert all(b[k].dtype == want for k in tdet._EMBED)


def test_converter_checks_the_tree_against_the_config(tmp_path):
    cfg = tdet.ViTConfig(**_TINY)
    tree = _numpy_tree(jdet.init_params(jax.random.PRNGKey(0),
                                        jdet.ViTConfig(**_TINY)))
    with pytest.raises(ValueError, match="layers"):
        convert.from_jax_params(tree, dataclasses.replace(cfg, depth=3))
    with pytest.raises(ValueError, match="patch_w: shape"):
        convert.from_jax_params(tree, dataclasses.replace(cfg, width=128,
                                                          heads=4))
    path = str(tmp_path / "p.npz")
    convert.save_npz(path, convert.from_jax_params(tree, cfg), cfg)
    with pytest.raises(ValueError):
        convert.load_npz(path, dataclasses.replace(cfg, depth=1))
    # an MoE tree is not a dense one, nor the other way round
    moe = tdet.ViTConfig(**_TINY, n_experts=4)
    jtree = _numpy_tree(jdet.init_params(
        jax.random.PRNGKey(0), jdet.ViTConfig(**_TINY, n_experts=4)))
    with pytest.raises(ValueError, match="unexpected keys"):
        convert.from_jax_params(jtree, cfg)
    with pytest.raises(ValueError, match="missing keys"):
        convert.from_jax_params(tree, moe)
    with pytest.raises(ValueError, match="unknown ViT preset"):
        tdet.make_config("huge")


@pytest.mark.parametrize("fused", [False, True])
def test_moe_tiny_matches_avd_tpu(fused):
    """The Switch-MoE block on a random tiny config: the same top-1 expert
    for every token of every layer, logits within 2e-2."""
    jcfg = jdet.ViTConfig(**_TINY, n_experts=4, fused_attn=fused)
    tcfg = tdet.ViTConfig(**_TINY, n_experts=4, fused_attn=fused)
    jp = jdet.init_params(jax.random.PRNGKey(2), jcfg)
    tp = convert.from_jax_params(_numpy_tree(jp), tcfg)
    frames = _frames(3, 32, seed=6)
    rx = jdet._router_features(jp, jnp.asarray(frames), jcfg)
    want_idx = np.stack([np.asarray(jnp.argmax(jnp.round(
        (rx @ lp["router_w"]) * jdet._ROUTER_GRID), axis=-1))
        for lp in jp["layers"]])
    got_idx = tdet.expert_indices(tp, torch.from_numpy(frames), tcfg)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    want = _jax_forward(jp, frames, jcfg)
    got = tdet.forward(tdet.cast_for_inference(tp, "cpu"),
                       torch.from_numpy(frames), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("name,module", [("cnn", tcnn),
                                         ("temporal", ttemporal)])
def test_family_returns_the_ported_module(name, module):
    assert tmodels.FAMILIES == ("vit", "cnn", "temporal")
    assert tmodels.family("vit") is tdet
    assert tmodels.family(name) is module
    for attr in ("Config", "PRESETS", "make_config", "param_shapes",
                 "init_params", "cast_for_inference", "forward"):
        assert hasattr(module, attr), attr
    with pytest.raises(ValueError, match="unknown model family"):
        tmodels.family("resnet")
