"""The ConvNeXt-style CNN of the port (CPU) against ``avd_tpu.models.cnn``.

The same numpy inputs go through both packages.  ``_patch_merge`` is held
bit for bit; ``_dwconv`` (XLA's SAME depthwise 7×7 against ``F.conv2d``
with ``groups=C``, both on bf16) within one bf16 step; the forward on
converted seeded parameters and on the shipped ``cnn_small`` within the
bf16 atol/rtol 2e-2 of ``tests/test_pallas_attention.py``.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avd_tpu.models import cnn as jcnn
from avd_tpu_torch.models import cnn as tcnn
from avd_tpu_torch.models import convert

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_WEIGHTS = os.path.join(REPO, "avd_tpu", "models", "weights")
_PORT_WEIGHTS = os.path.join(REPO, "avd_tpu_torch", "models", "weights")
_TINY = dict(image_size=32, widths=(32, 64), depths=(1, 2))

_jit_forward = jax.jit(jcnn.forward, static_argnums=2)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _frames(n, size, seed=1):
    return np.random.default_rng(seed).random((n, size, size, 3), np.float32)


def test_patch_merge_is_the_jax_layout():
    x = np.arange(2 * 8 * 12 * 5, dtype=np.float32).reshape(2, 8, 12, 5)
    for p in (2, 4):
        want = np.asarray(jcnn._patch_merge(jnp.asarray(x), p))
        got = tcnn._patch_merge(torch.from_numpy(x), p).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw,c", [(8, 32), (4, 64), (16, 128), (7, 24)])
def test_dwconv_matches_xla_same_depthwise(hw, c):
    rng = np.random.default_rng(hw * c)
    x = rng.normal(size=(2, hw, hw, c)).astype(np.float32)
    w = (rng.normal(size=(7, 7, 1, c)) / 7).astype(np.float32)
    b = rng.normal(0, 0.1, size=c).astype(np.float32)
    want = np.asarray(jcnn._dwconv(jnp.asarray(x, jnp.bfloat16),
                                   jnp.asarray(w), jnp.asarray(b)),
                      np.float32)
    got = tcnn._dwconv(torch.from_numpy(x).bfloat16(), torch.from_numpy(w),
                       torch.from_numpy(b))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == x.shape
    # one bf16 step of the larger magnitude (2^-8 relative)
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-2,
                               rtol=8e-3)


def test_param_shapes_are_the_jax_tree():
    for kw in (_TINY, {}, dict(jcnn.PRESETS["full"])):
        jp = jax.eval_shape(lambda: jcnn.init_params(jax.random.PRNGKey(0),
                                                     jcnn.CNNConfig(**kw)))
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        assert tcnn.param_shapes(tcnn.CNNConfig(**kw)) == want


@pytest.mark.parametrize("seed", [0, 3])
def test_forward_matches_avd_tpu_on_seeded_parameters(seed):
    jcfg, tcfg = jcnn.CNNConfig(**_TINY), tcnn.CNNConfig(**_TINY)
    jp = jcnn.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = convert.from_jax_params(_numpy_tree(jp), tcfg)
    frames = _frames(3, 32, seed=seed + 1)
    want = np.asarray(_jit_forward(jp, jnp.asarray(frames), jcfg))
    got = tcnn.forward(tp, torch.from_numpy(frames), tcfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-2, rtol=2e-2)
    # the tree rounded to bf16 ahead of time gives the same logits
    again = tcnn.forward(tcnn.cast_for_inference(tp, "cpu"),
                         torch.from_numpy(frames), tcfg)
    torch.testing.assert_close(again, got, atol=0, rtol=0)


def test_shipped_cnn_small_logits_match_avd_tpu():
    jcfg, tcfg = jcnn.make_config("small"), tcnn.make_config("small")
    like = jcnn.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jcnn.load_checkpoint(os.path.join(_JAX_WEIGHTS, "cnn_small"), like)
    tp = convert.load_npz(os.path.join(_PORT_WEIGHTS, "cnn_small",
                                       convert.PARAMS_FILE), tcfg)
    frames = _frames(6, 64, seed=9)
    want = np.asarray(_jit_forward(jp, jnp.asarray(frames), jcfg))
    got = tcnn.forward(tcnn.cast_for_inference(tp, "cpu"),
                       torch.from_numpy(frames), tcfg).numpy()
    assert np.all(np.isfinite(got)) and got.shape == (6, 1)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_init_params_is_seeded_and_scaled():
    cfg = tcnn.make_config("small")
    a, b, c = (tcnn.init_params(s, cfg) for s in (0, 0, 1))
    blk = a["stages"][2]["blocks"][1]
    assert torch.equal(blk["exp_w"], b["stages"][2]["blocks"][1]["exp_w"])
    assert not torch.equal(a["stem_w"], c["stem_w"])
    assert abs(float(blk["exp_w"].std()) - 1 / np.sqrt(256)) < 2e-3
    assert abs(float(blk["dw_w"].std()) - 1 / 7) < 1e-2
    assert torch.equal(blk["gamma"], torch.full((256,), 1e-2))
    assert float(a["stages"][1]["down_ln_scale"].min()) == 1.0
    assert not a["stages"][1]["down_b"].any() and not a["head_b"].any()
    logits = tcnn.forward(a, torch.from_numpy(_frames(2, 64)), cfg)
    assert torch.isfinite(logits).all()


def test_full_preset_runs_at_224():
    cfg = tcnn.make_config("full")
    assert (cfg.image_size, cfg.widths, cfg.depths) == (224, (128, 256, 512),
                                                        (2, 2, 4))
    params = tcnn.cast_for_inference(tcnn.init_params(0, cfg), "cpu")
    with torch.inference_mode():
        out = tcnn.forward(params, torch.from_numpy(_frames(1, 224)), cfg)
    assert tuple(out.shape) == (1, 1) and torch.isfinite(out).all()
    with pytest.raises(ValueError, match="unknown CNN preset"):
        tcnn.make_config("huge")
