"""Int8 W8A8 serving of the port (CPU) against ``avd_tpu.models.quant``.

* ``quantize_weight`` is bit-equal to ``avd_tpu``'s (``w_i8`` and
  ``scale``): both divide in f32 and round half to even.
* ``qdense`` equals the explicit dequantized-integer product within
  rtol/atol 1e-5 (``tests/test_quant.py:33``), and ``avd_tpu``'s.
* The int8 logits are within the bf16 atol/rtol 2e-2 of ``avd_tpu``'s int8
  forward on the shipped ``detector_full`` and ``cnn_small``, and so is the
  served int8 timeline, labelled ``+int8``.
* MoE and unknown trees raise ``avd_tpu``'s errors; every weight of the
  ViT ``full`` and the CNN ``small`` has the widths ``torch._int_mm`` needs
  on the card (multiples of 8).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avd_tpu.models import cnn as jcnn
from avd_tpu.models import detector as jdet
from avd_tpu.models import quant as jquant
from avd_tpu.models import scoring as jscoring
from avd_tpu_torch.models import cnn as tcnn
from avd_tpu_torch.models import convert
from avd_tpu_torch.models import detector as tdet
from avd_tpu_torch.models import quant as tquant
from avd_tpu_torch.models import scoring

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_WEIGHTS = os.path.join(REPO, "avd_tpu", "models", "weights")
_PORT_WEIGHTS = os.path.join(REPO, "avd_tpu_torch", "models", "weights")
_DET_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_BLEND", "AVD_DETECTOR_ARCH",
            "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_DETECTOR_TEMP",
            "AVD_DETECTOR_QUANT", "AVD_DETECTOR_EXPORTED", "AVD_ATTN_FUSED")

_jit_qforward = jax.jit(jquant.forward, static_argnums=2)


@pytest.fixture
def env(monkeypatch):
    for name in _DET_ENV:
        monkeypatch.delenv(name, raising=False)
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()
    yield monkeypatch
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()


def _shipped(name, jfam, tfam, preset):
    jcfg, tcfg = jfam.make_config(preset), tfam.make_config(preset)
    like = jfam.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jfam.load_checkpoint(os.path.join(_JAX_WEIGHTS, name), like)
    tp = convert.load_npz(os.path.join(_PORT_WEIGHTS, name,
                                       convert.PARAMS_FILE), tcfg)
    return jp, tp, jcfg, tcfg


@pytest.fixture(scope="module")
def vit_full():
    return _shipped("detector_full", jdet, tdet, "full")


@pytest.fixture(scope="module")
def cnn_small():
    return _shipped("cnn_small", jcnn, tcnn, "small")


def _assert_same_quantized(got, want):
    assert got["w_i8"].dtype == torch.int8
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["w_i8"].numpy(),
                                  np.asarray(want["w_i8"]))
    np.testing.assert_array_equal(got["scale"].numpy(),
                                  np.asarray(want["scale"]))


@pytest.mark.parametrize("shape,sd", [((64, 48), 0.3), ((128, 96), 0.5),
                                      ((768, 384), 0.02)])
def test_quantize_weight_is_bit_equal(shape, sd):
    w = np.random.default_rng(shape[0]).normal(0, sd, shape) \
        .astype(np.float32)
    w[:, 0] = 0.0  # an all-zero column takes the 1e-12 floor
    _assert_same_quantized(tquant.quantize_weight(torch.from_numpy(w)),
                           jquant.quantize_weight(jnp.asarray(w)))


def test_quantize_weight_is_bit_equal_on_the_shipped_weights(vit_full):
    jp, tp, _, _ = vit_full
    for key in ("qkv_w", "proj_w", "mlp_in_w", "mlp_out_w"):
        _assert_same_quantized(
            tquant.quantize_weight(tp["layers"][2][key]),
            jquant.quantize_weight(jp["layers"][2][key]))
    _assert_same_quantized(tquant.quantize_weight(tp["patch_w"]),
                           jquant.quantize_weight(jp["patch_w"]))


def test_qdense_matches_manual_dequant_and_avd_tpu():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1.5, (5, 7, 64)).astype(np.float32)
    w = rng.normal(0, 0.3, (64, 48)).astype(np.float32)
    b = rng.normal(0, 0.1, (48,)).astype(np.float32)
    qw = tquant.quantize_weight(torch.from_numpy(w))
    got = tquant.qdense(torch.from_numpy(x), qw, torch.from_numpy(b))
    assert got.dtype == torch.float32 and tuple(got.shape) == (5, 7, 48)
    s_w = np.max(np.abs(w), axis=0) / 127.0
    w_i8 = np.round(w / s_w)
    s_x = np.max(np.abs(x), axis=-1, keepdims=True) / 127.0
    x_i8 = np.round(x / s_x)
    want = (x_i8 @ w_i8) * s_x * s_w + b
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = np.asarray(jquant.qdense(jnp.asarray(x), jquant.quantize_weight(
        jnp.asarray(w)), jnp.asarray(b)))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)
    # without a bias: the same product
    np.testing.assert_allclose(tquant.qdense(torch.from_numpy(x), qw).numpy(),
                               got.numpy() - b, rtol=0, atol=1e-6)


def test_int_matmul_is_exact_on_the_cpu():
    rng = np.random.default_rng(2)
    x = rng.integers(-127, 128, (5, 48), dtype=np.int8)
    w = rng.integers(-127, 128, (48, 24), dtype=np.int8)
    got = tquant.int_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int64) @ w.astype(np.int64))


def test_vit_full_int8_logits_match_avd_tpu(vit_full):
    jp, tp, jcfg, tcfg = vit_full
    frames = np.random.default_rng(3).random((2, 224, 224, 3), np.float32)
    want = np.asarray(_jit_qforward(jquant.quantize_params(jp),
                                    jnp.asarray(frames), jcfg))
    got = tquant.forward(tquant.quantize_params(tp),
                         torch.from_numpy(frames), tcfg).numpy()
    assert np.all(np.isfinite(got)) and got.shape == (2, 1)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_cnn_small_int8_logits_match_avd_tpu(cnn_small):
    jp, tp, jcfg, tcfg = cnn_small
    frames = np.random.default_rng(4).random((6, 64, 64, 3), np.float32)
    want = np.asarray(_jit_qforward(jquant.quantize_params(jp),
                                    jnp.asarray(frames), jcfg))
    got = tquant.forward(tquant.quantize_params(tp),
                         torch.from_numpy(frames), tcfg).numpy()
    assert np.all(np.isfinite(got)) and got.shape == (6, 1)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def test_quantize_params_rejects_moe_and_unknown_trees():
    moe = tdet.init_params(0, tdet.make_config("moe_small"))
    with pytest.raises(ValueError, match="MoE"):
        tquant.quantize_params(moe)
    with pytest.raises(ValueError, match="unrecognized"):
        tquant.quantize_params({"blocks": []})


@pytest.mark.parametrize("fam,preset", [(tdet, "full"), (tdet, "small"),
                                        (tcnn, "small"), (tcnn, "full")])
def test_every_int8_weight_has_widths_for_int_mm(fam, preset):
    qp = tquant.quantize_params(fam.init_params(0, fam.make_config(preset)))
    leaves = []

    def walk(t):
        if isinstance(t, dict) and "w_i8" in t:
            leaves.append(tuple(t["w_i8"].shape))
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)

    walk(qp)
    assert leaves and all(k % tquant.INT_MM_MULTIPLE == 0
                          and n % tquant.INT_MM_MULTIPLE == 0
                          for k, n in leaves), leaves


def test_served_int8_timeline_matches_avd_tpu(env):
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_ARCH", "cnn")
    env.setenv("AVD_DETECTOR_QUANT", "1")
    frames = np.random.default_rng(5).integers(0, 256, (5, 48, 64, 3),
                                               np.uint8)
    got = scoring.detector_timeline(frames, device="cpu")
    with pytest.warns(UserWarning, match="SINGLE-CHIP"):
        want = jscoring.detector_timeline(frames)
    assert got["weights"].endswith("cnn_small+T1.00+int8")
    assert got["weights"].replace(_PORT_WEIGHTS, _JAX_WEIGHTS) == \
        want["weights"]
    np.testing.assert_allclose(got["timeline"], want["timeline"], atol=2e-2)
