"""The shipped detector weights as the port's default.

* ``avd_tpu_torch/models/weights/detector_{full,small}/params.npz`` hold
  what ``tools/torch_convert_weights.py`` writes now from
  ``avd_tpu/models/weights/``: the same arrays, the bf16 operands as bf16
  bit patterns, and the bundle built from the file is bit-equal to the one
  built from the f32 conversion.
* With ``AVD_DETECTOR=1`` and no ``AVD_DETECTOR_CKPT`` the port serves
  ``full`` on them (``small`` under ``AVD_DETECTOR_PRESET=small``), named
  as ``avd_tpu`` names its checkpoint, up to the directory; its logits are
  within the bf16 atol/rtol 2e-2 of ``avd_tpu``'s default bundle
  (tests/test_pallas_attention.py:37).
* An orbax directory in ``AVD_DETECTOR_CKPT`` raises, naming the converter.
"""

import importlib.util
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avd_tpu.models import detector as jdet
from avd_tpu.models import scoring as jscoring
from avd_tpu_torch.models import convert, detector, scoring
from tests import fixtures

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_WEIGHTS = os.path.join(REPO, "avd_tpu", "models", "weights")
_PORT_WEIGHTS = os.path.join(REPO, "avd_tpu_torch", "models", "weights")
_DET_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_BLEND", "AVD_DETECTOR_ARCH",
            "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_DETECTOR_TEMP",
            "AVD_DETECTOR_QUANT", "AVD_DETECTOR_EXPORTED", "AVD_ATTN_FUSED")


@pytest.fixture
def env(monkeypatch):
    for name in _DET_ENV:
        monkeypatch.delenv(name, raising=False)
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()
    yield monkeypatch
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """Both shipped checkpoints, converted now by the tool."""
    spec = importlib.util.spec_from_file_location(
        "torch_convert_weights",
        os.path.join(REPO, "tools", "torch_convert_weights.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    out = {}
    for preset in ("full", "small"):
        dst = str(tmp_path_factory.mktemp("w") / f"detector_{preset}")
        assert tool.main([os.path.join(_JAX_WEIGHTS, f"detector_{preset}"),
                          dst]) == 0
        out[preset] = dst
    return out


def _flat(tree):
    out = {k: v for k, v in tree.items() if k != "layers"}
    for i, lp in enumerate(tree["layers"]):
        out.update({f"layers.{i}.{k}": v for k, v in lp.items()})
    return out


@pytest.mark.parametrize("preset", ["full", "small"])
def test_committed_weights_are_what_the_converter_writes(preset, converted):
    committed = os.path.join(_PORT_WEIGHTS, f"detector_{preset}")
    assert sorted(os.listdir(committed)) == ["calibration.json",
                                             "params.npz", "train_meta.json"]
    for side in ("calibration.json", "train_meta.json"):
        with open(os.path.join(committed, side), "rb") as a, \
                open(os.path.join(converted[preset], side), "rb") as b:
            assert a.read() == b.read(), side
    with np.load(os.path.join(committed, convert.PARAMS_FILE)) as c, \
            np.load(os.path.join(converted[preset],
                                 convert.PARAMS_FILE)) as n:
        assert sorted(c.files) == sorted(n.files)
        for name in c.files:
            key = name.rsplit(".", 1)[-1]
            want = np.uint16 if key in detector._BF16 else np.float32
            assert c[name].dtype == want, name
            np.testing.assert_array_equal(c[name], n[name], err_msg=name)


@pytest.mark.parametrize("preset", ["full", "small"])
def test_bf16_storage_is_exact_for_inference(preset):
    """The bundle from the committed file equals, bit for bit, the one
    built from the f32 conversion of the orbax checkpoint."""
    cfg = detector.make_config(preset)
    like = jdet.init_params(jax.random.PRNGKey(0), jdet.make_config(preset))
    tree = jdet.load_checkpoint(os.path.join(_JAX_WEIGHTS,
                                             f"detector_{preset}"), like)
    f32 = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                                  cfg)
    stored = convert.load_npz(os.path.join(
        _PORT_WEIGHTS, f"detector_{preset}", convert.PARAMS_FILE), cfg)
    a = _flat(detector.cast_for_inference(f32, "cpu"))
    b = _flat(detector.cast_for_inference(stored, "cpu"))
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name


def test_default_bundle_is_the_shipped_full(env):
    cfg, params, _, source = scoring._bundle("cpu")
    ckpt = os.path.join(_PORT_WEIGHTS, "detector_full")
    assert (cfg.image_size, cfg.width, cfg.depth) == (224, 384, 6)
    assert source == f"{ckpt}+T1.00"
    assert scoring._default_preset("vit") == "full"
    assert scoring._shipped_ckpt("vit", "full") == ckpt
    assert scoring._default_preset("cnn") == "small"
    stored = convert.load_npz(os.path.join(ckpt, convert.PARAMS_FILE), cfg)
    assert torch.equal(params["layers"][3]["qkv_w"],
                       stored["layers"][3]["qkv_w"].bfloat16())
    env.setenv("AVD_DETECTOR_PRESET", "small")
    scoring._bundle.cache_clear()
    cfg, _, _, source = scoring._bundle("cpu")
    assert cfg.image_size == 64
    assert source == os.path.join(_PORT_WEIGHTS, "detector_small") + "+T1.00"


def test_the_default_rule_without_full(env, tmp_path):
    """Only ``detector_small`` shipped → small; neither → full, seeded."""
    shutil.copytree(os.path.join(_PORT_WEIGHTS, "detector_small"),
                    tmp_path / "detector_small")
    env.setattr(scoring, "_WEIGHTS_DIR", str(tmp_path))
    assert scoring._default_preset("vit") == "small"
    assert scoring._bundle("cpu")[3] == \
        str(tmp_path / "detector_small") + "+T1.00"
    shutil.rmtree(tmp_path / "detector_small")
    scoring._bundle.cache_clear()
    assert scoring._default_preset("vit") == "full"
    cfg, _, _, source = scoring._bundle("cpu")
    assert (cfg.image_size, source) == (224, "random_init")


def test_logits_match_avd_tpu_default_bundle(env):
    frames = fixtures.spliced_clip(4, 96)
    env.setenv("AVD_DETECTOR", "1")
    jcfg, jparams, _, jsource, _ = jscoring._bundle()
    assert jsource == os.path.join(_JAX_WEIGHTS, "detector_full") + "+T1.00"
    batch = jscoring._prep_frames(frames, jcfg.image_size)
    ref = np.asarray(jdet.forward(jparams, jnp.asarray(batch), jcfg)[:, 0],
                     np.float32)
    cfg, params, _, source = scoring._bundle("cpu")
    assert source.replace(_PORT_WEIGHTS, _JAX_WEIGHTS) == jsource
    ours_batch = scoring._prep_frames(frames, cfg.image_size)
    np.testing.assert_array_equal(ours_batch, batch)
    with torch.inference_mode():
        ours = detector.forward(params, torch.from_numpy(ours_batch),
                                cfg)[:, 0].float().numpy()
    np.testing.assert_allclose(ours, ref, atol=2e-2, rtol=2e-2)
    # and the served probabilities, through both packages' timelines
    got = scoring.detector_timeline(frames, device="cpu")
    want = jscoring.detector_timeline(frames)
    assert got["weights"].replace(_PORT_WEIGHTS, _JAX_WEIGHTS) == \
        want["weights"]
    np.testing.assert_allclose(got["timeline"], want["timeline"], atol=2e-2)


def test_orbax_checkpoint_raises_naming_the_converter(env):
    env.setenv("AVD_DETECTOR_CKPT", os.path.join(_JAX_WEIGHTS,
                                                 "detector_full"))
    with pytest.raises(ValueError, match="tools/torch_convert_weights.py"):
        scoring._bundle("cpu")
