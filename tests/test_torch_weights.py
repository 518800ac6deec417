"""The shipped detector weights as the port's default.

* ``avd_tpu_torch/models/weights/<name>/params.npz`` for the five shipped
  checkpoints (``detector_full``, ``detector_small``, ``moe_small``,
  ``cnn_small``, ``temporal_small``) hold what
  ``tools/torch_convert_weights.py`` writes now from
  ``avd_tpu/models/weights/``, the family and preset guessed from
  ``train_meta.json``: the same arrays, the leaves every served mode reads
  in bf16 as bf16 bit patterns and the rest f32, and the bundle built from
  the file is bit-equal to the one built from the f32 conversion.
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

from avd_tpu import models as jmodels
from avd_tpu.models import detector as jdet
from avd_tpu.models import scoring as jscoring
from avd_tpu_torch import models as tmodels
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


# the shipped checkpoints: (family, preset) of each
SHIPPED = {"detector_full": ("vit", "full"),
           "detector_small": ("vit", "small"),
           "moe_small": ("vit", "moe_small"),
           "cnn_small": ("cnn", "small"),
           "temporal_small": ("temporal", "small")}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_convert_weights",
        os.path.join(REPO, "tools", "torch_convert_weights.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """The five shipped checkpoints, converted now by the tool, with the
    family and preset it guesses."""
    tool = _tool()
    out = {}
    for name, (arch, preset) in SHIPPED.items():
        src = os.path.join(_JAX_WEIGHTS, name)
        assert tool.guess_arch(src) == arch, name
        assert tool.guess_preset(src, arch) == preset, name
        dst = str(tmp_path_factory.mktemp("w") / name)
        assert tool.main([src, dst]) == 0
        out[name] = dst
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        elif isinstance(v, list):
            for i, x in enumerate(v):
                out.update(_flat(x, f"{prefix}{k}.{i}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_the_weights_directory_holds_the_five_checkpoints():
    assert sorted(os.listdir(_PORT_WEIGHTS)) == sorted(SHIPPED)
    for (arch, preset), name in scoring._SHIPPED.items():
        assert SHIPPED[name] == (arch, preset)
        assert scoring._shipped_ckpt(arch, preset) == \
            os.path.join(_PORT_WEIGHTS, name)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_committed_weights_are_what_the_converter_writes(name, converted):
    arch, preset = SHIPPED[name]
    cfg = tmodels.family(arch).make_config(preset)
    bf16 = convert.stored_bf16(cfg)
    committed = os.path.join(_PORT_WEIGHTS, name)
    assert sorted(os.listdir(committed)) == ["calibration.json",
                                             "params.npz", "train_meta.json"]
    for side in ("calibration.json", "train_meta.json"):
        with open(os.path.join(committed, side), "rb") as a, \
                open(os.path.join(converted[name], side), "rb") as b:
            assert a.read() == b.read(), side
    with np.load(os.path.join(committed, convert.PARAMS_FILE)) as c, \
            np.load(os.path.join(converted[name],
                                 convert.PARAMS_FILE)) as n:
        assert sorted(c.files) == sorted(n.files)
        for key in c.files:
            want = np.uint16 if key.rsplit(".", 1)[-1] in bf16 \
                else np.float32
            assert c[key].dtype == want, key
            np.testing.assert_array_equal(c[key], n[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_bf16_storage_is_exact_for_inference(name):
    """The bundle from the committed file equals, bit for bit, the one
    built from the f32 conversion of the orbax checkpoint; each leaf that
    a served mode reads in f32 is stored in f32."""
    arch, preset = SHIPPED[name]
    fam, jfam = tmodels.family(arch), jmodels.family(arch)
    cfg = fam.make_config(preset)
    like = jfam.init_params(jax.random.PRNGKey(0), jfam.make_config(preset))
    tree = jfam.load_checkpoint(os.path.join(_JAX_WEIGHTS, name), like)
    f32 = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, tree),
                                  cfg)
    stored = convert.load_npz(os.path.join(
        _PORT_WEIGHTS, name, convert.PARAMS_FILE), cfg)
    a = _flat(fam.cast_for_inference(f32, "cpu"))
    b = _flat(fam.cast_for_inference(stored, "cpu"))
    assert sorted(a) == sorted(b)
    for key in a:
        assert a[key].dtype == b[key].dtype, key
        assert torch.equal(a[key], b[key]), key
    bf16 = convert.stored_bf16(cfg)
    for key, value in _flat(stored).items():
        if key.rsplit(".", 1)[-1] not in bf16:
            assert torch.equal(value, _flat(f32)[key]), key


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
    # one jitted program on one device: avd_tpu's bundle shards the tree
    # over the 8-device test mesh, and op-by-op dispatch of that tree runs
    # every op as an 8-device program whose rendezvous XLA aborts when
    # the host is starved (ROADMAP.md §3)
    ref = np.asarray(jax.jit(jdet.forward, static_argnums=2)(
        jax.device_get(jparams), jnp.asarray(batch), jcfg)[:, 0], np.float32)
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
