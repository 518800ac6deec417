"""Detector scoring and its analyzer hook: the port (CPU) against
``avd_tpu.models.scoring`` and ``avd_tpu.analyzers.video``.

* ``resize_frames`` is held to ``cv2.resize(..., INTER_AREA)`` bit for bit,
  on integer and fractional downscale and on upscale (max |Δ| = 0 gray
  levels at every size here, so the resize moves no logit).
* The serving gates raise as the JAX package's do
  (tests/test_pallas_attention.py:66-84, tests/test_temporal.py,
  tests/test_quant.py); each family and mode builds its bundle on its
  shipped checkpoint, named as ``avd_tpu`` names it; an exported-program
  directory that holds no artifact raises (``tests/test_torch_export.py``
  serves real ones).
* ``analyze_batch`` with ``AVD_DETECTOR=1`` runs through both packages with
  the same trained checkpoint (``detector_small``, carried across by
  ``tools/torch_convert_weights.py``): detector timeline within 1e-2
  (measured 4e-4 on the spliced clip).
"""

import importlib.util
import json
import os

import cv2
import numpy as np
import pytest
import torch

from avd_tpu.analyzers import video as jvideo
from avd_tpu.ingest import video_reader as jreader
from avd_tpu.models import scoring as jscoring
from avd_tpu_torch.analyzers import video as tvideo
from avd_tpu_torch.ingest import video_reader as treader
from avd_tpu_torch.models import scoring as tscoring
from tests import fixtures

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_WEIGHTS = os.path.join(REPO, "avd_tpu", "models", "weights")
_DET_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_BLEND", "AVD_DETECTOR_ARCH",
            "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_DETECTOR_TEMP",
            "AVD_DETECTOR_QUANT", "AVD_DETECTOR_EXPORTED", "AVD_ATTN_FUSED")


@pytest.fixture
def env(monkeypatch):
    """A clean detector environment; both packages' bundles rebuilt."""
    for name in _DET_ENV:
        monkeypatch.delenv(name, raising=False)
    tscoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()
    yield monkeypatch
    tscoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()


def _convert_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_convert_weights",
        os.path.join(REPO, "tools", "torch_convert_weights.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """``detector_small`` converted for the port by the tool."""
    out = str(tmp_path_factory.mktemp("weights") / "detector_small")
    tool = _convert_tool()
    src = os.path.join(_JAX_WEIGHTS, "detector_small")
    assert tool.guess_preset(src) == "small"
    assert tool.main([src, out]) == 0
    assert sorted(os.listdir(out)) == ["calibration.json", "params.npz",
                                       "train_meta.json"]
    return out


# ---------------------------------------------------------------------------
# resize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h,w,size", [(1080, 1920, 224), (360, 640, 224),
                                      (128, 128, 64), (128, 128, 224),
                                      (33, 47, 64), (672, 896, 224),
                                      (896, 672, 224), (96, 64, 32),
                                      (448, 672, 224), (50, 300, 64),
                                      (224, 224, 224)])
def test_resize_frames_is_cv2_inter_area(h, w, size):
    rng = np.random.default_rng(h + w)
    noise = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    frames = np.stack([noise, cv2.GaussianBlur(noise, (0, 0), 1.5)])
    ours = tscoring.resize_frames(frames, size)
    ref = np.stack([cv2.resize(f, (size, size), interpolation=cv2.INTER_AREA)
                    for f in frames])
    assert ours.dtype == np.uint8 and ours.shape == (2, size, size, 3)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, jscoring.resize_frames(frames, size))


def test_prep_frames_flips_to_rgb_in_unit_range():
    frames = np.random.default_rng(0).integers(0, 256, (2, 96, 96, 3),
                                               dtype=np.uint8)
    ours = tscoring._prep_frames(frames, 64)
    ref = jscoring._prep_frames(frames, 64)
    assert ours.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)


# ---------------------------------------------------------------------------
# gates and settings
# ---------------------------------------------------------------------------

def test_gate_rejects_non_vit(env):
    env.setenv("AVD_ATTN_FUSED", "1")
    env.setenv("AVD_DETECTOR_ARCH", "cnn")
    with pytest.raises(ValueError, match="AVD_ATTN_FUSED"):
        tscoring._bundle("cpu")


def test_gate_rejects_quant_combo(env):
    env.setenv("AVD_ATTN_FUSED", "1")
    env.setenv("AVD_DETECTOR_QUANT", "1")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tscoring._bundle("cpu")


@pytest.mark.parametrize("name,value", [
    ("AVD_DETECTOR_EXPORTED", "/nowhere/exported")])
def test_what_is_not_ported_raises_and_names_the_roadmap(env, name, value):
    """Exported programs are ported: a directory without an artifact
    raises at load, and takes precedence over the build-a-model
    settings, as in ``avd_tpu``."""
    env.setenv(name, value)
    env.setenv("AVD_DETECTOR_ARCH", "cnn")
    with pytest.raises(FileNotFoundError, match="manifest.json"):
        tscoring._bundle("cpu")


_PORT_WEIGHTS = os.path.join(REPO, "avd_tpu_torch", "models", "weights")


@pytest.mark.parametrize("settings,want", [
    ({"AVD_DETECTOR_ARCH": "cnn"}, ("CNNConfig", 64, "cnn_small", None)),
    ({"AVD_DETECTOR_ARCH": "temporal"},
     ("TemporalConfig", 64, "temporal_small", 32)),
    ({"AVD_DETECTOR_ARCH": "temporal", "AVD_TEMPORAL_WINDOW": "8"},
     ("TemporalConfig", 64, "temporal_small", 8)),
    ({"AVD_DETECTOR_PRESET": "moe_small"},
     ("ViTConfig", 64, "moe_small", None)),
    ({"AVD_DETECTOR_PRESET": "moe_small", "AVD_ATTN_FUSED": "1"},
     ("ViTConfig", 64, "moe_small", None)),
    ({"AVD_DETECTOR_QUANT": "1"},
     ("ViTConfig", 224, "detector_full+T1.00+int8", None)),
    ({"AVD_DETECTOR_QUANT": "1", "AVD_DETECTOR_ARCH": "cnn"},
     ("CNNConfig", 64, "cnn_small+T1.00+int8", None))])
def test_each_family_and_mode_serves_its_shipped_weights(env, settings,
                                                         want):
    """The bundle of each setting: its family's config, the input size, the
    shipped checkpoint named as avd_tpu names it (the directory aside) and
    the temporal window."""
    env.setenv("AVD_DETECTOR", "1")
    for k, v in settings.items():
        env.setenv(k, v)
    kind, size, label, window = want
    cfg, params, probs, source = tscoring._bundle("cpu")
    assert type(cfg).__name__ == kind
    assert tscoring.input_size("cpu") == size
    assert tscoring.clip_window("cpu") == window
    assert source.startswith(os.path.join(_PORT_WEIGHTS, label.split("+")[0]))
    if "+" in label:
        assert source.endswith(label.split("+", 1)[1])
    assert getattr(cfg, "fused_attn", False) == \
        (settings.get("AVD_ATTN_FUSED") == "1")
    if settings.get("AVD_DETECTOR_PRESET") == "moe_small":
        assert cfg.n_experts == 4
        assert params["patch_w"].dtype == torch.float32
    if settings.get("AVD_DETECTOR_QUANT") == "1":
        assert source.endswith("+int8")
        layer = params["layers"][0] if "layers" in params else \
            params["stages"][0]["blocks"][0]
        assert any(isinstance(v, dict) and v["w_i8"].dtype == torch.int8
                   for v in layer.values())
    frames = np.random.default_rng(0).integers(0, 256, (3, 40, 48, 3),
                                               np.uint8)
    out = tscoring.detector_timeline(frames, device="cpu")
    assert out["weights"] == source and len(out["timeline"]) == 3
    assert all(0.0 <= p <= 1.0 for p in out["timeline"])


@pytest.mark.parametrize("settings,match", [
    ({"AVD_DETECTOR_ARCH": "temporal", "AVD_DETECTOR_QUANT": "1"},
     "vit/cnn"),
    ({"AVD_DETECTOR_PRESET": "moe_small", "AVD_DETECTOR_QUANT": "1"},
     "MoE"),
    ({"AVD_DETECTOR_ARCH": "temporal", "AVD_ATTN_FUSED": "1"},
     "supports the vit family")])
def test_unsupported_combinations_raise_as_avd_tpu(env, settings, match):
    for k, v in settings.items():
        env.setenv(k, v)
    with pytest.raises(ValueError, match=match):
        tscoring._bundle("cpu")
    with pytest.raises(ValueError, match=match):
        jscoring._bundle()


def test_unknown_family_and_preset_raise(env):
    env.setenv("AVD_DETECTOR_ARCH", "resnet")
    with pytest.raises(ValueError, match="unknown model family"):
        tscoring._bundle("cpu")
    env.delenv("AVD_DETECTOR_ARCH")
    env.setenv("AVD_DETECTOR_PRESET", "huge")
    with pytest.raises(ValueError, match="unknown ViT preset"):
        tscoring._bundle("cpu")


def test_bundle_defaults(env, tmp_path):
    # no shipped checkpoint: the random-init case, reached as avd_tpu's
    # rule reaches it (the committed default is in test_torch_weights.py)
    env.setattr(tscoring, "_WEIGHTS_DIR", str(tmp_path))
    env.setenv("AVD_DETECTOR_PRESET", "small")
    cfg, params, probs, source = tscoring._bundle("cpu")
    assert source == "random_init"
    assert (cfg.image_size, cfg.width, cfg.fused_attn) == (64, 256, False)
    assert params["patch_w"].dtype == torch.bfloat16
    assert tscoring._bundle("cpu")[1] is params  # built once
    assert tscoring.input_size("cpu") == 64
    env.setenv("AVD_ATTN_FUSED", "1")
    tscoring._bundle.cache_clear()
    assert tscoring._bundle("cpu")[0].fused_attn is True
    env.delenv("AVD_DETECTOR_PRESET")
    tscoring._bundle.cache_clear()
    assert tscoring._bundle("cpu")[0].image_size == 224  # default: full


def test_enabled_and_blend_factor(env):
    assert not tscoring.enabled() and tscoring.blend_factor() == 0.0
    env.setenv("AVD_DETECTOR", "1")
    assert tscoring.enabled()
    for raw, want in (("0.25", 0.25), ("7", 1.0), ("-1", 0.0), ("x", 0.0)):
        env.setenv("AVD_DETECTOR_BLEND", raw)
        assert tscoring.blend_factor() == want == jscoring.blend_factor()
    env.setenv("AVD_DETECTOR_BLEND", "0.5")
    assert tscoring.blend([0.2, 0.4], [1.0, 0.0]) == \
        jscoring.blend([0.2, 0.4], [1.0, 0.0]) == [0.6, 0.2]
    assert tscoring.blend([0.2, 0.4], [1.0]) == [0.2, 0.4]


def test_temperature(env, tmp_path):
    with open(tmp_path / "calibration.json", "w") as f:
        json.dump({"temperature": 1.7}, f)
    ckpt = str(tmp_path)
    assert tscoring._temperature(None) == 1.0
    assert tscoring._temperature(ckpt) == jscoring._temperature(ckpt) == 1.7
    env.setenv("AVD_DETECTOR_TEMP", "2.5")
    assert tscoring._temperature(ckpt) == 2.5
    env.setenv("AVD_DETECTOR_TEMP", "nope")
    with pytest.warns(UserWarning, match="AVD_DETECTOR_TEMP"):
        assert tscoring._temperature(ckpt) == 1.7


def test_checkpoint_source_and_temperature_suffix(env, small_ckpt):
    env.setenv("AVD_DETECTOR_PRESET", "small")
    env.setenv("AVD_DETECTOR_CKPT", small_ckpt)
    # the shipped calibration is 1.000000000000565, not 1.0: it is named
    assert tscoring._bundle("cpu")[3] == f"{small_ckpt}+T1.00"
    env.setenv("AVD_DETECTOR_TEMP", "1.5")
    tscoring._bundle.cache_clear()
    assert tscoring._bundle("cpu")[3] == f"{small_ckpt}+T1.50"


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def test_disabled_or_empty_gives_none(env):
    frames = np.zeros((2, 64, 64, 3), np.uint8)
    assert tscoring.detector_timeline(frames, device="cpu") is None
    env.setenv("AVD_DETECTOR", "1")
    assert tscoring.detector_timeline(frames[:0], device="cpu") is None
    assert tscoring.detector_timeline_resized(frames[:0],
                                              device="cpu") is None


def test_score_prepped_pads_5_to_8_and_returns_5(env, tmp_path):
    env.setattr(tscoring, "_WEIGHTS_DIR", str(tmp_path))  # random init
    env.setenv("AVD_DETECTOR_PRESET", "small")
    cfg, params, probs, source = tscoring._bundle("cpu")
    seen = []

    def spy(x):
        seen.append(x.clone())
        return probs(x)

    env.setattr(tscoring, "_bundle_on", lambda device:
                (cfg, params, spy, source))
    batch = np.random.default_rng(0).integers(0, 256, (5, 64, 64, 3),
                                              dtype=np.uint8)
    out = tscoring._score_prepped(batch, "cpu")
    assert len(out["timeline"]) == 5 and out["weights"] == "random_init"
    assert all(0.0 <= p <= 1.0 for p in out["timeline"])
    (x,) = seen
    assert tuple(x.shape) == (8, 64, 64, 3)
    for i in (5, 6, 7):  # the last frame repeated
        assert torch.equal(x[i], x[4])
    # a frame's score does not depend on the bucket it rode in
    alone = tscoring._score_prepped(batch[:1], "cpu")
    assert abs(alone["timeline"][0] - out["timeline"][0]) < 2e-2


def test_detector_timeline_matches_avd_tpu(env, small_ckpt):
    frames = fixtures.spliced_clip(12, 96)
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_PRESET", "small")
    env.setenv("AVD_DETECTOR_CKPT", os.path.join(_JAX_WEIGHTS,
                                                 "detector_small"))
    ref = jscoring.detector_timeline(frames)
    env.setenv("AVD_DETECTOR_CKPT", small_ckpt)
    for fused in ("0", "1"):
        env.setenv("AVD_ATTN_FUSED", fused)
        tscoring._bundle.cache_clear()
        ours = tscoring.detector_timeline(frames, device="cpu")
        assert ours["weights"] == f"{small_ckpt}+T1.00" == \
            ref["weights"].replace(_JAX_WEIGHTS, os.path.dirname(small_ckpt))
        np.testing.assert_allclose(ours["timeline"], ref["timeline"],
                                   atol=1e-2)
    resized = tscoring.resize_frames(frames, 64)
    again = tscoring.detector_timeline_resized(resized, device="cpu")
    assert again == ours


# ---------------------------------------------------------------------------
# the analyzer hook
# ---------------------------------------------------------------------------

def _golden():
    fps = 30.0
    frames = fixtures.spliced_clip(45, 96)[::treader.sampling_step(fps)]
    return frames, (len(frames), fps, 96, 96, 45 / fps)


@pytest.mark.parametrize("blend", [None, "0.5"])
def test_analyze_batch_with_the_detector(env, small_ckpt, blend):
    frames, meta = _golden()
    plain = tvideo.analyze_batch(treader.FrameBatch(frames, *meta),
                                 device="cpu")
    assert "detector" not in plain
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_PRESET", "small")
    if blend:
        env.setenv("AVD_DETECTOR_BLEND", blend)
    env.setenv("AVD_DETECTOR_CKPT", os.path.join(_JAX_WEIGHTS,
                                                 "detector_small"))
    ref = jvideo.analyze_batch(jreader.FrameBatch(frames, *meta))
    env.setenv("AVD_DETECTOR_CKPT", small_ckpt)
    ours = tvideo.analyze_batch(treader.FrameBatch(frames, *meta),
                                device="cpu")
    assert "detector_error" not in ours and "detector_error" not in ref
    assert ours["timeline"] is ours["timeline_ai"]
    assert len(ours["detector"]["timeline"]) == len(frames)
    np.testing.assert_allclose(ours["detector"]["timeline"],
                               ref["detector"]["timeline"], atol=1e-2)
    assert ours["summary"] == plain["summary"]
    np.testing.assert_allclose(ours["timeline"], ref["timeline"], atol=1e-2)
    if blend:
        assert ours["timeline"] != plain["timeline"]
    else:  # blend 0: the heuristic fields are untouched
        assert ours["timeline"] == plain["timeline"]


def test_a_detector_failure_is_reported_not_raised(env, tmp_path):
    """A tampered exported artifact fails its digest check: the analyzer
    reports it and keeps the heuristic timeline."""
    from avd_tpu_torch.models import export
    frames, meta = _golden()
    out_dir = str(tmp_path / "artifact")
    export.export_detector(out_dir, preset="small", ckpt=None, batch=2,
                           config_overrides=dict(image_size=32, width=64,
                                                 depth=1, heads=2),
                           device="cpu")
    with open(os.path.join(out_dir, export.PROGRAM_FILE), "ab") as f:
        f.write(b"\0")
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_EXPORTED", out_dir)
    out = tvideo.analyze_batch(treader.FrameBatch(frames, *meta),
                               device="cpu")
    assert out["detector_error"] == "ValueError"
    assert "detector" not in out and out["timeline"] is out["timeline_ai"]


def test_apply_detector_pads_and_truncates(env):
    env.setenv("AVD_DETECTOR_BLEND", "1.0")
    out = {"timeline": [0.0, 0.0, 0.0]}
    tvideo._apply_detector(out, {"timeline": [0.25, 0.75]})
    assert out["timeline"] == [0.25, 0.75, 0.75]
    out = {"timeline": [0.0]}
    tvideo._apply_detector(out, {"timeline": [0.25, 0.75]})
    assert out["timeline"] == [0.25]
    out = {"timeline": [0.1]}
    tvideo._apply_detector(out, None)
    assert out == {"timeline": [0.1]}
