"""The real-data training path of the port, on the committed fixture
corpus (tests/data/corpus_v1: real JPEG and H.264 encodes built by
tools/make_fixture_corpus.py), after tests/test_real_data.py:

* the port's directory loader ``_dir_batches`` draws the same frames and
  labels, bit for bit, as ``avd_tpu``'s, and refuses a bad layout with
  the same message;
* train → eval → serve: the trainer's ``--data`` branch on the corpus, the
  accuracy of the trained parameters on fresh corpus draws, and the
  checkpoint serving scores through ``pipeline.analyze_path``
  (``AVD_DETECTOR_CKPT``);
* the port's corpus builder (tools/torch_make_fixture_corpus.py) writes
  the JAX tool's JPEGs, and the committed ones, byte for byte.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from avd_tpu.models import train as jtrain
from avd_tpu_torch import config as config_mod
from avd_tpu_torch import pipeline
from avd_tpu_torch.models import detector, scoring
from avd_tpu_torch.models import train as train_mod
from avd_tpu_torch.native import decode

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "tests", "data", "corpus_v1")
DRAWS = 4


@pytest.mark.parametrize("size", [48, 64, 224])
@pytest.mark.parametrize("seed", [0, 123])
def test_dir_batches_bit_equal_to_avd_tpu(seed, size):
    """Images and video frames mixed, both classes across the draws, and
    every draw equal to ``avd_tpu``'s at the same seed."""
    it = train_mod._dir_batches(CORPUS, np.random.default_rng(seed), 32,
                                size)
    jit = jtrain._dir_batches(CORPUS, np.random.default_rng(seed), 32, size)
    seen = set()
    for _ in range(DRAWS):
        (frames, labels), (jframes, jlabels) = next(it), next(jit)
        assert frames.shape == (32, size, size, 3)
        assert frames.dtype == np.float32 and labels.dtype == jlabels.dtype
        assert 0.0 <= frames.min() and frames.max() <= 1.0
        assert set(np.unique(labels)) <= {0, 1}
        np.testing.assert_array_equal(frames, jframes)
        np.testing.assert_array_equal(labels, jlabels)
        seen |= set(labels.tolist())
    assert seen == {0, 1}


def _no_folders(root):
    pass


def _empty_real(root):
    (root / "real").mkdir()


def _empty_ai(root):
    (root / "real").mkdir()
    (root / "ai").mkdir()
    (root / "real" / "a.jpg").write_bytes(b"")


@pytest.mark.parametrize("layout", [_no_folders, _empty_real, _empty_ai],
                         ids=["no_folders", "empty_real", "empty_ai"])
def test_dir_batches_validates_layout(tmp_path, layout):
    layout(tmp_path)
    msgs = []
    for mod in (train_mod, jtrain):
        with pytest.raises(ValueError, match="real/") as e:
            next(mod._dir_batches(str(tmp_path), np.random.default_rng(0),
                                  4, 32))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.fixture
def fresh_detector_env():
    config_mod.reset_config()
    scoring._bundle.cache_clear()
    yield
    config_mod.reset_config()
    scoring._bundle.cache_clear()


def test_train_eval_serve_on_real_corpus(tmp_path, monkeypatch,
                                         fresh_detector_env):
    """``train.train(data=<corpus>)`` → accuracy on corpus draws → the
    checkpoint serves scores through the live pipeline: the production
    training loop on file-based data, on the CPU."""
    out = str(tmp_path / "ckpt")
    params, losses = train_mod.train(
        steps=300, batch=16, lr=1e-3, data=CORPUS, image_size=64,
        out=out, log_every=0, schedule="cosine", warmup=30,
        logit_l2=2e-2, device="cpu")
    assert np.isfinite(losses).all()
    assert np.mean(losses[-20:]) < np.mean(losses[:20])

    # train-set separability on fresh corpus draws (the corpus is small)
    cfg = detector.make_config("small", image_size=64)
    frames, labels = next(train_mod._dir_batches(
        CORPUS, np.random.default_rng(123), 64, 64))
    with torch.no_grad():
        logits = detector.forward(params, torch.from_numpy(frames),
                                  cfg)[:, 0]
    acc = float(np.mean((logits.numpy() > 0) == (labels == 1)))
    assert acc >= 0.85, acc

    # serve the trained checkpoint (the detector block beside the oracle
    # heuristics): an ai/ clip must outscore a real/ clip; the checkpoint
    # is small-preset shaped, the serving default preset is `full`
    monkeypatch.setenv("AVD_BACKEND", "oracle")
    monkeypatch.setenv("AVD_DETECTOR", "1")
    monkeypatch.setenv("AVD_DETECTOR_CKPT", out)
    monkeypatch.setenv("AVD_DETECTOR_PRESET", "small")
    config_mod.reset_config()
    scoring._bundle.cache_clear()
    scores = {}
    for sub in ("ai", "real"):
        clip = os.path.join(CORPUS, sub, "clip_00_crf23.mp4")
        env = pipeline.analyze_path(clip, device="cpu")
        det = env["video"].get("detector")
        assert det and det["weights"].startswith(out), det
        scores[sub] = float(np.mean(det["timeline"]))
    assert scores["ai"] > 0.5 > scores["real"], scores


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def built_corpora(tmp_path_factory):
    """Both corpus tools' output at seed 42, built in this process."""
    root = tmp_path_factory.mktemp("corpora")
    tools = {"port": _load_tool("torch_make_fixture_corpus"),
             "avd_tpu": _load_tool("make_fixture_corpus")}
    out = {key: str(root / key) for key in tools}
    for key, tool in tools.items():
        assert tool.build(out[key], 42) == {"real": 26, "ai": 26}
    return out, tools["port"]


def _files(root, ext):
    return sorted(os.path.join(sub, f) for sub in ("real", "ai")
                  for f in os.listdir(os.path.join(root, sub))
                  if f.endswith(ext))


def test_corpus_tool_writes_avd_tpu_jpegs(built_corpora):
    (dirs, tool) = built_corpora
    names = _files(dirs["port"], ".jpg")
    assert names == _files(dirs["avd_tpu"], ".jpg")
    assert len(names) == 2 * tool.N_IMAGES
    assert names == _files(CORPUS, ".jpg")
    for name in names:
        with open(os.path.join(dirs["port"], name), "rb") as f:
            data = f.read()
        for root in (dirs["avd_tpu"], CORPUS):
            with open(os.path.join(root, name), "rb") as g:
                assert data == g.read(), (root, name)


def test_corpus_tool_writes_h264_clips(built_corpora):
    """libx264 is not repeatable run to run: the clips are held to their
    names, frame count and size."""
    import cv2
    if decode.lib() is None:
        pytest.skip(f"libav* not built here: {decode.unavailable()[:200]}")
    (dirs, tool) = built_corpora
    names = _files(dirs["port"], ".mp4")
    assert names == _files(dirs["avd_tpu"], ".mp4") == _files(CORPUS, ".mp4")
    assert len(names) == 2 * tool.N_CLIPS
    for name in names:
        cap = cv2.VideoCapture(os.path.join(dirs["port"], name))
        frames = []
        while True:
            ok, img = cap.read()
            if not ok:
                break
            frames.append(img)
        cap.release()
        assert len(frames) == tool.CLIP_FRAMES, name
        assert {f.shape for f in frames} == {(tool.SIZE, tool.SIZE, 3)}, name
