"""The port's detector tools on the CPU: ``tools/torch_eval_detector.py``
against ``tools/eval_detector.py`` on the same weights and draws, its
calibration served by the port's scoring, and
``tools/torch_bench_detector.py``'s modes and FLOP count."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from avd_tpu.models import detector as jdetector
from avd_tpu_torch.models import convert, detector, scoring
from tools import eval_detector as jeval
from tools import torch_bench_detector as bench
from tools import torch_eval_detector as teval

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def overconfident(tmp_path_factory):
    """The ``small`` ViT with seeded weights and its head scaled 30×
    (confident and often wrong: a temperature well above 1 fits), as an
    orbax checkpoint for ``avd_tpu`` and converted for the port."""
    d = tmp_path_factory.mktemp("overconfident")
    cfg = jdetector.make_config("small")
    params = jax.tree_util.tree_map(
        np.asarray, jdetector.init_params(jax.random.PRNGKey(3), cfg))
    params["head_w"] = params["head_w"] * 30.0
    jdetector.save_checkpoint(str(d / "orbax"), params)
    tcfg = detector.make_config("small")
    convert.save_checkpoint(str(d / "port"),
                            convert.from_jax_params(params, tcfg), tcfg)
    return str(d / "orbax"), str(d / "port")


def test_temperature_matches_eval_detector(overconfident):
    """Same weights, same seeded draws (the H.264 calibration draw where
    libav* exists): T within 2e-2 relative, the per-family AUCs within
    0.02 (the bf16 forwards differ by ~1e-2 in a logit)."""
    orbax, port = overconfident
    kw = dict(n=64, jpeg_qualities=(), h264_crfs=())
    _, jf, _, jcal, _ = jeval.eval_checkpoint("vit", "small", orbax, **kw)
    _, tf, _, tcal, _ = teval.eval_checkpoint("vit", "small", port,
                                              device="cpu", **kw)
    assert jcal["temperature"] > 1.5
    np.testing.assert_allclose(tcal["temperature"], jcal["temperature"],
                               rtol=2e-2)
    assert tcal["fit"] == jcal["fit"]
    assert set(tf) == set(jf)
    for fam in jf:
        assert abs(tf[fam][1] - jf[fam][1]) <= 0.02, (fam, tf[fam], jf[fam])


def test_ece_and_fit_temperature_equal_the_reference():
    rng = np.random.default_rng(0)
    z = rng.normal(0, 6, 300)
    y = (rng.random(300) < 1 / (1 + np.exp(-z / 3))).astype(np.int32)
    assert teval.fit_temperature(z, y) == jeval.fit_temperature(z, y)
    p = teval._sigmoid(z)
    assert teval._ece(p, y) == jeval._ece(p, y)
    frames = rng.random((2, 16, 16, 3), np.float32)
    np.testing.assert_array_equal(teval._jpeg_roundtrip(frames, 50),
                                  jeval._jpeg_roundtrip(frames, 50))


def test_write_calibration_is_served(overconfident, tmp_path, monkeypatch,
                                     capsys):
    _, port = overconfident
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    with open(os.path.join(port, convert.PARAMS_FILE), "rb") as f, \
            open(os.path.join(ckpt, convert.PARAMS_FILE), "wb") as g:
        g.write(f.read())
    assert teval.main(["--ckpt", ckpt, "--n", "64", "--device", "cpu",
                       "--write-calibration"]) == 0
    assert "wrote" in capsys.readouterr().out
    with open(os.path.join(ckpt, "calibration.json")) as f:
        calib = json.load(f)
    assert calib["temperature"] > 1.5 and calib["fit"]["seed"] == 999
    for name in ("AVD_DETECTOR_TEMP", "AVD_DETECTOR_EXPORTED",
                 "AVD_DETECTOR_ARCH"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("AVD_DETECTOR", "1")
    monkeypatch.setenv("AVD_DETECTOR_PRESET", "small")
    monkeypatch.setenv("AVD_DETECTOR_CKPT", ckpt)
    scoring._bundle.cache_clear()
    try:
        det = scoring.detector_timeline(
            np.zeros((2, 64, 64, 3), np.uint8), device="cpu")
    finally:
        scoring._bundle.cache_clear()
    assert det["weights"] == f"{ckpt}+T{calib['temperature']:.2f}"


def test_bench_modes_run():
    rows = [bench.bench(m, batch=2, device="cpu", preset="small", reps=1,
                        chain=1) for m in bench.DEFAULT_MODES]
    for r in rows:
        assert r["frames_per_s"] > 0 and r["flops_per_frame"] > 0, r
        assert "frames/s" in bench.line(r)
    by = {r["mode"]: r for r in rows}
    # the same arithmetic in other kernels: the same count
    assert by["vit-int8"]["flops_per_frame"] == by["vit"]["flops_per_frame"]
    assert by["vit-exported"]["flops_per_frame"] == \
        by["vit"]["flops_per_frame"]
    assert by["vit-int8"]["peak"] == "int8"


def test_bench_counts_the_full_vit_flops():
    """4.7 GFLOP a frame for the ``full`` ViT: 6 layers of 24·T·d² +
    4·T²·d with T = 197, d = 384, plus the patch embedding."""
    r = bench.bench("vit", batch=1, device="cpu", reps=1, chain=1)
    t, d = 197, 384
    want = 6 * (24 * t * d * d + 4 * t * t * d) + 2 * 196 * 768 * d \
        + 2 * d
    assert abs(r["flops_per_frame"] - want) / want < 1e-3
