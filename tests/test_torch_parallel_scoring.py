"""The port's scoring in a rank group (CPU, gloo) against ``avd_tpu``.

With more than one rank, ``models/scoring`` scores the per-frame families
sharded over a (data, model) mesh of every rank, as ``avd_tpu`` shards over
its devices (``avd_tpu/models/scoring.py:211-243``).  Ranks are spawned by
``parallel.dryrun.launch`` and import neither ``jax`` nor ``avd_tpu``;
``avd_tpu``'s sharded scores come from its own scoring on the suite's
8-device virtual mesh.  Held at the bf16 tolerance 2e-2:

* the shipped ``small`` ViT and ``cnn_small`` at 2 ranks (data 2), the
  ViT and ``moe_small`` at 4 (data 2 × model 2): every rank's
  probabilities against the single-device port and ``avd_tpu``'s sharded
  scores, the bucket a multiple of the data axis;
* ``AVD_ATTN_FUSED=1`` turned off in the group with ``avd_tpu``'s warning;
  ``AVD_DETECTOR_QUANT=1`` on each rank alone with its warning; the
  temporal family on each rank alone (both equal to one device's).
"""

import os

import numpy as np
import pytest
import torch

from avd_tpu.models import scoring as jscoring
from avd_tpu_torch.models import scoring as tscoring
from avd_tpu_torch.parallel import dryrun

torch.set_num_threads(2)

ATOL = 2e-2
RANKS = "tests.torch_rank_programs:"
N = 5

CASES = {
    "vit": {"AVD_DETECTOR_PRESET": "small"},
    "cnn": {"AVD_DETECTOR_ARCH": "cnn"},
    "moe": {"AVD_DETECTOR_PRESET": "moe_small"},
    "fused": {"AVD_DETECTOR_PRESET": "small", "AVD_ATTN_FUSED": "1"},
    "quant": {"AVD_DETECTOR_PRESET": "small", "AVD_DETECTOR_QUANT": "1"},
    "temporal": {"AVD_DETECTOR_ARCH": "temporal"},
}
WORLDS = {2: ("vit", "cnn", "fused", "quant", "temporal"), 4: ("vit", "moe")}
_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_ARCH", "AVD_DETECTOR_PRESET",
        "AVD_ATTN_FUSED", "AVD_DETECTOR_QUANT", "AVD_DETECTOR_CKPT",
        "AVD_DETECTOR_TEMP", "AVD_DETECTOR_EXPORTED")


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(7).integers(0, 256, (N, 64, 64, 3)) \
        .astype(np.uint8)


@pytest.fixture(scope="module")
def launches(tmp_path_factory, frames):
    work = str(tmp_path_factory.mktemp("scoring"))
    return {n: dryrun.launch(
        n, "cpu", [{"name": c, "kind": RANKS + "scoring_case",
                    "env": CASES[c]} for c in cases],
        inputs={"bgr64": frames}, spec=dryrun.small_spec(), timeout_s=300,
        workdir=work) for n, cases in WORLDS.items()}


def _scores(module, case, frames, **kw):
    """``module``'s detector_timeline_resized under the case's settings."""
    old = {k: os.environ.pop(k, None) for k in _ENV}
    os.environ.update({"AVD_DETECTOR": "1", **CASES[case]})
    module._bundle.cache_clear()
    try:
        return np.asarray(module.detector_timeline_resized(frames, **kw)
                          ["timeline"])
    finally:
        for k in _ENV:
            os.environ.pop(k, None)
        os.environ.update({k: v for k, v in old.items() if v is not None})
        module._bundle.cache_clear()


@pytest.fixture(scope="module")
def refs(frames):
    """(port on one CPU, avd_tpu sharded over its 8 virtual devices)."""
    out = {}
    for case in CASES:
        port = _scores(tscoring, case, frames, device="cpu")
        jax_ = None if case in ("fused", "quant", "temporal") else \
            _scores(jscoring, case, frames)
        out[case] = (port, jax_)
    return out


def _ranks(launches, n, case):
    return [r["programs"][case] for r in launches[n]]


@pytest.mark.parametrize("n,case", [(2, "vit"), (2, "cnn"), (4, "vit"),
                                    (4, "moe")])
def test_sharded_scoring_matches_one_device_and_avd_tpu(launches, refs, n,
                                                        case):
    port, jax_ = refs[case]
    for rep in _ranks(launches, n, case):
        probs = rep["outputs"]["probs"]
        assert probs.shape == (N,)
        np.testing.assert_allclose(probs, port, atol=ATOL)
        np.testing.assert_allclose(probs, jax_, atol=ATOL)
        assert rep["info"]["min_batch"] == 2  # the data axis
        assert rep["info"]["warnings"] == []
        assert rep["collectives"]["all_gather/gloo"] == 1
    # every rank got every probability
    outs = [r["outputs"]["probs"] for r in _ranks(launches, n, case)]
    assert all(np.array_equal(o, outs[0]) for o in outs)


def test_fused_attention_is_turned_off_in_a_group(launches, refs):
    for rep in _ranks(launches, 2, "fused"):
        assert any("AVD_ATTN_FUSED=1 is single-device-only" in w
                   for w in rep["info"]["warnings"])
        np.testing.assert_allclose(rep["outputs"]["probs"], refs["vit"][0],
                                   atol=ATOL)
        assert rep["launches"]["mha"] == 0


@pytest.mark.parametrize("case", ["quant", "temporal"])
def test_single_rank_modes_in_a_group(launches, refs, case):
    for rep in _ranks(launches, 2, case):
        np.testing.assert_allclose(rep["outputs"]["probs"], refs[case][0],
                                   atol=1e-6)
        assert rep["info"]["min_batch"] == 1
        assert {k for k in rep["collectives"] if k != "staged"} == set()
        if case == "quant":
            assert rep["info"]["weights"].endswith("+int8")
            assert any("AVD_DETECTOR_QUANT=1 serves SINGLE-RANK" in w
                       for w in rep["info"]["warnings"])
