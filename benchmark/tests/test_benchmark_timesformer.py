"""The TimeSformer cell's pieces on the CPU: its driver at the ``tiny``
preset end to end, ``tsf_gap`` failing a logit altered by 0.1, the FLOP
count of ``roofline/timesformer_forward`` at ``hr`` and by hand at
``tiny``, and each new reader's known answer on a hand-built slice and
ring."""

from __future__ import annotations

import json
import os

import pytest

import _tiny
from avd_tpu_torch.utils import metrics
from benchmark import spans, spec
from benchmark.roofline import peaks, timesformer_forward
from benchmark.run import Run
from test_benchmark_spans import T0, _base, _trace

CELL = "timesformer-hr-c4-1080p"
TINY = {"image_size": 32, "patch": 16, "frames": 4, "width": 64,
        "heads": 4, "mlp": 256, "depth": 2, "checked": 6, "block": 2}


def make_tiny(root: str) -> str:
    """``_tiny.make``, then the cell's configuration at the ``tiny``
    preset and its traffic at the tiny traffic's sizes (clips of 3-6
    frames: one padded window, overlapping last windows)."""
    _tiny.make(root)
    bench = os.path.join(root, "benchmark")
    path = os.path.join(bench, "configs", "timesformer-hr-tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    cfg["timesformer"].update(TINY)
    cfg["env"]["AVD_DETECTOR_PRESET"] = "tiny"
    with open(path, "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic",
                           "tsf-clips-c4-1080p.json")) as f:
        tr = json.load(f)
    tr.update(_tiny.TINY_TRAFFIC)
    with open(os.path.join(bench, "traffic",
                           "tsf-clips-c4-1080p-tiny.json"), "w") as f:
        json.dump(tr, f)
    return root


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return make_tiny(str(tmp_path_factory.mktemp("tiny_tsf")))


def test_tiny_cell_is_correct(tiny_root):
    out = _tiny.run(tiny_root, CELL, seconds=3.0)
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    checks = out["checks"]
    assert {"tsf_gap", "flow_gap", "audio_gap", "texture_gap",
            "failed_clips", "dup_mismatch", "envelope_mismatch"} <= set(checks)
    assert checks["tsf_gap"]["value"] <= checks["tsf_gap"]["limit"]
    assert set(out["metrics"]) == {"setup_s"}   # no card, no card time


_ALTERED = """
from avd_tpu_torch.models import scoring
_sigmoid = scoring._sigmoid
scoring._sigmoid = lambda logits, temp: _sigmoid(logits + 0.1, temp)
"""

_NO_TIMELINE = """
from avd_tpu_torch.models import scoring
scoring.detector_timeline = lambda frames, device=None: None
"""


@pytest.mark.parametrize("fault,check", [(_ALTERED, "tsf_gap"),
                                         (_NO_TIMELINE, "failed_clips")],
                         ids=["logit-altered", "no-timeline"])
def test_planted_fault_is_not_correct(tiny_root, fault, check):
    out = _tiny.run(tiny_root, CELL, patch=fault, seconds=3.0)
    assert out["correct"] is False
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]


def test_control_is_not_correct(tiny_root):
    out = _tiny.run(tiny_root, CELL, control=True, seconds=3.0)
    assert out["correct"] is False
    assert out["checks"]["flow_gap"]["value"] > \
        out["checks"]["flow_gap"]["limit"]


def test_traced_run_reads_only_host_numbers(tiny_root):
    out = _tiny.run(tiny_root, CELL, seconds=7.0, trace=True)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] == 0
    assert not set(out["metrics"]) & {"tsf_mfu", "tsf_overlap_pct",
                                      "tsf_forward_host_ms_per_window"}


def test_a_program_without_the_family_fails_at_once(tiny_root):
    """The parent's program has no ``timesformer`` family: the run raises
    in set-up, before the frame pool is made."""
    patch = ("from avd_tpu_torch import models\n"
             "models.FAMILIES = ('vit', 'cnn', 'temporal')\n"
             "_family = models.family\n"
             "def _old(name):\n"
             "    if name == 'timesformer':\n"
             "        raise ValueError('unknown model family')\n"
             "    return _family(name)\n"
             "models.family = _old\n")
    with pytest.raises(AssertionError, match="unknown model family"):
        _tiny.run(tiny_root, CELL, patch=patch, seconds=1.0, timeout=120)


def _by_hand(s, p, t, d, heads, m, depth):
    n = (s // p) ** 2
    per_layer = 0
    per_layer += 2 * (t * n) * d * (3 * d)             # temporal qkv
    per_layer += n * heads * 2 * (2 * t * t * (d // heads))
    per_layer += 2 * 2 * (t * n) * d * d                # proj, dense
    per_layer += 2 * t * (n + 1) * d * (3 * d)          # spatial qkv
    per_layer += t * heads * 2 * (2 * (n + 1) ** 2 * (d // heads))
    per_layer += 2 * t * (n + 1) * d * d                # proj
    per_layer += 2 * 2 * (t * n + 1) * d * m            # MLP
    return 2 * t * n * (p * p * 3) * d + depth * per_layer + 2 * d


def test_flops_at_hr_and_by_hand_at_tiny():
    hr = timesformer_forward.flops()
    assert abs(hr / 3.405e12 - 1) < 0.005
    tiny = {k: TINY[k] for k in ("image_size", "patch", "frames", "width",
                                 "heads", "mlp", "depth")}
    assert timesformer_forward.flops(**tiny) == _by_hand(
        32, 16, 4, 64, 4, 256, 2)


def test_readers_known_answers(monkeypatch):
    """Two ``det.forward`` spans (2 and 1 windows, 60 and 40 µs) and two
    ``det.stage`` spans (5 frames in a bucket of 8, 16 of 16) inside a
    1 ms slice with kernels."""
    base, ring = _base(), metrics.Spans(64)

    def add(name, s, e, **attrs):
        ring.record(name, base + int((T0 + s) * 1000),
                    base + int((T0 + e) * 1000), **attrs)

    add("analyze", -5000, 2000)
    add("det.stage", 100, 150, frames=5, bucket=8)
    add("det.forward", 200, 260, frames=8, windows=2)
    add("det.stage", 300, 350, frames=16, bucket=16)
    add("det.forward", 400, 440, frames=4, windows=1)
    monkeypatch.setattr(spans, "program_ring", lambda: ring)
    trace, run = _trace(), Run(data={"timesformer": dict(TINY)})
    assert spec.reader("tsf_forward_host_ms_per_window")(run, trace) == \
        pytest.approx(0.1 / 3)
    assert spec.reader("tsf_overlap_pct")(run, trace) == pytest.approx(
        100.0 * 3 / 24)
    per = timesformer_forward.flops(**{k: TINY[k] for k in (
        "image_size", "patch", "frames", "width", "heads", "mlp", "depth")})
    assert spec.reader("tsf_mfu")(run, trace) == pytest.approx(
        100.0 * 3 * per / (trace.window_s * peaks.BF16_FLOPS))
    # nothing to read: a run without the model's sizes, a CPU slice, a
    # program that keeps no spans
    assert spec.reader("tsf_mfu")(Run(), trace) is None
    assert spec.reader("tsf_mfu")(run, _trace(kernels=(), launches=())) \
        is None
    monkeypatch.setattr(spans, "program_ring", lambda: None)
    for name in ("tsf_mfu", "tsf_overlap_pct",
                 "tsf_forward_host_ms_per_window"):
        assert spec.reader(name)(run, trace) is None
