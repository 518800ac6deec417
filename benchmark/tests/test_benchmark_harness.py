"""The harness finds every piece by name, runs a cell end to end on the
CPU at a tiny size, and decides ``correct`` by a comparison that its
control and planted faults fail."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

import _tiny
from benchmark import run as run_mod
from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _spec():
    return spec.load(_tiny.REPO)


def test_every_cell_finds_its_pieces():
    s = _spec()
    for cell in s["workloads"]:
        cfg = spec.config(s, cell["config"], _tiny.REPO)
        assert cfg["name"] == cell["config"]
        traffic = spec.traffic(cell["traffic"])
        assert callable(spec.driver(traffic["kind"]).run)
        e2e = spec.metrics_of(s, cell["name"], "end_to_end")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        layer = spec.metrics_of(s, cell["name"], "per_layer")
        assert layer, cell["name"]
        for m in e2e + layer:
            assert callable(spec.reader(m["name"]))


def test_benchmark_json_keeps_to_its_contract():
    s = _spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert s["paths"] == ["benchmark"]
    assert 1 <= s["run_seconds"] <= 51
    assert 2 + 14 * 24 * (s["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(_tiny.REPO, c["file"]))
    cells = {w["name"] for w in s["workloads"]}
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in s["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in s["per_layer"]:
        assert UNIT.match(m["unit"]) and "\n" not in m["layer"]
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", cells)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(s)) < 64 * 1024


def test_added_pieces_run_by_name(tmp_path):
    """A configuration, a traffic mix and a metric added as files and
    entries alone are found and run."""
    root = _tiny.make(str(tmp_path))
    bench = os.path.join(root, "benchmark")
    with open(os.path.join(bench, "configs", "heuristic-tiny.json")) as f:
        cfg = json.load(f)
    cfg["name"] = "added"
    with open(os.path.join(bench, "configs", "added.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic",
                           "clips-c4-1080p-tiny.json")) as f:
        tr = json.load(f)
    tr.update(clients=1, clip_frames=[4, 4], length_grid=1)
    with open(os.path.join(bench, "traffic", "added-mix.json"), "w") as f:
        json.dump(tr, f)
    with open(os.path.join(bench, "metrics", "clips_done.py"), "w") as f:
        f.write("def read(run, trace):\n"
                "    return run.data.get('clips_done')\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        s = json.load(f)
    s["configs"].append({"name": "added", "source": "https://example.org",
                         "file": "benchmark/configs/added.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "added-cell", "config": "added",
                           "traffic": "added-mix", "chips": 1,
                           "why": "a test"})
    s["end_to_end"].append({"name": "clips_done", "unit": "clips",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["added-cell"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(s, f)
    out = _tiny.run(root, "added-cell")
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) == {"clips_done", "setup_s"}
    assert out["metrics"]["clips_done"]["value"] >= 1
    assert out["attempted"] >= out["metrics"]["clips_done"]["value"]
    assert list(out)[-1] == "checks"


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    return _tiny.make(str(tmp_path_factory.mktemp("tiny")))


def test_tiny_heuristic_cell_is_correct(tiny_root):
    out = _tiny.run(tiny_root, "heuristic-c4-1080p")
    assert out["correct"] is True, out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0
    # the card's time is the end-to-end metric; the CPU has none to give
    assert set(out["metrics"]) == {"setup_s"}
    assert out["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", ["heuristic-c4-1080p",
                                  "vit-full-train-b64"])
def test_traced_run_on_the_cpu_writes_no_device_number(tiny_root, cell):
    """A traced run takes its slice and stays correct; the CPU's slice
    holds no device event, so only the host's per-layer numbers are
    read."""
    out = _tiny.run(tiny_root, cell, seconds=4.0, trace=True)
    assert out["correct"] is True, out["checks"]
    assert set(out["metrics"]) <= {"host_frames_per_s.heur",
                                   "host_clip_p95_s.heur",
                                   "host_train_frames_per_s"}
    assert out["metrics"]
    assert out["device"]["busy_s"] == 0
    assert "breakdown" in out


def test_control_is_not_correct(tiny_root):
    """The control: the program's bfloat16 flow fields and the audio
    reference on bfloat16 samples in the program's place."""
    out = _tiny.run(tiny_root, "heuristic-c4-1080p", control=True)
    assert out["correct"] is False
    checks = out["checks"]
    assert checks["flow_gap"]["value"] > checks["flow_gap"]["limit"]
    assert checks["audio_gap"]["value"] > checks["audio_gap"]["limit"]


_ALTERED = """
import torch
from avd_tpu_torch.ops import flow
_stats = flow.flow_magnitude_stats
def _altered(fl):
    m, v = _stats(fl)
    return m * (1 + 1e-3), v
flow.flow_magnitude_stats = _altered
"""

_HALF = """
import torch
from avd_tpu_torch.ops import flow
_stats = flow.flow_magnitude_stats
def _half(fl):
    b = fl.shape[0]
    m, v = _stats(fl[: max(1, b // 2)])
    k = -(-b // m.shape[0])
    return m.repeat(k)[:b], v.repeat(k)[:b]
flow.flow_magnitude_stats = _half
"""

_DETECTOR = """
import torch
from avd_tpu_torch.models import scoring
_sigmoid = scoring._sigmoid
scoring._sigmoid = lambda logits, temp: _sigmoid(logits + 0.1, temp)
"""


@pytest.mark.parametrize("cell,fault,check", [
    ("heuristic-c4-1080p", _ALTERED, "flow_gap"),
    ("heuristic-c4-1080p", _HALF, "flow_gap"),
    ("vit-full-c4-1080p", _DETECTOR, "det_gap"),
], ids=["answer-altered", "half-the-batch", "detector-altered"])
def test_planted_fault_is_not_correct(tiny_root, cell, fault, check):
    out = _tiny.run(tiny_root, cell, patch=fault, seconds=3.0)
    assert out["correct"] is False
    assert out["checks"][check]["value"] > out["checks"][check]["limit"]


def test_no_card_no_result(tiny_root):
    """Without CUDA the command exits non-zero and prints no result."""
    p = subprocess.run([sys.executable, "-m", "benchmark.run",
                        "--workload", "heuristic-c4-1080p", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=tiny_root, capture_output=True, text=True,
                       timeout=120, env=dict(os.environ,
                                             CUDA_VISIBLE_DEVICES=""))
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_forbidden_modules_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "avd_tpu_torch_fake", object())
    assert "avd_tpu_torch_fake" not in run_mod.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", object())
    assert "jaxlib" in run_mod.forbidden_modules()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_heuristic_cell_on_the_card(card):
    p = subprocess.run([sys.executable, "-m", "benchmark.run",
                        "--workload", "heuristic-c4-1080p",
                        "--seed", str(2 ** 31 + 11), "--seconds", "5",
                        "--trace", "0"],
                       cwd=_tiny.REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"


def test_tiny_training_cell_is_correct(tiny_root):
    out = _tiny.run(tiny_root, "vit-full-train-b64")
    assert out["correct"] is True, out["checks"]
    # the card's time a step is the end-to-end metric; no card here
    assert set(out["metrics"]) == {"setup_s"}
    assert out["attempted"] > 0


def test_training_control_is_not_correct(tiny_root):
    """The control: the float32 reference's steps with every product's
    operands and the residual stream in float8, in the program's place."""
    out = _tiny.run(tiny_root, "vit-full-train-b64", control=True)
    assert out["correct"] is False


_UNCHANGED = """
from avd_tpu_torch.models import optim
optim.AdamW._adamw = lambda self, leaves, grads, state: state.update(
    mu=[g.float() * (1 - self.b1) for g in grads], count=state["count"] + 1)
"""

_HALF_BATCH = """
from avd_tpu_torch.models import detector
_loss = detector.loss_fn
def _half(params, frames, labels, cfg, **kw):
    k = max(1, frames.shape[0] // 2)
    return _loss(params, frames[:k], labels[:k], cfg, **kw)
detector.loss_fn = _half
"""

_LOSS_ALTERED = """
from avd_tpu_torch.models import detector
_bce = detector._bce
detector._bce = lambda z, labels: _bce(z, labels) * 1.05
"""


@pytest.mark.parametrize("fault", [_UNCHANGED, _HALF_BATCH, _LOSS_ALTERED],
                         ids=["state-unchanged", "half-the-batch",
                              "answer-altered"])
def test_planted_training_fault_is_not_correct(tiny_root, fault):
    """Each fault fails at least one of the cell's numbers."""
    out = _tiny.run(tiny_root, "vit-full-train-b64", patch=fault)
    assert out["correct"] is False
    assert any(c["value"] > c["limit"] for c in out["checks"].values())
