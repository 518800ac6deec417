"""Import hygiene and device rules of the PyTorch port (avd_tpu_torch).

* The port imports neither jax nor anything of avd_tpu (checked in a fresh
  interpreter, since this test process has both loaded).
* Entry points called without ``device`` raise when CUDA is absent: there
  is no silent CPU run (training, export and the detector tools too).
* Only ``parallel/collectives.py`` calls ``torch.distributed``'s
  collectives; a rank group asked for CUDA without it raises too.
* A kernel wrapper given CPU tensors takes its plain version and leaves the
  launch counter alone.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from avd_tpu_torch import analyze as cli
from avd_tpu_torch import device as device_mod
from avd_tpu_torch import pipeline
from avd_tpu_torch.analyzers import audio as audio_an
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.models import cnn, detector, export, scoring, temporal
from avd_tpu_torch.models import train
from avd_tpu_torch.ops import audio_features, video_features
from avd_tpu_torch.ops.kernels import attention, blur_solve, flow_iter, warp
from avd_tpu_torch.parallel import distributed, dryrun
from avd_tpu_torch.serve import app as serve_app
from avd_tpu_torch.serve import batching
from tools import torch_bench_detector, torch_eval_detector

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import avd_tpu_torch
names = ["avd_tpu_torch"] + [m.name for m in pkgutil.walk_packages(
    avd_tpu_torch.__path__, "avd_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "avd_tpu" or k.startswith("avd_tpu."))
print(len(names), bad)
assert not bad, bad
for n in ("avd_tpu_torch.models", "avd_tpu_torch.models.detector",
          "avd_tpu_torch.models.convert", "avd_tpu_torch.models.scoring",
          "avd_tpu_torch.models.cnn", "avd_tpu_torch.models.temporal",
          "avd_tpu_torch.models.quant", "avd_tpu_torch.parallel",
          "avd_tpu_torch.parallel.attention",
          "avd_tpu_torch.ops.kernels.attention",
          "avd_tpu_torch.ops.kernels.flow_iter",
          "avd_tpu_torch.analyze", "avd_tpu_torch.utils",
          "avd_tpu_torch.utils.metrics", "avd_tpu_torch.ingest.bmff",
          "avd_tpu_torch.ingest.probe", "avd_tpu_torch.ingest.audio_reader",
          "avd_tpu_torch.ingest.video_reader",
          "avd_tpu_torch.analyzers.meta", "avd_tpu_torch.analyzers.forensic",
          "avd_tpu_torch.analyzers.audio", "avd_tpu_torch.native.decode",
          "avd_tpu_torch.oracle.video_ref", "avd_tpu_torch.serve",
          "avd_tpu_torch.serve.http", "avd_tpu_torch.serve.app",
          "avd_tpu_torch.serve.batching", "avd_tpu_torch.serve.master",
          "avd_tpu_torch.client", "avd_tpu_torch.ingest.url",
          "avd_tpu_torch.models.optim", "avd_tpu_torch.models.train",
          "avd_tpu_torch.models.export", "avd_tpu_torch.ingest.codec",
          "avd_tpu_torch.ops.fusion_device",
          "avd_tpu_torch.parallel.collectives",
          "avd_tpu_torch.parallel.mesh", "avd_tpu_torch.parallel.distributed",
          "avd_tpu_torch.parallel.halo", "avd_tpu_torch.parallel.pipeline",
          "avd_tpu_torch.parallel.dryrun", "avd_tpu_torch.parallel.zero"):
    assert n in names, n
"""

# The port's tools (all but the weight converter, which reads avd_tpu's
# orbax checkpoints with jax) import neither jax nor avd_tpu, with the
# modules they call into.
_TOOLS_PROBE = r"""
import glob, importlib.util, os, sys
import avd_tpu_torch.models.export, avd_tpu_torch.models.train
tools = sorted(p for p in glob.glob("tools/torch_*.py")
               if not p.endswith("torch_convert_weights.py"))
for path in tools:
    spec = importlib.util.spec_from_file_location(
        os.path.basename(path)[:-3], path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.")
             or k == "avd_tpu" or k.startswith("avd_tpu."))
print(len(tools), bad)
assert not bad, bad
"""

# The master process forks the workers, so it must never initialize CUDA
# or torch's thread pools: it imports neither torch nor the application.
_MASTER_PROBE = r"""
import shutil, sys
from avd_tpu_torch.serve import master
mm = master.Master("cuda")
shutil.rmtree(mm.hb_dir)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("torch", "jax", "avd_tpu")
             or k in ("avd_tpu_torch.pipeline", "avd_tpu_torch.serve.app"))
print(bad)
assert not bad, bad
"""

# The analysis layers take the serving batcher as an argument: importing
# them (and running the streaming path) loads nothing of serving.
_LAYER_PROBE = r"""
import sys
import numpy as np
from avd_tpu_torch import pipeline
from avd_tpu_torch.ops import video_features
video_features.compute_features_streaming(
    iter([np.zeros((3, 32, 32, 3), np.uint8)]), device="cpu")
bad = sorted(k for k in sys.modules if k.startswith("avd_tpu_torch.serve"))
print(bad)
assert not bad, bad
"""


# Of the port's modules only parallel/collectives.py calls
# torch.distributed's collectives (the others create groups and meshes).
_COLLECTIVE_CALLS = ("all_reduce", "all_gather", "all_to_all", "broadcast",
                     "reduce_scatter", "batch_isend_irecv", "isend", "irecv",
                     "send(", "recv(", "barrier(", "P2POp")


def test_port_imports_no_jax_and_no_avd_tpu():
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    n_modules = int(r.stdout.split()[0])
    assert n_modules >= 60, r.stdout


def test_only_collectives_calls_torch_distributed_collectives():
    pkg = os.path.join(REPO, "avd_tpu_torch")
    offenders = []
    for root, _, files in os.walk(pkg):
        for name in files:
            path = os.path.join(root, name)
            if not name.endswith(".py") or path.endswith(
                    os.path.join("parallel", "collectives.py")):
                continue
            with open(path) as f:
                for i, line in enumerate(f, 1):
                    code = line.split("#")[0]
                    if "dist." in code and any(c in code.split("dist.", 1)[1]
                                               for c in _COLLECTIVE_CALLS):
                        offenders.append(f"{path}:{i}: {line.strip()}")
    assert offenders == []


def test_port_tools_import_no_jax_and_no_avd_tpu():
    r = subprocess.run([sys.executable, "-c", _TOOLS_PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert int(r.stdout.split()[0]) >= 5, r.stdout


def test_serving_master_imports_no_torch():
    r = subprocess.run([sys.executable, "-c", _MASTER_PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def test_analysis_layers_import_no_serving():
    r = subprocess.run([sys.executable, "-c", _LAYER_PROBE], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "AVD_NATIVE": "0"})
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"


def _frames():
    return np.zeros((2, 64, 64, 3), np.uint8)


def _with_env(fn, **env):
    """``fn()`` with the detector settings ``env``, the bundle rebuilt."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    scoring._bundle.cache_clear()
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        scoring._bundle.cache_clear()


_ENTRY_POINTS = {
    "resolve": lambda: device_mod.resolve(),
    "compute_features": lambda: video_features.compute_features(_frames()),
    "compute_features_streaming":
        lambda: video_features.compute_features_streaming(iter([_frames()])),
    "analyze_frames":
        lambda: video_features.analyze_frames(_frames(), 64, 64, 30.0, 1.0),
    "analyze_batch": lambda: video_an.analyze_batch(
        video_reader.FrameBatch(_frames(), 2, 30.0, 64, 64, 1.0)),
    "window_features":
        lambda: audio_features.window_features(np.zeros(16000, np.float32),
                                               16000),
    "analyze_waveform":
        lambda: audio_features.analyze_waveform(np.zeros(16000, np.float32),
                                                16000),
    "cast_for_inference": lambda: detector.cast_for_inference(
        detector.init_params(0, detector.ViTConfig(
            image_size=32, width=64, depth=1, heads=2))),
    "cnn.cast_for_inference": lambda: cnn.cast_for_inference(
        cnn.init_params(0, cnn.make_config("small"))),
    "temporal.cast_for_inference": lambda: temporal.cast_for_inference(
        temporal.init_params(0, temporal.make_config("small", depth=1,
                                                     frame_depth=1))),
    "scoring._bundle": lambda: scoring._bundle(),
    "scoring._bundle[cnn]": lambda: _with_env(scoring._bundle,
                                              AVD_DETECTOR_ARCH="cnn"),
    "scoring._bundle[temporal]": lambda: _with_env(
        scoring._bundle, AVD_DETECTOR_ARCH="temporal"),
    "scoring._bundle[moe_small]": lambda: _with_env(
        scoring._bundle, AVD_DETECTOR_PRESET="moe_small"),
    "scoring._bundle[int8]": lambda: _with_env(scoring._bundle,
                                               AVD_DETECTOR_QUANT="1"),
    "scoring.input_size": lambda: scoring.input_size(),
    "scoring._score_prepped": lambda: scoring._score_prepped(
        np.zeros((1, 224, 224, 3), np.float32)),
    "scoring.detector_timeline": lambda: scoring.detector_timeline(_frames()),
    "scoring.detector_timeline_resized":
        lambda: scoring.detector_timeline_resized(_frames()),
    "analyze_decoded": lambda: pipeline.analyze_decoded(
        video_reader.FrameBatch(_frames(), 2, 30.0, 64, 64, 1.0),
        np.zeros(16000, np.float32), 16000, {}),
    "analyze_path": lambda: pipeline.analyze_path("/nonexistent.wav"),
    "analyzers.audio.analyze":
        lambda: audio_an.analyze("/nonexistent.wav", {}),
    "analyzers.video.analyze":
        lambda: video_an.analyze("/nonexistent.mp4", {}),
    "warm_device": lambda: video_features.warm_device(),
    "scoring.clip_window": lambda: scoring.clip_window(),
    "cli": lambda: cli.main(["/nonexistent.wav"]),
    "serve.build_app": lambda: serve_app.build_app(),
    "serve.app.main": lambda: serve_app.main([]),
    "batcher.submit_prep": lambda: batching.WindowBatcher(10).submit_prep(
        np.zeros((2, 320, 320), np.uint8), np.zeros((2, 32, 32), np.uint8),
        None),
    "run_prep_windows": lambda: video_features.run_prep_windows(
        np.zeros((1, 2, 320, 320), np.uint8),
        np.zeros((1, 2, 32, 32), np.uint8), None),
    "train": lambda: train.train(steps=1, batch=2, image_size=16, width=32,
                                 depth=1, heads=2, cache_samples=2),
    "train.evaluate": lambda: train.evaluate(
        {}, detector.make_config("small"), n=0),
    "train.evaluate_sequences": lambda: train.evaluate_sequences(
        {}, temporal.make_config("small"), n=0),
    "export_detector": lambda: export.export_detector(
        "/nonexistent/artifact", ckpt=None),
    "load_bundle": lambda: export.load_bundle("/nonexistent/artifact"),
    "scoring._bundle[exported]": lambda: _with_env(
        scoring._bundle, AVD_DETECTOR_EXPORTED="/nonexistent/artifact"),
    "tools.torch_eval_detector": lambda: torch_eval_detector.eval_checkpoint(
        n=0),
    "tools.torch_bench_detector": lambda: torch_bench_detector.bench("vit"),
    "distributed.initialize": lambda: distributed.initialize(
        world_size=2, rank=0, init_method="file:///nonexistent/store"),
    "dryrun.launch": lambda: dryrun.launch(2),
    "load_checkpoint_sharded": lambda: detector.load_checkpoint_sharded(
        "/nonexistent/ckpt", detector.make_config("small"), None),
    "dryrun.run_in_process": lambda: dryrun.run_in_process(
        ["cp"], {}, dryrun.small_spec()),
}


@pytest.mark.parametrize("name", sorted(_ENTRY_POINTS))
def test_entry_point_without_device_raises_when_cuda_absent(name,
                                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("AVD_DETECTOR", "1")  # the scoring entry points run
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _ENTRY_POINTS[name]()


def test_explicit_cpu_device_runs():
    assert device_mod.resolve("cpu") == torch.device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.random((2, 5, 40, 48), np.float32))
    fl = torch.from_numpy((rng.random((2, 2, 40, 48), np.float32) - 0.5) * 6)
    m = torch.from_numpy(rng.random((2, 5, 40, 48), np.float32))
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 9, 2, 16))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))

    def counts():
        return (warp.LAUNCHES, blur_solve.LAUNCHES, flow_iter.LAUNCHES,
                attention.LAUNCHES)

    before = counts()
    out_w = warp.warp_bilinear(src, fl)
    out_b = blur_solve.box_blur_solve(m)
    out_f = flow_iter.solve_iteration(src, m, fl)
    out_a = attention.attention(q, k, v)
    assert counts() == before == (0, 0, 0, 0)
    assert torch.equal(out_w, warp.warp_bilinear_plain(src, fl))
    assert torch.equal(out_b, blur_solve.box_blur_solve_plain(m))
    assert torch.equal(out_f, flow_iter.solve_iteration_plain(src, m, fl))
    assert torch.equal(out_a, attention.attention_plain(q, k, v))
