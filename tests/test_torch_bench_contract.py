"""The port's benchmark contract (``python -m avd_tpu_torch.bench``), the
counterpart of ``tests/test_bench_contract.py``.

* ``--device cpu`` prints exactly one JSON line with ``bench.py``'s keys
  (``gpu_fps_*`` for ``tpu_fps_*``) and ``device``;
* latency mode prints one line with a valid label;
* ``make_frames`` is byte-equal to the root ``bench.py``'s (loaded by path;
  only this test imports both);
* without ``--device cpu`` on a host without CUDA the bench exits non-zero
  with ``device.resolve``'s message;
* the 1080p frame hashes that ``chip_smoke.py`` phase 36 compares on the
  card's host are this host's.

Every subprocess runs the kernels' plain versions on the CPU, with a time
limit of its own.
"""

import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest

from avd_tpu_torch import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

KEYS = {"metric", "value", "unit", "vs_baseline", "cpu_fps", "gpu_fps_reps",
        "gpu_fps_median", "gpu_fps_spread", "device_stage_fps", "device"}


def _bench(env, *args, timeout=300):
    env = {**os.environ, "OMP_NUM_THREADS": "2", **env}
    return subprocess.run(
        [sys.executable, "-m", "avd_tpu_torch.bench", *args], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=timeout)


def _one_line(proc):
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, lines
    return json.loads(lines[0])


def test_bench_emits_single_json_line():
    out = _one_line(_bench({"AVD_BENCH_FRAMES": "4",
                            "AVD_BENCH_CPU_FRAMES": "2",
                            "AVD_BENCH_REPS": "1", "AVD_VIDEO_CHUNK": "4"},
                           "--device", "cpu"))
    assert set(out) == KEYS, sorted(out)
    assert out["metric"] == "video_forensics_frames_per_sec_1080p"
    assert out["unit"] == "frames/sec/chip"
    assert out["value"] > 0
    assert out["device_stage_fps"] > 0
    assert out["cpu_fps"] > 0
    assert len(out["gpu_fps_reps"]) == 1
    assert out["gpu_fps_median"] <= out["value"]
    assert out["device"] == {"name": "cpu"}


def test_latency_mode_emits_single_json_line():
    out = _one_line(_bench({"AVD_BENCH_MODE": "latency",
                            "AVD_BENCH_RES": "720p",
                            "AVD_BENCH_CLIP_SECS": "1"}, "--device", "cpu"))
    assert out["metric"] == "analyze_latency_p50_1s_720p"
    assert out["unit"] == "seconds"
    assert out["label"] in ("real", "ai", "uncertain")
    assert out["value"] > 0 and len(out["seconds"]) == bench.LATENCY_REPS
    assert out["device"] == {"name": "cpu"}


def _jax_bench(monkeypatch):
    """The root ``bench.py`` loaded by path at 720p (it reads its
    resolution at import)."""
    monkeypatch.setenv("AVD_BENCH_RES", "720p")
    spec = importlib.util.spec_from_file_location(
        "root_bench", os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("content", bench.CONTENTS)
def test_frames_byte_equal_to_bench_py(content, monkeypatch):
    ref = _jax_bench(monkeypatch)
    monkeypatch.setenv("AVD_BENCH_CONTENT", content)
    want = ref.make_frames(3)
    got = bench.make_frames(3)
    assert got.shape == want.shape == (3, 720, 1280, 3)
    assert got.dtype == want.dtype == "uint8"
    assert got.tobytes() == want.tobytes()


def test_unknown_content_raises():
    with pytest.raises(ValueError, match="AVD_BENCH_CONTENT"):
        bench.make_frames(1, "720p", "checkerboard")


def test_bench_without_cuda_exits_nonzero():
    proc = _bench({"CUDA_VISIBLE_DEVICES": "", "AVD_BENCH_FRAMES": "4"},
                  timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA is not available; pass device='cpu'" in proc.stderr


@pytest.mark.parametrize("content", bench.CONTENTS)
def test_frame_hashes_recorded_for_the_card_host(content):
    import chip_smoke
    frames = bench.make_frames(chip_smoke.FRAME_HASH_N, "1080p", content)
    assert hashlib.sha256(frames.tobytes()).hexdigest() \
        == chip_smoke.BENCH_FRAME_SHA256[content]
