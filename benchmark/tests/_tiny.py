"""A copy of the benchmark at a size the CPU holds, for the tests: the
same files, with tiny configuration and traffic files added beside the
real ones, driven through ``run.execute(..., device="cpu")`` in a fresh
process (the run sets the program's environment)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)

TINY_MODEL = {"image_size": 32, "patch": 16, "width": 64, "heads": 2,
              "mlp": 128, "depth": 2}
TINY_STEPS = {"batch": 8, "pool": 32, "max_steps": 64, "warm_steps": 1}
TINY_TRAFFIC = {"clients": 2, "height": 72, "width": 128, "pool_frames": 10,
                "clip_frames": [3, 6], "length_grid": 4, "warm_frames": [3, 6]}


def make(root: str) -> str:
    """``root`` becomes a checkout: the benchmark's folder, the program
    linked beside it, and a ``BENCHMARK.json`` whose serving cells run the
    tiny configuration and traffic.  Returns ``root``."""
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(REPO, "avd_tpu_torch"),
               os.path.join(root, "avd_tpu_torch"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        spec = json.load(f)
    for c in spec["configs"]:
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        cfg["env"]["AVD_VIDEO_CHUNK"] = "4"
        c["file"] = c["file"].replace(".json", "-tiny.json")
        with open(os.path.join(root, c["file"]), "w") as f:
            json.dump(cfg, f)
    traffic = os.path.join(root, "benchmark", "traffic")
    for w in spec["workloads"]:
        if w["name"].endswith("-train-b64"):
            with open(os.path.join(root, "benchmark", "configs",
                                   w["config"] + "-tiny.json")) as f:
                cfg = json.load(f)
            cfg["detector"].update(TINY_MODEL)
            cfg["name"] = w["config"] = "tiny-train"
            with open(os.path.join(root, "benchmark", "configs",
                                   "tiny-train.json"), "w") as f:
                json.dump(cfg, f)
            spec["configs"].append({
                "name": "tiny-train", "source": "test", "reduced": [],
                "file": "benchmark/configs/tiny-train.json", "why": "test"})
        with open(os.path.join(traffic, w["traffic"] + ".json")) as f:
            tr = json.load(f)
        if tr["kind"] == "closed_loop_clips":
            tr.update(TINY_TRAFFIC)
        else:
            tr.update(TINY_STEPS)
        w["traffic"] += "-tiny"
        with open(os.path.join(traffic, w["traffic"] + ".json"), "w") as f:
            json.dump(tr, f)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    return root


def run(root: str, cell: str, seconds: float = 2.0, control: bool = False,
        trace: bool = False, seed: int = 2 ** 31 + 7, patch: str = "",
        timeout: float = 300) -> dict:
    """One run of ``cell`` on the CPU in a fresh process under ``root``,
    after ``patch`` (Python source run first, to break the program under
    the harness); returns the result line's object."""
    code = (f"{patch}\n"
            "import json\n"
            "from benchmark import run\n"
            f"out = run.execute({cell!r}, {seed}, {seconds}, {trace}, "
            f"control={control}, device='cpu')\n"
            "print('RESULT ' + json.dumps(out))\n")
    env = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=timeout)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("RESULT ")]
    assert p.returncode == 0 and lines, p.stderr[-4000:]
    return json.loads(lines[-1][len("RESULT "):])
