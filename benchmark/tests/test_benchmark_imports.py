"""Nothing the benchmark runs loads ``jax``, ``jaxlib``, ``flax`` or the
JAX package ``avd_tpu``, compared by whole top-level module names (the
port's own name begins with the JAX package's)."""

from __future__ import annotations

import os
import subprocess
import sys

import _tiny

_CODE = r"""
import importlib, os, sys
root = os.path.join(os.getcwd(), "benchmark")
for d, _, files in os.walk(root):
    if "__pycache__" in d or os.sep + "tests" in d:
        continue
    for f in sorted(files):
        if not f.endswith(".py"):
            continue
        rel = os.path.relpath(os.path.join(d, f), os.getcwd())[:-3]
        if os.path.basename(d) == "metrics":
            from benchmark import spec
            spec.reader(f[:-3])
        else:
            mod = rel.replace(os.sep, ".").removesuffix(".__init__")
            importlib.import_module(mod)
from benchmark.drivers import closed_loop_clips  # imports the program
import avd_tpu_torch.pipeline, avd_tpu_torch.models.scoring
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_no_jax_in_the_benchmark():
    p = subprocess.run([sys.executable, "-c", _CODE], cwd=_tiny.REPO,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert p.returncode == 0, p.stderr[-3000:]
    top = set(p.stdout.split())
    assert "benchmark" in top and "avd_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "avd_tpu"}, top


def test_reference_imports_nothing_of_the_program():
    for f in os.listdir(os.path.join(_tiny.BENCH, "reference")):
        if f.endswith(".py"):
            with open(os.path.join(_tiny.BENCH, "reference", f)) as fh:
                src = fh.read()
            src = src.replace("avd_tpu_torch/models/weights", "")
            assert "avd_tpu" not in src, f
            assert "import jax" not in src
