"""Find a cell's pieces by the names in ``BENCHMARK.json``.

The benchmark's folder sits at the root of the checkout beside
``BENCHMARK.json``.  A configuration is ``configs/<name>.json`` (the file
that ``BENCHMARK.json`` names), a traffic mix ``traffic/<name>.json``
whose ``kind`` names the driver module ``drivers/<kind>.py``, and every
metric, end-to-end or per-layer, a reader ``metrics/<name>.py`` with a
function ``read(run, trace)``.  Adding any of these is adding files and
entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re
from typing import Dict, List

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
PACKAGE = os.path.basename(BENCH_DIR)


def load(root: str = ROOT) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def cell(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: Dict, name: str, root: str = ROOT) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            with open(os.path.join(root, c["file"])) as f:
                return json.load(f)
    raise KeyError(f"no config named {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    with open(os.path.join(BENCH_DIR, "traffic", f"{name}.json")) as f:
        return json.load(f)


def driver(kind: str):
    """The driver module of a traffic kind."""
    return importlib.import_module(f"{PACKAGE}.drivers.{kind}")


def reader(metric: str):
    """``read(run, trace)`` of ``metrics/<metric>.py`` (names may hold
    dots, so the file is loaded by path)."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    mod_name = f"{PACKAGE}.metrics._" + re.sub(r"[.-]", "_", metric)
    s = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def metrics_of(spec: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
    that list it under ``workloads``, and those without the key (a
    per-layer one only where the cell reports the metric it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if cell_name in m.get("workloads", [cell_name])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell_name in m.get("workloads", [cell_name])
            and m["moves"] in names]
