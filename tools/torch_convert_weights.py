#!/usr/bin/env python3
"""Convert a trained ViT checkpoint of ``avd_tpu`` for the PyTorch port.

    python tools/torch_convert_weights.py \
        avd_tpu/models/weights/detector_full \
        avd_tpu_torch/models/weights/detector_full [--preset full]

Restores the orbax checkpoint with ``avd_tpu.models.detector``, hands the
parameter tree as numpy arrays to
``avd_tpu_torch.models.convert.from_jax_params`` and writes
``<out>/params.npz``, with the checkpoint's ``calibration.json`` and
``train_meta.json`` copied beside it.  Point ``AVD_DETECTOR_CKPT`` at
``<out>`` (and ``AVD_DETECTOR_PRESET`` at the preset) to serve it through
the port.  Runs where jax and orbax are installed; the port itself needs
neither.  ``--preset`` defaults to the architecture recorded in the
checkpoint's ``train_meta.json`` when it names one of the presets' shapes,
else ``full``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SIDE_FILES = ("calibration.json", "train_meta.json")


def load_jax_tree(ckpt: str, preset: str):
    """The checkpoint's parameter tree as nested dicts/lists of numpy."""
    import jax
    import numpy as np

    from avd_tpu.models import detector as jdet
    cfg = jdet.make_config(preset)
    like = jdet.init_params(jax.random.PRNGKey(0), cfg)
    tree = jdet.load_checkpoint(ckpt, like)
    return jax.tree_util.tree_map(np.asarray, tree)


def guess_preset(ckpt: str) -> str:
    """The preset whose image size and width ``train_meta.json`` records."""
    from avd_tpu_torch.models import detector
    try:
        with open(os.path.join(ckpt, "train_meta.json")) as f:
            meta = json.load(f)
    except (OSError, ValueError):
        return "full"
    for name in ("small", "full"):
        cfg = detector.make_config(name)
        if all(meta.get(k) == getattr(cfg, k)
               for k in ("image_size", "width", "depth", "heads")):
            return name
    return "full"


def convert(ckpt: str, out: str, preset: str) -> str:
    from avd_tpu_torch.models import convert as tconvert
    from avd_tpu_torch.models import detector
    cfg = detector.make_config(preset)
    params = tconvert.from_jax_params(load_jax_tree(ckpt, preset), cfg)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, tconvert.PARAMS_FILE)
    tconvert.save_npz(path, params)
    for name in _SIDE_FILES:
        src = os.path.join(ckpt, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out, name))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", help="orbax checkpoint directory of avd_tpu")
    ap.add_argument("out", help="directory to write params.npz into")
    ap.add_argument("--preset", choices=("small", "full"), default=None)
    args = ap.parse_args(argv)
    preset = args.preset or guess_preset(args.ckpt)
    path = convert(args.ckpt, args.out, preset)
    print(f"wrote {path} (preset {preset})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
