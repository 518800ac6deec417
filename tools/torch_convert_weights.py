#!/usr/bin/env python3
"""Convert a trained detector checkpoint of ``avd_tpu`` for the PyTorch port.

    python tools/torch_convert_weights.py \
        avd_tpu/models/weights/detector_full \
        avd_tpu_torch/models/weights/detector_full \
        [--arch vit|cnn|temporal] [--preset full|small|moe_small]

Restores the orbax checkpoint with the family's own ``load_checkpoint`` in
``avd_tpu.models`` (the temporal one raises its one-line error for a
checkpoint of the old template), hands the parameter tree as numpy arrays
to ``avd_tpu_torch.models.convert.from_jax_params`` and writes
``<out>/params.npz``, with the checkpoint's ``calibration.json`` and
``train_meta.json`` copied beside it.  Point ``AVD_DETECTOR_CKPT`` at
``<out>`` (with ``AVD_DETECTOR_ARCH`` and ``AVD_DETECTOR_PRESET``) to
serve it through the port.  Runs where jax and orbax are installed; the
port itself needs neither.  ``--arch`` and ``--preset`` default to what
the checkpoint's ``train_meta.json`` records: its ``arch`` (else ``vit``)
and the preset whose shape it names (else the family's default).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_SIDE_FILES = ("calibration.json", "train_meta.json")
ARCHES = ("vit", "cnn", "temporal")
# each family's default preset (avd_tpu/models/*.py::make_config)
_DEFAULT_PRESET = {"vit": "full", "cnn": "small", "temporal": "small"}
# train_meta.json keys that name a preset's shape, and the config field
# each is, per family (the trainer records the ViT's width, depth and heads
# for every family; only the ViT reads them)
_SHAPE_KEYS = {"vit": {"image_size": "image_size", "width": "width",
                       "depth": "depth", "heads": "heads",
                       "experts": "n_experts"},
               "cnn": {"image_size": "image_size"},
               "temporal": {"image_size": "image_size"}}


def load_jax_tree(ckpt: str, arch: str, preset: str):
    """The checkpoint's parameter tree as nested dicts/lists of numpy."""
    import jax
    import numpy as np

    from avd_tpu import models as jmodels
    fam = jmodels.family(arch)
    like = fam.init_params(jax.random.PRNGKey(0), fam.make_config(preset))
    tree = fam.load_checkpoint(ckpt, like)
    return jax.tree_util.tree_map(np.asarray, tree)


def _meta(ckpt: str) -> dict:
    try:
        with open(os.path.join(ckpt, "train_meta.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def guess_arch(ckpt: str) -> str:
    """The family ``train_meta.json`` records, else ``vit``."""
    arch = _meta(ckpt).get("arch", "vit")
    return arch if arch in ARCHES else "vit"


def guess_preset(ckpt: str, arch: str = "vit") -> str:
    """The preset whose shape ``train_meta.json`` records, else the
    family's default."""
    from avd_tpu_torch import models
    fam = models.family(arch)
    meta = _meta(ckpt)
    keys = {k: f for k, f in _SHAPE_KEYS[arch].items() if k in meta}
    for name in fam.PRESETS:
        cfg = fam.make_config(name)
        if keys and all(meta[k] == getattr(cfg, f) for k, f in keys.items()):
            return name
    return _DEFAULT_PRESET[arch]


def convert(ckpt: str, out: str, arch: str, preset: str) -> str:
    from avd_tpu_torch import models
    from avd_tpu_torch.models import convert as tconvert
    cfg = models.family(arch).make_config(preset)
    params = tconvert.from_jax_params(load_jax_tree(ckpt, arch, preset), cfg,
                                      ckpt)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, tconvert.PARAMS_FILE)
    tconvert.save_npz(path, params, cfg)
    for name in _SIDE_FILES:
        src = os.path.join(ckpt, name)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out, name))
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt", help="orbax checkpoint directory of avd_tpu")
    ap.add_argument("out", help="directory to write params.npz into")
    ap.add_argument("--arch", choices=ARCHES, default=None)
    ap.add_argument("--preset", choices=("small", "full", "moe_small"),
                    default=None)
    args = ap.parse_args(argv)
    arch = args.arch or guess_arch(args.ckpt)
    preset = args.preset or guess_preset(args.ckpt, arch)
    path = convert(args.ckpt, args.out, arch, preset)
    print(f"wrote {path} (arch {arch}, preset {preset})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
