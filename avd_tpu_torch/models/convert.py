"""Carry the JAX package's trained ViT weights into the port.

``from_jax_params`` takes the JAX parameter tree as nested dicts and lists
of numpy arrays (``avd_tpu/models/detector.py::init_params`` names the
keys) and returns the port's tree: the same keys and the same ``[in, out]``
weight layout, as f32 torch tensors on the CPU, every shape checked against
the config.  ``save_npz`` / ``load_npz`` store a tree as one flat ``.npz``
(``layers.3.qkv_w`` style names).  The leaves the forward rounds to bf16
anyway (``detector._BF16``) are stored as their bf16 bit patterns
(uint16), the rest as f32: exact for inference, and half the bytes.
This module imports numpy and torch only; ``tools/torch_convert_weights.py``
is the script that reads an orbax checkpoint with the JAX package and
writes the ``.npz``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from avd_tpu_torch.models import detector

PARAMS_FILE = "params.npz"


def _leaf(name: str, value, shape) -> torch.Tensor:
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if arr.shape != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape}, the config wants "
                         f"{tuple(shape)}")
    return torch.from_numpy(arr)


def from_jax_params(tree: Dict[str, Any],
                    cfg: detector.ViTConfig) -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) → the port's f32 tree."""
    shapes = detector.param_shapes(cfg)
    layers = tree["layers"]
    if len(layers) != cfg.depth:
        raise ValueError(f"{len(layers)} layers, the config wants "
                         f"{cfg.depth}")
    if any("router_w" in lp for lp in layers):
        raise NotImplementedError(
            "mixture-of-experts weights are not ported yet (see ROADMAP.md)")
    out = {k: _leaf(k, tree[k], shapes[k]) for k in shapes if k != "layers"}
    out["layers"] = [{k: _leaf(f"layers.{i}.{k}", lp[k], ls[k]) for k in ls}
                     for i, (lp, ls) in enumerate(zip(layers,
                                                      shapes["layers"]))]
    return {k: out[k] for k in shapes}  # the config's key order


def _stored(name: str, value: torch.Tensor) -> np.ndarray:
    """A leaf as written: bf16 bit patterns (uint16) for the bf16
    operands of the forward pass, f32 for the rest."""
    value = value.detach().cpu()
    if name in detector._BF16:
        return value.to(torch.bfloat16).view(torch.int16).numpy() \
            .view(np.uint16)
    return value.float().numpy()


def _loaded(value: np.ndarray) -> np.ndarray:
    """A stored leaf as f32 (bf16 bit patterns widened exactly)."""
    if value.dtype == np.uint16:
        return (value.astype(np.uint32) << 16).view(np.float32)
    return value


def save_npz(path: str, params: Dict[str, Any]) -> None:
    """Write a parameter tree as one flat ``.npz``."""
    flat = {k: _stored(k, v) for k, v in params.items() if k != "layers"}
    for i, lp in enumerate(params["layers"]):
        for k, v in lp.items():
            flat[f"layers.{i}.{k}"] = _stored(k, v)
    np.savez(path, **flat)


def load_npz(path: str, cfg: detector.ViTConfig) -> Dict[str, Any]:
    """Read a tree written by ``save_npz`` and check it against ``cfg``."""
    with np.load(path) as z:
        tree: Dict[str, Any] = {"layers": [{} for _ in range(cfg.depth)]}
        for name in z.files:
            if name.startswith("layers."):
                _, i, key = name.split(".", 2)
                if int(i) >= cfg.depth:
                    raise ValueError(f"{name}: the config has {cfg.depth} "
                                     "layers")
                tree["layers"][int(i)][key] = _loaded(z[name])
            else:
                tree[name] = _loaded(z[name])
    return from_jax_params(tree, cfg)
