"""Carry the JAX package's trained detector weights into the port.

``from_jax_params`` takes a JAX parameter tree of any detector family as
nested dicts and lists of numpy arrays (each family's ``param_shapes``
names the keys: the ViT and its mixture-of-experts presets, the CNN, the
temporal transformer) and returns the port's tree: the same keys and
layouts, as f32 torch tensors on the CPU, every shape checked against the
config.  ``save_npz`` / ``load_npz`` store a tree as one flat ``.npz``
(``layers.3.qkv_w``, ``stages.1.blocks.0.dw_w`` style names);
``save_checkpoint`` / ``load_checkpoint`` write and read a checkpoint
directory (``params.npz``, beside which the trainer puts
``train_meta.json`` and the eval tool ``calibration.json``).

A leaf that every served mode reads in bf16 (the family's
``stored_bf16``) is stored as its bf16 bit patterns (uint16), the rest as
f32, so each mode reads exactly what it would read from the f32 tree.
That keeps in f32 every leaf the int8 forward quantizes or adds in f32
(all of a dense ViT; the CNN but its depthwise kernels) and the embedding
leaves an MoE router reads in f32.  This module imports numpy and torch
only; ``tools/torch_convert_weights.py`` is the script that reads an orbax
checkpoint with the JAX package and writes the ``.npz``.
"""

from __future__ import annotations

import os
from typing import Any, Dict

import numpy as np
import torch

from avd_tpu_torch.models import cnn, detector, temporal

PARAMS_FILE = "params.npz"


def family_of(cfg):
    """The family module of a config."""
    for mod in (detector, cnn, temporal):
        if isinstance(cfg, mod.Config):
            return mod
    raise TypeError(f"not a detector config: {cfg!r}")


def stored_bf16(cfg):
    """Names of the leaves a checkpoint of ``cfg`` stores as bf16."""
    return family_of(cfg).stored_bf16(cfg)


def _leaf(name: str, value, shape) -> torch.Tensor:
    arr = np.array(value, dtype=np.float32)  # a writable copy
    if arr.shape != tuple(shape):
        raise ValueError(f"{name}: shape {arr.shape}, the config wants "
                         f"{tuple(shape)}")
    return torch.from_numpy(arr)


def _walk(tree, shapes, path: str):
    """``tree`` as f32 tensors in the layout of ``shapes``: the same keys,
    the same list lengths, every leaf's shape."""
    if isinstance(shapes, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{path or 'the tree'}: not a dict")
        missing = sorted(set(shapes) - set(tree))
        extra = sorted(set(tree) - set(shapes))
        if missing or extra:
            raise ValueError(f"{path or 'the tree'}: missing keys {missing}"
                             f", unexpected keys {extra}")
        return {k: _walk(tree[k], shapes[k], f"{path}{k}.") if
                isinstance(shapes[k], (dict, list)) else
                _leaf(f"{path}{k}", tree[k], shapes[k]) for k in shapes}
    if len(tree) != len(shapes):
        what = "layers" if path.rstrip(".") == "layers" else \
            f"entries in {path.rstrip('.')}"
        raise ValueError(f"{len(tree)} {what}, the config wants "
                         f"{len(shapes)}")
    return [_walk(t, s, f"{path}{i}.")
            for i, (t, s) in enumerate(zip(tree, shapes))]


def from_jax_params(tree: Dict[str, Any], cfg,
                    what: str = "the tree") -> Dict[str, Any]:
    """JAX parameter tree (numpy leaves) → the port's f32 tree; ``what``
    names the source in errors."""
    fam = family_of(cfg)
    if fam is temporal:
        temporal.check_template(tree, cfg, what)
    return _walk(tree, fam.param_shapes(cfg), "")


def _stored(name: str, value: torch.Tensor, bf16) -> np.ndarray:
    """A leaf as written: bf16 bit patterns (uint16) for ``bf16`` names,
    f32 for the rest."""
    value = value.detach().cpu()
    if name in bf16:
        return value.to(torch.bfloat16).view(torch.int16).numpy() \
            .view(np.uint16)
    return value.float().numpy()


def _loaded(value: np.ndarray) -> np.ndarray:
    """A stored leaf as f32 (bf16 bit patterns widened exactly)."""
    if value.dtype == np.uint16:
        return (value.astype(np.uint32) << 16).view(np.float32)
    return value


def _flatten(tree, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        elif isinstance(v, list):
            for i, x in enumerate(v):
                yield from _flatten(x, f"{prefix}{k}.{i}.")
        else:
            yield f"{prefix}{k}", k, v


def save_npz(path: str, params: Dict[str, Any], cfg) -> None:
    """Write a parameter tree as one flat ``.npz``."""
    bf16 = stored_bf16(cfg)
    np.savez(path, **{name: _stored(key, v, bf16)
                      for name, key, v in _flatten(params)})


def _insert(tree, parts, value):
    """Put ``value`` at the dotted path ``parts``; a numeric part is an
    index into a list."""
    head, rest = parts[0], parts[1:]
    if not rest:
        tree[head] = value
        return
    nxt_is_index = rest[0].isdigit()
    if head.isdigit():
        i = int(head)
        while len(tree) <= i:
            tree.append(None)
        if tree[i] is None:
            tree[i] = [] if nxt_is_index else {}
        _insert(tree[i], rest, value)
    else:
        tree.setdefault(head, [] if nxt_is_index else {})
        _insert(tree[head], rest, value)


def load_npz(path: str, cfg) -> Dict[str, Any]:
    """Read a tree written by ``save_npz`` and check it against ``cfg``."""
    tree: Dict[str, Any] = {}
    with np.load(path) as z:
        for name in z.files:
            _insert(tree, name.split("."), _loaded(z[name]))
    return from_jax_params(tree, cfg, path)


def save_checkpoint(ckpt: str, params: Dict[str, Any], cfg) -> None:
    """Write ``params`` as the checkpoint directory ``ckpt``."""
    os.makedirs(ckpt, exist_ok=True)
    save_npz(os.path.join(ckpt, PARAMS_FILE), params, cfg)


def load_checkpoint(ckpt: str, cfg) -> Dict[str, Any]:
    """The f32 tree of the checkpoint directory ``ckpt``; an orbax
    directory of ``avd_tpu`` raises, naming the converter."""
    path = os.path.join(ckpt, PARAMS_FILE)
    if not os.path.exists(path) and os.path.exists(
            os.path.join(ckpt, "_CHECKPOINT_METADATA")):
        raise ValueError(
            f"{ckpt} is an orbax checkpoint of avd_tpu; convert it for the "
            "port with tools/torch_convert_weights.py and point "
            "AVD_DETECTOR_CKPT at the output directory")
    return load_npz(path, cfg)
