"""Detector → analyzer integration (the neural scoring slot).

Port of ``avd_tpu/models/scoring.py`` for every detector family on one
device:

* ``AVD_DETECTOR=1`` attaches ``video["detector"] = {"timeline": [...],
  "weights": ...}`` (per-sampled-frame AI probabilities) to the video
  analyzer's output;
* ``AVD_DETECTOR_BLEND=x`` (0..1) blends the detector probability into
  ``timeline_ai`` (0 keeps the pure heuristic);
* ``AVD_DETECTOR_ARCH`` picks the family: ``vit`` (default), ``cnn`` or
  ``temporal``;
* ``AVD_DETECTOR_PRESET`` picks the config.  The default follows
  ``avd_tpu``'s rule (``_default_preset``): for the ViT ``full`` (224 px,
  width 384, depth 6) when its converted checkpoint ships in
  ``weights/``, else ``small`` when that one does, else ``full``; ``small``
  for the other families.  ``moe_small`` is the Switch-MoE ViT;
* ``AVD_DETECTOR_CKPT`` names a directory written by
  ``tools/torch_convert_weights.py`` (``params.npz`` and, beside it,
  ``calibration.json``); absent, the shipped checkpoint of (family,
  preset) serves (``weights/detector_full``, ``detector_small``,
  ``moe_small``, ``cnn_small``, ``temporal_small``), and without one the
  model runs with seeded random weights and says so (``"weights":
  "random_init"``).  An orbax directory of ``avd_tpu`` raises, naming the
  converter;
* ``AVD_DETECTOR_TEMP`` overrides the calibration temperature;
* ``AVD_ATTN_FUSED=1`` routes the ViT's attention through the hand-written
  kernel (``ops/kernels/attention.py``); other families raise, and so does
  the int8 mode with it;
* ``AVD_DETECTOR_QUANT=1`` serves the ViT or the CNN in int8 W8A8
  (``models/quant.py``; weights label ``+int8``); the temporal family
  raises, and an MoE tree raises ``quantize_params``' error;
* ``AVD_DETECTOR_ARCH=temporal`` scores the sampled frames as a sequence
  in fixed ``AVD_TEMPORAL_WINDOW`` windows (default 32), the tail padded
  with its last frame and masked out of attention, so scores do not
  depend on the clip's length and streaming slabs (``clip_window``) give
  the batch path's scores.

* ``AVD_DETECTOR_EXPORTED=<dir>`` serves an artifact of
  ``models/export.py`` (the program, its weights and temperature inside)
  and takes precedence over every setting above; a per-frame program is
  fed in chunks of its traced batch, the last one padded.  A missing or
  tampered artifact raises (the analyzers report ``detector_error``).

In a rank group (``parallel/distributed.initialize``, more than one
rank) the per-frame families score sharded, as ``avd_tpu`` does over
its devices (``avd_tpu/models/scoring.py:211-243``): a (data, model) mesh
over every rank, each rank its parameter shards, its slice of the bucket
(a power of two times the data axis), and every rank gets every
probability.  ``AVD_ATTN_FUSED=1`` is turned off there with
``avd_tpu``'s warning (the sharded block keeps the einsum attention);
``AVD_DETECTOR_QUANT=1`` serves on each rank alone, with its warning;
the temporal family serves on each rank alone, as in ``avd_tpu``.  Every
rank must score the same frames.  A served group (``serve/group.py``)
scores sharded at any size, a group of one included; its leader enters
the call on every rank with the resized uint8 frames
(``detector_timeline_resized``), and its single-rank modes score on the
leader alone.

Every function that touches the model takes ``device=`` and defaults to
CUDA through ``device.resolve``: without a GPU it raises unless the caller
asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import warnings
from typing import List, Optional

import numpy as np
import torch

from avd_tpu_torch import device as device_mod
from avd_tpu_torch import models
from avd_tpu_torch.models import convert
from avd_tpu_torch.models import quant as quant_mod
from avd_tpu_torch.ops import host_prep
from avd_tpu_torch.utils.metrics import span


def enabled() -> bool:
    return os.getenv("AVD_DETECTOR", "0") == "1"


def blend_factor() -> float:
    try:
        return min(1.0, max(0.0, float(os.getenv("AVD_DETECTOR_BLEND", "0"))))
    except ValueError:
        return 0.0


def _arch() -> str:
    """Model family: 'vit' (default), 'cnn' or 'temporal'."""
    return os.getenv("AVD_DETECTOR_ARCH", "vit")


def _temperature(ckpt) -> float:
    """Post-hoc calibration temperature for the served checkpoint:
    ``AVD_DETECTOR_TEMP`` if it is a positive float, else the checkpoint's
    ``calibration.json``, else 1.  Serving divides the logits by it before
    the sigmoid; ranking is unchanged, only confidence is rescaled."""
    env = os.getenv("AVD_DETECTOR_TEMP")
    if env:
        try:
            t = float(env)
            if t > 0:
                return t
        except ValueError:
            pass
        warnings.warn(f"AVD_DETECTOR_TEMP={env!r} invalid — using the "
                      "checkpoint calibration (or 1.0)", stacklevel=2)
    if ckpt:
        try:
            with open(os.path.join(ckpt, "calibration.json")) as f:
                t = float(json.load(f)["temperature"])
            if t > 0:
                return t
        except (OSError, ValueError, KeyError):
            pass
    return 1.0


# the shipped checkpoints of avd_tpu/models/weights, converted for the port
# by tools/torch_convert_weights.py
_WEIGHTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "weights")
_SHIPPED = {("vit", "small"): "detector_small",
            ("vit", "full"): "detector_full",
            ("vit", "moe_small"): "moe_small",
            ("cnn", "small"): "cnn_small",
            ("temporal", "small"): "temporal_small"}


def _default_preset(arch: str) -> str:
    """The trained serving-size ``full`` when its checkpoint ships, else
    the trained ``small``, else ``full`` on seeded weights; the other
    families default ``small`` (``avd_tpu/models/scoring.py:68-77``)."""
    if arch != "vit":
        return "small"
    if os.path.isdir(os.path.join(_WEIGHTS_DIR, "detector_full")):
        return "full"
    if os.path.isdir(os.path.join(_WEIGHTS_DIR, "detector_small")):
        return "small"
    return "full"


def _shipped_ckpt(arch: str, preset: str) -> Optional[str]:
    """The shipped checkpoint directory of (family, preset), if any."""
    name = _SHIPPED.get((arch, preset))
    path = os.path.join(_WEIGHTS_DIR, name) if name else None
    return path if path and os.path.isdir(path) else None


def _sigmoid(logits: torch.Tensor, temp: float) -> torch.Tensor:
    """Probabilities of a forward's [B, 1] logits at temperature ``temp``."""
    return torch.sigmoid(logits[:, 0].float() / temp)


def _bundle(device=None):
    """(config, parameters on the device, probs function, weights label)
    for the environment's detector settings, built once per device."""
    return _bundle_on(str(device_mod.resolve(device)))


@functools.lru_cache(maxsize=2)
def _bundle_on(device: str):
    dev = torch.device(device)
    exported = os.getenv("AVD_DETECTOR_EXPORTED")
    if exported:
        # the artifact carries arch, preset, weights and temperature
        from avd_tpu_torch.models import export
        return export.load_bundle(exported, dev)
    arch = _arch()
    quant = os.getenv("AVD_DETECTOR_QUANT", "0") == "1"
    fused = os.getenv("AVD_ATTN_FUSED", "0") == "1"
    if fused:
        # the attention kernel is the ViT block's; the int8 forward has its
        # own attention
        if arch != "vit":
            raise ValueError(
                f"AVD_ATTN_FUSED=1 supports the vit family, not {arch!r}")
        if quant:
            raise ValueError("AVD_ATTN_FUSED=1 and AVD_DETECTOR_QUANT=1 "
                             "are mutually exclusive (the int8 forward "
                             "has its own attention)")
    family = models.family(arch)
    preset = os.getenv("AVD_DETECTOR_PRESET", _default_preset(arch))
    cfg = family.make_config(preset)
    if fused:
        cfg = dataclasses.replace(cfg, fused_attn=True)
    ckpt = os.getenv("AVD_DETECTOR_CKPT") or _shipped_ckpt(arch, preset)
    if ckpt:
        params = convert.load_checkpoint(ckpt, cfg)
        source = ckpt
    else:
        params = family.init_params(0, cfg)
        source = "random_init"
    temp = _temperature(ckpt)
    if temp != 1.0:
        source = f"{source}+T{temp:.2f}"

    from avd_tpu_torch.parallel import distributed
    world = distributed.world_size()
    if quant:
        # silently serving bf16 while the operator believes int8 is on
        # would mislead capacity planning: fail (the analyzers report it
        # as detector_error)
        if arch not in ("vit", "cnn"):
            raise ValueError(
                f"AVD_DETECTOR_QUANT=1 supports vit/cnn, not {arch!r}")
        if world > 1:
            warnings.warn(
                "AVD_DETECTOR_QUANT=1 serves SINGLE-RANK: the int8 tree has "
                "no TP/DP specs, so the {} ranks do not share its scoring "
                "(a served group scores on its leader alone). Unset "
                "AVD_DETECTOR_QUANT to shard bf16 inference over the "
                "ranks.".format(world), stacklevel=2)
        params = quant_mod.to_device(quant_mod.quantize_params(params), dev)
        source = f"{source}+int8"

        @torch.inference_mode()
        def probs(frames_f32: torch.Tensor) -> torch.Tensor:
            return _sigmoid(quant_mod.forward(params, frames_f32.to(dev),
                                              cfg), temp)
    elif arch == "temporal":
        params = family.cast_for_inference(params, dev)

        @torch.inference_mode()
        def probs(frames_f32: torch.Tensor, n_valid: int) -> torch.Tensor:
            mask = torch.arange(frames_f32.shape[0], device=dev) < n_valid
            return _sigmoid(family.forward_clip(params, frames_f32, cfg,
                                                mask=mask), temp)

        # fixed-window scoring (avd_tpu/models/scoring.py:247-260): each
        # window of AVD_TEMPORAL_WINDOW frames (default 32, the trained
        # sequence lengths) is one forward with its padded tail masked out
        # of attention, so scores do not depend on the clip's length
        probs.clip_window = max(1, int(os.getenv("AVD_TEMPORAL_WINDOW",
                                                 "32")))
    elif distributed.spmd():
        if fused:
            warnings.warn("AVD_ATTN_FUSED=1 is single-device-only; the "
                          "sharded detector program keeps the einsum "
                          "attention", stacklevel=2)
            cfg = dataclasses.replace(cfg, fused_attn=False)
        mesh = distributed.global_mesh(("data", "model"))
        params, probs = sharded_probs(family, cfg, params, temp, mesh, dev)
    else:
        params = family.cast_for_inference(params, dev)

        @torch.inference_mode()
        def probs(frames_f32: torch.Tensor) -> torch.Tensor:
            return _sigmoid(family.forward(params, frames_f32.to(dev), cfg),
                            temp)
    return cfg, params, probs, source


def sharded_probs(family, cfg, params, temp: float, mesh, dev):
    """(this rank's shards on ``dev``, probs function) of a per-frame
    family over a (data, model) mesh: the function takes the whole bucket
    (a host tensor; each rank copies its slice to the card) and returns
    every probability on every rank.  Its ``min_batch`` is the data axis:
    ``_score_prepped`` pads buckets to a multiple of it."""
    from avd_tpu_torch.parallel import collectives
    shards = family.cast_for_inference(family.shard(mesh, params, cfg), dev)

    @torch.inference_mode()
    def probs(frames_f32: torch.Tensor) -> torch.Tensor:
        return _sigmoid(family.forward(shards, frames_f32, cfg, sharded=True,
                                       mesh=mesh), temp)

    probs.min_batch = collectives.axis_size(mesh, "data")
    return shards, probs


_bundle.cache_clear = _bundle_on.cache_clear


def sharded() -> bool:
    """Whether the environment's detector scores sharded over the rank
    group (``_bundle``'s sharded branch): a per-frame family, neither int8
    nor an exported program, in a group that runs its programs over every
    rank (``distributed.spmd``)."""
    from avd_tpu_torch.parallel import distributed
    return (distributed.spmd() and not os.getenv("AVD_DETECTOR_EXPORTED")
            and os.getenv("AVD_DETECTOR_QUANT", "0") != "1"
            and _arch() != "temporal")


def input_size(device=None) -> int:
    """Model input resolution (loads the bundle)."""
    return _bundle(device)[0].image_size


def clip_window(device=None):
    """Fixed scoring-window length of clip-based families (loads the
    bundle); None for the per-frame families, whose scores do not depend
    on grouping."""
    return getattr(_bundle(device)[2], "clip_window", None)


def resize_frames(frames_bgr: np.ndarray, size: int) -> np.ndarray:
    """[N, H, W, 3] BGR uint8 → [N, size, size, 3] BGR uint8 with cv2's
    INTER_AREA semantics (``ops/host_prep.resize_area``)."""
    return host_prep.resize_area(frames_bgr, size, size)


def _prep_frames(frames_bgr: np.ndarray, size: int) -> np.ndarray:
    """[N, H, W, 3] BGR uint8 → [N, size, size, 3] RGB f32 in [0,1]."""
    return resize_frames(frames_bgr, size)[..., ::-1].astype(np.float32) \
        / 255.0


def detector_timeline_resized(resized_bgr: np.ndarray,
                              device=None) -> Optional[dict]:
    """``detector_timeline`` for frames already resized to
    ``input_size()`` (BGR uint8).  Sharded scoring is entered on every
    rank of a served group with these frames (``distributed.run_on_group``;
    a plain call elsewhere)."""
    if not enabled() or resized_bgr.shape[0] == 0:
        return None
    return _timeline_resized(resized_bgr, device)


def _timeline_resized(resized_bgr: np.ndarray, device) -> dict:
    if sharded():
        from avd_tpu_torch.parallel import distributed
        return distributed.run_on_group(score_resized, resized_bgr,
                                        device=device)
    return score_resized(resized_bgr, device=device)


def score_resized(resized_bgr: np.ndarray, device=None) -> dict:
    """Score frames resized to ``input_size()`` (BGR uint8): flipped to
    RGB and scaled to [0, 1] here, on each rank of a served group."""
    return _score_prepped(resized_bgr, device)


def warm(device=None) -> dict:
    """Build the bundle and score one slab (``AVD_DETECTOR_SLAB``, default
    256) of black frames: a served group's warm-up call, made before the
    leader reads ``input_size``."""
    size = input_size(device)
    n = max(1, int(os.getenv("AVD_DETECTOR_SLAB", "256")))
    return score_resized(np.zeros((n, size, size, 3), np.uint8), device)


def detector_timeline(frames_bgr: np.ndarray, device=None) -> Optional[dict]:
    """Per-frame AI probabilities for a sampled-frame batch, or None when
    the detector is disabled or no frames exist."""
    if not enabled() or frames_bgr.shape[0] == 0:
        return None
    size = input_size(device)
    with span("det.resize", frames=frames_bgr.shape[0]):
        resized = resize_frames(frames_bgr, size)
    return _timeline_resized(resized, device)


def _pad(batch: np.ndarray, size: int) -> np.ndarray:
    """``batch`` with its last frame repeated up to ``size`` frames."""
    n = batch.shape[0]
    if size == n:
        return batch
    return np.concatenate([batch, np.repeat(batch[-1:], size - n, axis=0)])


def _score_prepped(resized_bgr: np.ndarray, device=None) -> dict:
    """Score a resized [N, size, size, 3] BGR uint8 batch, flipped to RGB
    and scaled to [0, 1] f32 here.  Per-frame
    families: padded to a power-of-two bucket (times the data axis when
    sharded) with the last frame repeated, one forward pass, one fetch of
    the first N probabilities; an
    exported program takes chunks of its traced batch, the last padded the
    same way.  Clip families: one forward per fixed window, the tail
    window padded the same way and its padding masked out of attention.
    Spans: ``det.stage`` (the flip, the scale and the padding; ``frames``
    and the padded ``bucket``), ``det.forward`` (the copy to the device
    and the forward's launches) and ``det.fetch``."""
    dev = device_mod.resolve(device)
    _, _, probs_fn, source = _bundle(dev)
    window = getattr(probs_fn, "clip_window", None)
    fixed = getattr(probs_fn, "fixed_batch", None)
    n = resized_bgr.shape[0]
    if window or fixed:
        size = window or fixed
        with span("det.stage", frames=n, bucket=-(-n // size) * size):
            batch = resized_bgr[..., ::-1].astype(np.float32) / 255.0
            chunks = [(min(size, n - s), np.ascontiguousarray(
                _pad(batch[s:s + size], size))) for s in range(0, n, size)]
        outs = []
        for k, chunk in chunks:
            with span("det.forward", frames=k):
                x = torch.from_numpy(chunk).to(dev)
                outs.append((probs_fn(x, k) if window else probs_fn(x))[:k])
        with span("det.fetch"):
            p = torch.cat(outs).cpu().numpy()
        return {"timeline": [float(x) for x in p], "weights": source}
    bucket = getattr(probs_fn, "min_batch", 1)
    while bucket < n:
        bucket *= 2
    with span("det.stage", frames=n, bucket=bucket):
        batch = np.ascontiguousarray(_pad(
            resized_bgr[..., ::-1].astype(np.float32) / 255.0, bucket))
    with span("det.forward", frames=n):
        p = probs_fn(torch.from_numpy(batch))
    with span("det.fetch"):
        p = p[:n].cpu().numpy()
    return {"timeline": [float(x) for x in p], "weights": source}


def blend(timeline_ai: List[float], det: List[float]) -> List[float]:
    """Convex blend of heuristic and detector per-frame scores."""
    f = blend_factor()
    if f <= 0.0 or len(timeline_ai) != len(det):
        return timeline_ai
    return [float((1.0 - f) * h + f * d)
            for h, d in zip(timeline_ai, det)]
