"""Ahead-of-time detector export: self-contained serving programs.

Port of ``avd_tpu/models/export.py`` on ``torch.export``.  A serving tier
that loads a version-pinned program with the weights in it runs no model
code and no checkpoint I/O at boot, and cannot drift from the code that
produced the weights.  ``export_detector`` traces the serving computation
of ``scoring._bundle`` (the family's forward, then the sigmoid at the
checkpoint's calibration temperature) at one fixed shape, with the f32
parameter tree and the temperature inside, and saves it as
``program.pt2`` beside a JSON manifest (architecture, preset, shapes,
provenance, sha256).  ``load_bundle`` checks the manifest and the digest,
loads the program onto the serving device and serves it behind the
scoring contract; ``AVD_DETECTOR_EXPORTED=<dir>`` selects it.

Per-frame families export one batch shape (the scoring path chunks and
pads to it; scores are per frame, so grouping changes nothing); the
temporal family exports its masked scoring window, the number of real
frames a 0-d int tensor.  The program is the plain path: the attention
kernel (``AVD_ATTN_FUSED``) and the int8 forward are not traced.  It is
traced on one device (``device``, default CUDA) and may be served on any
of ``devices``: ``torch.export.passes.move_to_device_pass`` moves it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import os
import warnings
from typing import Optional, Sequence

import torch

from avd_tpu_torch import device as device_mod
from avd_tpu_torch import models
from avd_tpu_torch.models import convert, optim
from avd_tpu_torch.models.detector import _map_tree

PROGRAM_FILE = "program.pt2"
MANIFEST_FILE = "manifest.json"
FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True)
class _ExportedConfig:
    """Minimal config for the scoring contract (``input_size()``)."""
    image_size: int


def _ckpt_temperature(ckpt: Optional[str]) -> float:
    """The checkpoint's own calibration temperature (``calibration.json``),
    else 1.  Never ``AVD_DETECTOR_TEMP``: a serving knob left set in the
    exporting shell would otherwise be frozen into the artifact."""
    if ckpt:
        try:
            with open(os.path.join(ckpt, "calibration.json")) as f:
                t = float(json.load(f)["temperature"])
            if t > 0:
                return t
        except (OSError, ValueError, KeyError):
            pass
    return 1.0


def _build(arch: str, preset: Optional[str], ckpt: Optional[str],
           config_overrides: Optional[dict] = None):
    """``scoring._bundle``'s model for (arch, preset, ckpt), without the
    environment: ``ckpt="auto"`` is the shipped checkpoint of (arch,
    preset), ``None`` seeded weights."""
    from avd_tpu_torch.models import scoring

    family = models.family(arch)
    preset = preset or scoring._default_preset(arch)
    cfg = family.make_config(preset, **(config_overrides or {}))
    if getattr(cfg, "fused_attn", False):
        raise ValueError("exported programs are the plain path; "
                         "fused_attn cannot be exported")
    params = family.init_params(0, cfg)
    if ckpt == "auto":
        ckpt = scoring._shipped_ckpt(arch, preset)
    source = "random_init"
    if ckpt:
        params = convert.load_checkpoint(ckpt, cfg)
        source = ckpt
    temp = _ckpt_temperature(ckpt)
    if os.getenv("AVD_DETECTOR_TEMP"):
        warnings.warn(
            f"AVD_DETECTOR_TEMP={os.environ['AVD_DETECTOR_TEMP']!r} is set "
            f"but IGNORED by export — artifacts bake the checkpoint's own "
            f"calibration (T={temp}); set it on the serving side instead",
            stacklevel=2)
    return family, cfg, preset, params, temp, source


class _Program(torch.nn.Module):
    """The serving computation over the f32 tree held as buffers:
    ``frames [B, S, S, 3] → probs [B]``, or for the temporal family
    ``(frames [W, S, S, 3], n_valid) → probs [W]`` with frames past
    ``n_valid`` masked out of attention."""

    def __init__(self, family, cfg, params, temp: float):
        super().__init__()
        self.family, self.cfg, self.temp = family, cfg, temp
        self.clip = hasattr(family, "forward_clip")
        self._template = _map_tree(lambda _, x: None, params)
        for i, leaf in enumerate(optim.leaves_of(params)):
            self.register_buffer(f"w{i}", leaf.detach().float().contiguous())

    def _params(self):
        it = iter(self.w(i) for i in range(len(self._buffers)))
        return _map_tree(lambda _, __: next(it), self._template)

    def w(self, i: int) -> torch.Tensor:
        return self._buffers[f"w{i}"]

    def forward(self, frames: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None):
        params = self._params()
        if self.clip:
            mask = torch.arange(frames.shape[0],
                                device=frames.device) < n_valid
            logits = self.family.forward_clip(params, frames, self.cfg,
                                              mask=mask)
        else:
            logits = self.family.forward(params, frames, self.cfg)
        return torch.sigmoid(logits[:, 0].float() / self.temp)


def export_detector(out_dir: str,
                    arch: str = "vit",
                    preset: Optional[str] = None,
                    ckpt: Optional[str] = "auto",
                    batch: int = 64,
                    window: int = 32,
                    devices: Sequence[str] = ("cpu", "cuda"),
                    config_overrides: Optional[dict] = None,
                    device=None) -> dict:
    """Export the serving computation of (arch, preset, ckpt) to
    ``out_dir``, traced on ``device`` (default CUDA), and return the
    manifest.  Per-frame families: ``f32[batch, S, S, 3] → f32[batch]``;
    the temporal family: ``(f32[window, S, S, 3], int64[]) →
    f32[window]``."""
    dev = device_mod.resolve(device)
    devices = tuple(devices)
    if dev.type not in devices:
        raise ValueError(f"tracing on {dev.type}, which devices={devices} "
                         "does not list")
    family, cfg, preset, params, temp, source = _build(
        arch, preset, ckpt, config_overrides)
    program = _Program(family, cfg, params, temp).to(dev)
    size = cfg.image_size
    if program.clip:
        args = (torch.zeros((window, size, size, 3), device=dev),
                torch.tensor(window, dtype=torch.int64, device=dev))
        shape = {"window": window}
    else:
        args = (torch.zeros((batch, size, size, 3), device=dev),)
        shape = {"batch": batch}
    exported = torch.export.export(program, args, strict=False)
    exported.example_inputs = None  # else the archive keeps the zero batch
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, PROGRAM_FILE), "wb") as f:
        f.write(blob)
    manifest = {
        "format_version": FORMAT_VERSION,
        "arch": arch,
        "preset": preset,
        "image_size": size,
        **shape,
        "temperature": temp,
        "source": source,
        "devices": list(devices),
        "traced_on": dev.type,
        "torch_version": torch.__version__,
        "program_sha256": hashlib.sha256(blob).hexdigest(),
        "program_bytes": len(blob),
    }
    with open(os.path.join(out_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def load_bundle(out_dir: str, device=None):
    """Load an exported artifact onto ``device`` (default CUDA) and adapt
    it to the scoring contract: ``(cfg, None, probs, source)`` like
    ``scoring._bundle``, the weights inside the program.  Per-frame
    programs carry ``probs.fixed_batch``, temporal ones
    ``probs.clip_window``.  A wrong format version, a digest that does not
    match the manifest or a device the manifest does not list raises."""
    from torch.export import passes

    dev = device_mod.resolve(device)
    with open(os.path.join(out_dir, MANIFEST_FILE)) as f:
        manifest = json.load(f)
    if manifest.get("format_version") != FORMAT_VERSION:
        raise ValueError(
            f"exported-detector format {manifest.get('format_version')!r} "
            f"!= supported {FORMAT_VERSION} ({out_dir})")
    with open(os.path.join(out_dir, PROGRAM_FILE), "rb") as f:
        blob = f.read()
    digest = hashlib.sha256(blob).hexdigest()
    if digest != manifest["program_sha256"]:
        raise ValueError(f"exported program sha256 mismatch in {out_dir}: "
                         f"manifest {manifest['program_sha256'][:12]}… != "
                         f"file {digest[:12]}…")
    if dev.type not in manifest["devices"]:
        raise ValueError(f"{out_dir} was exported for {manifest['devices']}"
                         f", not {dev.type}")
    exported = torch.export.load(io.BytesIO(blob))
    if manifest["traced_on"] != dev.type:
        exported = passes.move_to_device_pass(exported, str(dev))
    call = exported.module()

    cfg = _ExportedConfig(image_size=int(manifest["image_size"]))
    source = f"exported:{manifest['source']}"
    if manifest["temperature"] != 1.0:
        source += f"+T{manifest['temperature']:.2f}"

    if "window" in manifest:
        @torch.no_grad()
        def probs(frames_f32: torch.Tensor, n_valid: int) -> torch.Tensor:
            return call(frames_f32, torch.tensor(n_valid, dtype=torch.int64,
                                                 device=frames_f32.device))

        probs.clip_window = int(manifest["window"])
    else:
        @torch.no_grad()
        def probs(frames_f32: torch.Tensor) -> torch.Tensor:
            return call(frames_f32)

        probs.fixed_batch = int(manifest["batch"])
    return cfg, None, probs, source


def main(argv=None) -> int:
    """``python -m avd_tpu_torch.models.export``: export a checkpoint to a
    serving artifact; serve it with ``AVD_DETECTOR=1
    AVD_DETECTOR_EXPORTED=<out>``."""
    import argparse

    ap = argparse.ArgumentParser(
        description="Export a detector checkpoint to a self-contained "
                    "serving artifact (torch.export)")
    ap.add_argument("--out", required=True, help="artifact directory")
    ap.add_argument("--arch", default="vit",
                    choices=("vit", "cnn", "temporal"))
    ap.add_argument("--preset", default=None,
                    help="family preset (default: serving default)")
    ap.add_argument("--ckpt", default="auto",
                    help="checkpoint dir, 'auto' (shipped default), or "
                         "'none' for seeded weights")
    ap.add_argument("--batch", type=int, default=64,
                    help="traced batch shape (per-frame families)")
    ap.add_argument("--window", type=int, default=32,
                    help="traced scoring window (temporal family)")
    ap.add_argument("--devices", default="cpu,cuda",
                    help="comma-separated devices the artifact serves on")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="device to trace on")
    args = ap.parse_args(argv)

    manifest = export_detector(
        args.out, arch=args.arch, preset=args.preset,
        ckpt=None if args.ckpt == "none" else args.ckpt,
        batch=args.batch, window=args.window,
        devices=tuple(d.strip() for d in args.devices.split(",") if d),
        device=args.device)
    print(json.dumps(manifest, indent=1, sort_keys=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
