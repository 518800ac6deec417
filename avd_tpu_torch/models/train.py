"""Detector training driver on one device.

``python -m avd_tpu_torch.models.train --steps 200 --out /path/ckpt``

Port of ``avd_tpu/models/train.py``.  It trains any detector family on
synthetic supervision by default (procedurally generated "camera-like" and
"generator-like" frames: sensor noise against over-smooth textures, the
cues the reference's heuristics key on), or on a ``real/`` + ``ai/`` media
folder with ``--data``, and writes a checkpoint directory that serving
reads unchanged (``AVD_DETECTOR_CKPT``): ``params.npz`` with
``train_meta.json`` beside it.  ``<out>.train`` holds what ``--resume``
needs (the f32 master parameters, the optimizer state, the step, the EMA
stream), since ``params.npz`` stores some leaves in bf16; ``<out>.ema``
the EMA weights.

The generators, ``synthetic_batch`` and the evaluation helpers are copies
of ``avd_tpu``'s, draw for draw, so a seed gives the same frames (cv2's
``GaussianBlur`` is the one library call in them).  The sample pool lives
on the device and each step gathers its batch there from an index vector
drawn from the per-step RNG ``(seed, 1_000_003 + step)``, so a resumed run
replays the batches of an uninterrupted one.

Everything runs on CUDA unless ``device="cpu"`` (``--device cpu``) is
given.  Pipeline parallelism, ZeRO-1 and FSDP (``--pp``, ``--pp-tp``,
``--zero1``, ``--fsdp``) belong to the parallelism slice and raise.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from avd_tpu_torch import device as device_mod
from avd_tpu_torch import models
from avd_tpu_torch.models import convert, optim
from avd_tpu_torch.models.detector import _map_tree


def _smooth(img: np.ndarray, sigma: float) -> np.ndarray:
    try:
        import cv2
        return cv2.GaussianBlur(img, (0, 0), sigma)
    except Exception:
        k = max(3, int(sigma * 4) | 1)
        kernel = np.ones(k, np.float32) / k
        for ax in (0, 1):
            img = np.apply_along_axis(
                lambda m: np.convolve(m, kernel, mode="same"), ax, img)
        return img


def _frame_blobs(rng: np.random.Generator, size: int, ai_like: bool):
    """Family A — blob scenes; AI cue = Gaussian over-smoothing + mild
    oversaturation; camera cue = crisp detail + Gaussian sensor noise +
    sharpening halo (the original round-1 generator)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.zeros((size, size, 3), np.float32)
    for _ in range(rng.integers(2, 5)):
        cx, cy = rng.random(2)
        r = 0.1 + 0.4 * rng.random()
        blob = np.exp(-(((xx - cx) ** 2 + (yy - cy) ** 2) / r ** 2))
        base += blob[..., None] * rng.random(3)
    base += (0.3 * xx * rng.random() + 0.3 * yy * rng.random())[..., None]
    base /= max(1e-6, base.max())
    detail = rng.random((size, size, 3)).astype(np.float32)
    if ai_like:
        # generator-like: heavy smoothing, weak detail, mild
        # oversaturation, near-zero sensor noise
        sigma = 1.2 + 2.0 * rng.random()
        img = _smooth(base + 0.10 * detail, sigma)
        img = np.clip(img * (1.05 + 0.15 * rng.random()), 0, 1)
        img += rng.normal(0, 0.004, img.shape).astype(np.float32)
    else:
        # camera-like: crisp detail + per-pixel sensor noise +
        # mild sharpening halo
        img = base + (0.15 + 0.2 * rng.random()) * detail
        img = np.clip(img, 0, 1)
        blur = _smooth(img, 1.0)
        img = np.clip(img + (0.3 * rng.random()) * (img - blur), 0, 1)
        img += rng.normal(0, 0.01 + 0.02 * rng.random(),
                          img.shape).astype(np.float32)
    return img


def _frame_geometric(rng: np.random.Generator, size: int, ai_like: bool):
    """Family B — hard-edged scenes (oriented stripes + rectangles);
    AI cue = BOX-filter smoothing + contrast stretch; camera cue =
    luminance detail + per-row gain jitter (rolling-shutter-like) +
    sensor noise.  Same smooth-vs-noisy concept as family A, different
    scene statistics AND different artifact parameterizations."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.zeros((size, size, 3), np.float32)
    for _ in range(rng.integers(1, 4)):
        a, b = rng.normal(0, 6, 2)
        stripe = 0.5 + 0.5 * np.sin(a * xx + b * yy
                                    + rng.random() * 6.28)
        base += (stripe > rng.random())[..., None] * rng.random(3) * 0.6
    for _ in range(rng.integers(2, 6)):
        x0, y0 = rng.integers(0, size, 2)
        w, h = rng.integers(size // 8, size // 2, 2)
        base[y0:y0 + h, x0:x0 + w] += rng.random(3) * 0.5
    base = np.clip(base / max(1e-6, base.max()), 0, 1)
    if ai_like:
        # box blur (uniform kernel — a different smoothing operator
        # than family A's Gaussian), then a contrast stretch
        k = int(rng.integers(2, 5))
        kern = np.ones(k, np.float32) / k
        img = base
        for ax in (0, 1):
            img = np.apply_along_axis(
                lambda m: np.convolve(m, kern, mode="same"), ax, img)
        lo, hi = 0.05 * rng.random(), 1.0 - 0.05 * rng.random()
        img = np.clip((img - lo) / max(1e-6, hi - lo), 0, 1)
        img += rng.normal(0, 0.003, img.shape).astype(np.float32)
    else:
        detail = rng.random((size, size, 3)).astype(np.float32)
        img = base * (0.8 + 0.2 * detail) + 0.08 * detail
        # per-row gain jitter: CMOS readout banding
        img *= (1.0 + rng.normal(0, 0.02, (size, 1, 1))
                .astype(np.float32))
        img += rng.normal(0, 0.012 + 0.015 * rng.random(),
                          img.shape).astype(np.float32)
    return img


def _frame_texture(rng: np.random.Generator, size: int, ai_like: bool):
    """Family C (HELD OUT of default training) — multi-octave value-noise
    scenes; AI cue = half-resolution nearest-neighbor upsample (GAN
    checkerboard-like grid) + smoothing; camera cue = luminance-scaled
    shot noise (Poisson-like).  Evaluating the shipped checkpoints here
    measures transfer to an unseen generator family."""
    base = np.zeros((size, size, 3), np.float32)
    for octave in (4, 8, 16):
        g = rng.random((octave, octave, 3)).astype(np.float32)
        reps = -(-size // octave)
        up = np.repeat(np.repeat(g, reps, 0), reps, 1)[:size, :size]
        base += _smooth(up, size / (octave * 3)) / octave * 4
    base = np.clip(base / max(1e-6, base.max()), 0, 1)
    if ai_like:
        half = base[::2, ::2]
        img = np.repeat(np.repeat(half, 2, 0), 2, 1)[:size, :size]
        img = _smooth(img, 0.8 + 0.8 * rng.random())
        img = np.clip(img * (1.0 + 0.1 * rng.random()), 0, 1)
        img += rng.normal(0, 0.005, img.shape).astype(np.float32)
    else:
        detail = rng.random((size, size, 3)).astype(np.float32)
        img = np.clip(base + 0.12 * detail, 0, 1)
        # shot noise: sigma grows with sqrt(luminance)
        sigma = (0.008 + 0.02 * rng.random()) * np.sqrt(
            np.clip(img, 1e-3, 1))
        img += (rng.standard_normal(img.shape) * sigma).astype(np.float32)
    return img


def _frame_cellular(rng: np.random.Generator, size: int, ai_like: bool):
    """Family D (round 4) — Voronoi cell scenes: flat irregular regions
    with hard boundaries (nearest-seed coloring + gentle shading).
    AI cue = color POSTERIZATION (the banding common to generator
    decoders) + boundary smoothing; camera cue = luminance detail +
    Gaussian noise + rare hot pixels.  Both cue parameterizations are
    distinct from families A-C (Gaussian/box smoothing, checkerboard
    upsample; sensor/row-gain/shot noise), so a model must learn the
    smooth-vs-noisy META-cue, not one family's artifact signature —
    this is the diversity that attacks the threshold-transfer problem
    (unseen-family scores clustering at the middle, BASELINE.md round 3).

    The first round-4 design gave the camera branch a directional
    MOTION-BLUR streak (realistic camera shake).  Measured
    (tools/threshold_study.py pass 1+2): every 3-family variant's
    unseen-family AUC collapsed to 0.41-0.44 — BELOW chance — even at
    3x steps, while the 2-family control held 0.69.  Blurred camera
    frames teach "smooth = camera", the exact inverse of the meta-cue
    the held-out family (and the deployment prior: generator output is
    over-smooth) rewards, and the inversion transfers.  The streak is
    removed; the family keeps its distinct identity via posterization
    banding vs hot-pixel defects."""
    k = int(rng.integers(4, 10))
    pts = rng.random((k, 2)).astype(np.float32)
    colors = rng.random((k, 3)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    d = ((yy[..., None] - pts[:, 0]) ** 2
         + (xx[..., None] - pts[:, 1]) ** 2)
    base = colors[np.argmin(d, axis=-1)]
    shade = 0.75 + 0.25 * (rng.random() * xx + rng.random() * yy)
    base = np.clip(base * shade[..., None], 0, 1)
    if ai_like:
        # posterize: quantize each channel to few levels (banding), then
        # smooth the cell boundaries
        levels = int(rng.integers(5, 10))
        img = np.floor(base * levels) / max(1, levels - 1)
        img = _smooth(np.clip(img, 0, 1), 0.6 + 0.8 * rng.random())
        img += rng.normal(0, 0.004, img.shape).astype(np.float32)
    else:
        detail = rng.random((size, size, 3)).astype(np.float32)
        img = base * (0.85 + 0.15 * detail) + 0.10 * detail
        img += rng.normal(0, 0.010 + 0.015 * rng.random(),
                          img.shape).astype(np.float32)
        # rare hot pixels (sensor defects)
        hot = rng.random((size, size)) < 3e-4
        img[hot] = 1.0
    return img


def _frame_waves(rng: np.random.Generator, size: int, ai_like: bool):
    """Family E (round 4, EVAL-ONLY second held-out family — never in
    TRAIN_FAMILIES).  The threshold-transfer recipe (3 families +
    codec aug + logit-L2, BASELINE.md round 4) was selected against ONE
    held-out family (texture); this family exists to measure whether
    that selection overfit the holdout.  Scenes: superposed smooth 2-D
    sinusoids + a radial ripple (interference patterns) — distinct from
    blob bumps, hard edges, value noise, and Voronoi cells.  Both cue
    parameterizations are new to the registry:

    * AI cue = SPECTRAL band-limiting (soft raised-cosine FFT low-pass —
      the band-limited output of a decoder, a different smoothing
      operator than Gaussian/box/checkerboard-NN/posterize) + near-zero
      noise;
    * camera cue = crisp detail + MULTIPLICATIVE speckle (gain noise)
      + additive HIGH-PASS noise (white minus its own smoothing) —
      no blur anywhere in the camera branch (the pass-1/2 lesson:
      blurred camera frames teach the inverse meta-cue and the
      inversion transfers; see _frame_cellular)."""
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    base = np.zeros((size, size), np.float32)
    for _ in range(rng.integers(3, 6)):
        a, b = rng.normal(0, 8, 2)
        base += (0.5 + 0.5 * np.sin(a * xx + b * yy
                                    + rng.random() * 6.28)) \
            * (0.3 + 0.7 * rng.random())
    cx, cy = rng.random(2)
    r = np.sqrt((xx - cx) ** 2 + (yy - cy) ** 2)
    base += 0.5 + 0.5 * np.sin(r * rng.uniform(15, 40)
                               + rng.random() * 6.28)
    base /= max(1e-6, base.max())
    mix = 0.4 + 0.6 * rng.random((1, 1, 3)).astype(np.float32)
    img = np.clip(base[..., None] * mix
                  + 0.15 * rng.random(3).astype(np.float32), 0, 1)
    if ai_like:
        # band-limit: soft raised-cosine low-pass in the frequency
        # domain (rolls off between f0 and f1 of Nyquist)
        f0 = 0.12 + 0.20 * rng.random()
        f1 = f0 + 0.10 + 0.15 * rng.random()
        fy = np.fft.fftfreq(size)[:, None]
        fx = np.fft.rfftfreq(size)[None, :]
        fr = np.sqrt(fy ** 2 + fx ** 2) / 0.5  # fraction of Nyquist
        mask = np.clip((f1 - fr) / max(1e-6, f1 - f0), 0.0, 1.0)
        mask = 0.5 - 0.5 * np.cos(np.pi * mask)  # raised cosine
        for c in range(3):
            spec = np.fft.rfft2(img[..., c]) * mask
            img[..., c] = np.fft.irfft2(spec, s=(size, size))
        img = np.clip(img * (1.0 + 0.08 * rng.random()), 0, 1)
        img += rng.normal(0, 0.004, img.shape).astype(np.float32)
    else:
        detail = rng.random((size, size, 3)).astype(np.float32)
        img = np.clip(img * (0.85 + 0.15 * detail) + 0.10 * detail, 0, 1)
        # multiplicative speckle (gain noise)
        img *= (1.0 + rng.normal(0, 0.02 + 0.02 * rng.random(),
                                 img.shape).astype(np.float32))
        # additive high-pass noise: white minus its own smoothing
        w = rng.standard_normal(img.shape).astype(np.float32)
        img += (0.010 + 0.015 * rng.random()) * (w - _smooth(w, 1.5))
    return img


# Procedural generator families (labels 1 = AI-like in all of them).
# Default TRAINING uses blobs+geometric+cellular; texture stays HELD OUT
# as the unseen-family transfer eval (tools/torch_eval_detector.py) —
# the same held-out family since round 3, so transfer numbers remain
# comparable across rounds.  waves is the EVAL-ONLY
# second holdout (never trained on by any shipped recipe): it checks
# that the transfer recipe wasn't overfit to the texture holdout.
GENERATOR_FAMILIES = {
    "blobs": _frame_blobs,
    "geometric": _frame_geometric,
    "texture": _frame_texture,
    "cellular": _frame_cellular,
    "waves": _frame_waves,
}
TRAIN_FAMILIES = ("blobs", "geometric", "cellular")
HELDOUT_FAMILY = "texture"


def synthetic_batch(rng: np.random.Generator, batch: int, size: int,
                    families=("blobs",)):
    """Procedural real-vs-AI frames (labels 1 = AI-like).

    Encodes the cues the reference's heuristics key on (video.py:51-57 —
    texture, smoothness) with enough intra-class variation that the
    classes overlap.  ``families`` picks which procedural generator
    families contribute (uniformly at random per frame); the default
    single-family call is the original round-1 behavior."""
    frames = np.empty((batch, size, size, 3), np.float32)
    labels = np.empty((batch,), np.int32)
    fams = [GENERATOR_FAMILIES[f] for f in families]
    for i in range(batch):
        ai_like = rng.random() < 0.5
        gen = fams[rng.integers(0, len(fams))]
        frames[i] = np.clip(gen(rng, size, ai_like), 0, 1)
        labels[i] = 1 if ai_like else 0
    return frames, labels


def _to_device(tree, dev):
    """A parameter tree with every leaf on ``dev`` (no copy where it is)."""
    return _map_tree(lambda _, x: x.to(dev), tree)


@torch.no_grad()
def _probs(fam, params, frames: np.ndarray, cfg, dev) -> np.ndarray:
    """Sigmoid of a family's forward on a numpy batch, as numpy; the
    per-frame families' [B, 1] and the temporal family's [B, T, 1] logits
    alike."""
    out = fam.forward(params, torch.from_numpy(frames).to(dev), cfg)
    return torch.sigmoid(out[..., 0].float()).cpu().numpy()


def evaluate(params, cfg, n: int = 512, batch: int = 64, seed: int = 999,
             fam=None, families=("blobs",), device=None):
    """Held-out synthetic eval → (accuracy, auc); ``families`` selects
    the procedural generator families the eval set draws from."""
    dev = device_mod.resolve(device)
    fam = fam or models.family("vit")
    params = _to_device(params, dev)
    rng = np.random.default_rng(seed)
    ps, ys = [], []
    for _ in range(n // batch):
        frames, labels = synthetic_batch(rng, batch, cfg.image_size,
                                         families)
        ps.append(_probs(fam, params, frames, cfg, dev))
        ys.append(labels)
    return _acc_auc(np.concatenate(ps), np.concatenate(ys))


def _acc_auc(p: np.ndarray, y: np.ndarray):
    """Accuracy at 0.5 + AUC via the rank statistic."""
    acc = float(np.mean((p > 0.5) == (y == 1)))
    order = np.argsort(p)
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, len(p) + 1)
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    auc = float((ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2)
                / max(1, n_pos * n_neg))
    return acc, auc


def evaluate_sequences(params, cfg, n: int = 64, t: int = 8,
                       batch: int = 16, seed: int = 999,
                       families=("blobs",), device=None):
    """Held-out synthetic-sequence eval for the temporal family →
    per-frame (accuracy, auc)."""
    from avd_tpu_torch.models import temporal
    dev = device_mod.resolve(device)
    params = _to_device(params, dev)
    rng = np.random.default_rng(seed)
    ps, ys = [], []
    for _ in range(max(1, n // batch)):
        frames, labels = temporal.synthetic_sequences(rng, batch, t,
                                                      cfg.image_size,
                                                      families)
        ps.append(_probs(temporal, params, frames, cfg, dev).ravel())
        ys.append(labels.ravel())
    return _acc_auc(np.concatenate(ps), np.concatenate(ys))


def augment_pool_codec(frames: np.ndarray, frac: float,
                       rng: np.random.Generator,
                       sequences: bool = False,
                       crfs: tuple = (18, 23, 28)) -> np.ndarray:
    """Run a ``frac`` fraction of the sample pool through real codec round
    trips (``ingest/codec.py``): each selected sample gets a random codec
    (H.264 twice as likely as H.265 or MPEG-4) and a CRF from ``crfs``;
    per-frame pools ride ``roundtrip_frames`` (P-frame artifacts),
    sequence pools ``roundtrip_sequences``.  Training CRFs stay at or
    below 28: a heavy CRF erases the camera frames' noise cue and teaches
    "smooth = camera" (``avd_tpu/models/train.py:353-410``).  Needs the
    libav* encoder; raises where it is missing."""
    from avd_tpu_torch.ingest import codec as codec_mod
    if frac <= 0:
        return frames
    if not codec_mod.available():
        raise RuntimeError("--aug-codec: libav* encoder unavailable")
    n = frames.shape[0]
    n_aug = int(round(n * min(1.0, frac)))
    if n_aug == 0:
        return frames
    sel = rng.choice(n, n_aug, replace=False)
    codecs = np.asarray(["libx264", "libx264", "libx265", "mpeg4"])
    pick_codec = codecs[rng.integers(0, len(codecs), n_aug)]
    train_crfs = tuple(crfs)
    pick_crf = np.asarray(train_crfs)[
        rng.integers(0, len(train_crfs), n_aug)]
    out = frames.copy()
    for cname in np.unique(pick_codec):
        for crf in np.unique(pick_crf):
            m = (pick_codec == cname) & (pick_crf == crf)
            if not m.any():
                continue
            idx = sel[m]
            if sequences:
                out[idx] = codec_mod.roundtrip_sequences(
                    frames[idx], codec=str(cname), crf=int(crf))
            else:
                out[idx] = codec_mod.roundtrip_frames(
                    frames[idx], codec=str(cname), crf=int(crf), rng=rng)
    return out


_VIDEO_EXTS = (".mp4", ".mov", ".mkv", ".avi", ".webm", ".m4v")


def _dir_batches(root: str, rng, batch: int, size: int):
    """Yield (frames, labels) from a real/ai media corpus on disk:
    ``<root>/real/`` (label 0) and ``<root>/ai/`` (label 1), each holding
    images (anything ``cv2.imread`` decodes) and videos (each draw samples
    one random frame).  Frames are resized to the model input and scaled
    to [0,1] RGB."""
    import cv2
    pools = []
    for label, sub in ((0, "real"), (1, "ai")):
        d = os.path.join(root, sub)
        files = [os.path.join(d, f) for f in sorted(os.listdir(d))] \
            if os.path.isdir(d) else []
        if not files:
            raise ValueError(f"--data {root}: no files in {sub}/ "
                             "(need non-empty real/ and ai/ folders)")
        pools.append((label, files))

    caps: dict = {}  # lazily-opened VideoCapture per clip path

    def _read(fname: str) -> np.ndarray:
        if fname.lower().endswith(_VIDEO_EXTS):
            cap = caps.get(fname)
            if cap is None:
                cap = caps[fname] = cv2.VideoCapture(fname)
            n = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            if n <= 0:
                raise ValueError(f"--data: unreadable video {fname}")
            cap.set(cv2.CAP_PROP_POS_FRAMES, int(rng.integers(0, n)))
            ok, img = cap.read()
            if not ok:  # some containers mis-report the tail count
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                ok, img = cap.read()
            if not ok:
                raise ValueError(f"--data: unreadable video {fname}")
            return img
        img = cv2.imread(fname)
        if img is None:
            raise ValueError(f"--data: unreadable image {fname}")
        return img

    while True:
        frames = np.empty((batch, size, size, 3), np.float32)
        labels = np.empty((batch,), np.int32)
        for i in range(batch):
            label, files = pools[rng.integers(0, 2)]
            img = _read(files[rng.integers(0, len(files))])
            img = cv2.resize(img, (size, size))[..., ::-1]
            frames[i] = img.astype(np.float32) / 255.0
            labels[i] = label
        yield frames, labels


def _not_here(flag: str):
    return NotImplementedError(
        f"{flag} is multi-device training, which the port does not have "
        "yet (ROADMAP.md, the parallelism queue)")


def _config(arch, image_size, width, depth, heads, experts, remat):
    """(family module, config) of a run, as ``avd_tpu`` builds them: the
    CNN's ``small`` preset at the image size, the temporal ``small`` at the
    widths, the ViT at the widths with ``experts`` and ``remat``."""
    detector = models.family(arch)
    if arch == "cnn":
        return detector, detector.make_config("small", image_size=image_size)
    if arch == "temporal":
        return detector, detector.make_config(
            "small", image_size=image_size, width=width, depth=depth,
            heads=heads)
    return detector, detector.make_config(
        "full", image_size=image_size, patch=16, width=width, depth=depth,
        heads=heads, n_experts=experts, remat=remat)


def _init_from(path: str, cfg, detector):
    """The tree of the checkpoint directory ``path`` trained at any image
    size, its positional embedding resized to ``cfg``'s grid; the source
    grid is read from the stored ``pos_emb``'s token count."""
    import dataclasses
    npz = os.path.join(path, convert.PARAMS_FILE)
    if not os.path.exists(npz):
        convert.load_checkpoint(path, cfg)  # raises the orbax / missing error
    with np.load(npz) as z:
        tok = z["pos_emb"].shape[0]
    side = int(round((tok - 1) ** 0.5))
    if side * side != tok - 1:
        raise ValueError(f"--init-from {path}: stored pos_emb has {tok} "
                         "tokens — not a square patch grid + cls")
    probe_size = side * cfg.patch
    restored = convert.load_checkpoint(
        path, dataclasses.replace(cfg, image_size=probe_size))
    params = detector.interpolate_pos_emb(restored, cfg)
    print(f"initialized from {path} (trained at {probe_size}px; "
          f"pos_emb -> {cfg.tokens} tokens)", flush=True)
    return params


def train(steps: int = 100, batch: int = 16, lr: float = 3e-4,
          out: str | None = None, data: str | None = None,
          image_size: int = 64, width: int = 256, depth: int = 4,
          heads: int = 4, log_every: int = 10, seed: int = 0,
          cache_samples: int = 8192, arch: str = "vit",
          experts: int = 0, pp_stages: int = 0, pp_tp: int = 0,
          remat: bool = False, seq_len: int = 8,
          init_from: str | None = None, families=("blobs",),
          aug_codec: float = 0.0, logit_l2: float = 0.0,
          aug_crfs: tuple = (18, 23, 28),
          resume: bool = False, save_every: int = 0,
          zero1: bool = False, fsdp: bool = False,
          warmup: int = 0, schedule: str = "const",
          schedule_horizon: int = 0,
          grad_clip: float = 0.0, accum: int = 1, ema: float = 0.0,
          device=None):
    """Train one detector family on one device → (f32 parameter tree on
    the device, per-step losses)."""
    dev = device_mod.resolve(device)
    for flag, on in (("--pp", pp_stages > 1), ("--pp-tp", pp_tp > 1),
                     ("--zero1", zero1), ("--fsdp", fsdp)):
        if on:
            raise _not_here(flag)
    if resume and init_from:
        raise ValueError("--resume and --init-from are mutually exclusive")
    if resume and not out:
        raise ValueError("--resume continues the run saved at --out")
    if arch == "temporal" and data:
        raise ValueError("--data folders are per-frame; the temporal "
                         "family trains on synthetic sequences")
    state_path = f"{out}.train" if out else None

    detector, cfg = _config(arch, image_size, width, depth, heads, experts,
                            remat)
    params = detector.init_params(seed, cfg)
    if init_from:
        if arch != "vit":
            raise ValueError("--init-from supports the ViT family")
        params = _init_from(init_from, cfg, detector)
    saved = None
    if resume:
        if not os.path.isdir(out) or not os.path.isfile(state_path or ""):
            raise ValueError(f"--resume: no checkpoint+train state at "
                             f"{out}[.train]")
        saved = torch.load(state_path, map_location=dev, weights_only=True)
        params = saved["params"]
    params = _map_tree(lambda _, x: x.detach().to(dev, torch.float32)
                          .clone(), params)
    leaves = optim.leaves_of(params)
    # with accumulation the optimizer steps every `accum` calls: the
    # cosine horizon is in optimizer steps; --schedule-horizon pins it to
    # a whole curriculum's steps across --resume phases
    optimizer = detector.make_optimizer(
        lr, steps=max(1, (schedule_horizon or steps) // max(1, accum)),
        warmup=warmup, schedule=schedule, grad_clip=grad_clip, accum=accum)
    opt_state = optimizer.init(leaves)
    step_fn = detector.make_train_step(cfg, optimizer, logit_l2=logit_l2)

    start_step = 0
    resume_ema = None
    if saved is not None:
        opt_state = saved["opt_state"]
        start_step = int(saved["step"])
        resume_ema = saved.get("ema")
        if ema > 0 and resume_ema is None:
            print("warning: saved train state has no EMA stream — "
                  "re-seeding the EMA from the restored params", flush=True)
        if ema <= 0 and resume_ema is not None:
            print("note: saved EMA stream preserved (frozen) — pass --ema "
                  "to keep updating it", flush=True)
        print(f"resumed at step {start_step} from {state_path}", flush=True)

    rng = np.random.default_rng(seed)
    batches = (_dir_batches(data, rng, batch, image_size) if data else None)

    # the host generates a few hundred synthetic frames/s: pre-generate a
    # fixed pool once and sample it (the fresh-seed eval still measures
    # generalization)
    pool = None
    if batches is None and cache_samples:
        if arch == "temporal":
            pool = detector.synthetic_sequences(
                rng, max(batch, cache_samples // seq_len), seq_len,
                image_size, families)
        else:
            pf, pl = [], []
            for _ in range(-(-cache_samples // batch)):
                f, lab = synthetic_batch(rng, batch, image_size, families)
                pf.append(f)
                pl.append(lab)
            pool = (np.concatenate(pf), np.concatenate(pl))

    if pool is not None and aug_codec > 0:
        t_aug = time.time()
        aug_rng = np.random.default_rng((seed, 77))
        pool = (augment_pool_codec(pool[0], aug_codec, aug_rng,
                                   sequences=(arch == "temporal"),
                                   crfs=tuple(aug_crfs)),
                pool[1])
        print(f"codec augmentation: {aug_codec:.0%} of the pool through "
              f"H.264/H.265/MPEG-4 round-trips at CRF {tuple(aug_crfs)} "
              f"({time.time() - t_aug:.1f}s)", flush=True)
    elif aug_codec > 0:
        raise ValueError("--aug-codec requires the sample-pool path "
                         "(--cache-samples > 0, no --data)")

    # the pool lives on the device; each step gathers its batch there
    dev_pool = None
    if pool is not None:
        dev_pool = (torch.from_numpy(pool[0]).to(dev),
                    torch.from_numpy(pool[1]).to(dev))
        pool_n = pool[0].shape[0]
        print(f"pool resident on {dev} "
              f"({pool[0].nbytes / 1e6:.0f} MB, {pool_n} samples)",
              flush=True)

    ema_params = None
    if ema > 0:
        if not 0 < ema < 1:
            raise ValueError(f"--ema decay must be in (0, 1), got {ema}")
        src = resume_ema if resume_ema is not None else params
        ema_params = _map_tree(
            lambda _, x: x.detach().to(dev, torch.float32).clone(), src)
        ema_leaves = optim.leaves_of(ema_params)

    def _save_state(at_step: int) -> None:
        if not out:
            return
        convert.save_checkpoint(out, params, cfg)
        state = {"step": at_step, "opt_state": opt_state,
                 "params": _map_tree(lambda _, x: x.detach(), params)}
        if ema_params is not None:
            state["ema"] = ema_params
            convert.save_checkpoint(out + ".ema", ema_params, cfg)
        elif resume_ema is not None:
            # a resumed run that carried an EMA stream, --ema off this
            # time: keep the stream (frozen)
            state["ema"] = resume_ema
        torch.save(state, state_path)
        with open(os.path.join(out, "train_meta.json"), "w") as f:
            json.dump({"arch": arch, "families": list(families),
                       "steps": at_step, "batch": batch, "lr": lr,
                       "image_size": image_size, "width": width,
                       "depth": depth, "heads": heads,
                       "experts": experts, "seq_len": seq_len,
                       "seed": seed,
                       "aug_codec": aug_codec, "logit_l2": logit_l2,
                       "aug_crfs": list(aug_crfs),
                       "warmup": warmup, "schedule": schedule,
                       "schedule_horizon": schedule_horizon,
                       "grad_clip": grad_clip, "accum": accum,
                       "ema": ema, "zero1": zero1, "fsdp": fsdp,
                       "init_from": init_from, "remat": remat,
                       "device": dev.type}, f)

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        # the per-step derived rng draws the pool indices: a run resumed
        # at step k replays the batches an uninterrupted run sees
        step_rng = np.random.default_rng((seed, 1_000_003 + step))
        if dev_pool is not None:
            idx = torch.from_numpy(step_rng.integers(0, pool_n, batch)).to(
                dev)
            fb = dev_pool[0].index_select(0, idx)
            lb = dev_pool[1].index_select(0, idx)
        else:
            if batches is not None:
                frames, labels = next(batches)
            elif arch == "temporal":
                frames, labels = detector.synthetic_sequences(
                    rng, batch, seq_len, image_size, families)
            else:
                frames, labels = synthetic_batch(rng, batch, image_size,
                                                 families)
            fb = torch.from_numpy(frames).to(dev)
            lb = torch.from_numpy(labels).to(dev)
        params, opt_state, loss = step_fn(params, opt_state, fb, lb)
        if ema_params is not None and (step + 1) % accum == 0:
            # decayed once per applied update, not once per mini-step
            optim.ema_update(ema_leaves, leaves, ema)
        losses.append(float(loss))
        if log_every and step % log_every == 0:
            rate = (step - start_step + 1) * batch / (time.time() - t0)
            print(f"step {step:5d}  loss {losses[-1]:.4f}  "
                  f"{rate:.1f} frames/s", flush=True)
        if save_every and (step + 1) % save_every == 0 \
                and step + 1 < steps:
            _save_state(step + 1)

    params = _map_tree(lambda _, x: x.detach(), params)

    def _eval(p):
        if arch == "temporal":
            return evaluate_sequences(p, cfg, t=seq_len, families=families,
                                      device=dev)
        return evaluate(p, cfg, fam=detector, families=families, device=dev)

    acc, auc = _eval(params)
    print(f"held-out synthetic eval: accuracy {acc:.3f}  auc {auc:.3f}",
          flush=True)
    if ema_params is not None:
        eacc, eauc = _eval(ema_params)
        print(f"EMA({ema}) eval: accuracy {eacc:.3f}  auc {eauc:.3f} "
              f"(weights at <out>.ema)", flush=True)
    if out:
        _save_state(steps)
        print(f"checkpoint written to {out} (+ {state_path} for --resume)",
              flush=True)
    return params, losses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Train a detector family")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default=None, help="checkpoint directory")
    ap.add_argument("--data", default=None,
                    help="dataset dir with real/ and ai/ media folders")
    ap.add_argument("--image-size", type=int, default=64)
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--arch", default="vit",
                    choices=("vit", "cnn", "temporal"),
                    help="model family (models/__init__.py)")
    ap.add_argument("--seq-len", type=int, default=8, dest="seq_len",
                    help="temporal family: frames per training sequence")
    ap.add_argument("--experts", type=int, default=0,
                    help="ViT only: Switch-MoE expert count (0 = dense)")
    ap.add_argument("--pp", type=int, default=0, dest="pp_stages",
                    help="pipeline-parallel stages (not in the port yet)")
    ap.add_argument("--pp-tp", type=int, default=0, dest="pp_tp",
                    help="with --pp: tensor-parallel width (not in the "
                         "port yet)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute blocks in the backward pass "
                         "(activation memory O(1) in depth; ViT only)")
    ap.add_argument("--init-from", default=None, dest="init_from",
                    help="warm-start from a checkpoint directory, "
                         "bilinearly resizing pos_emb across resolutions "
                         "(ViT only)")
    ap.add_argument("--cache-samples", type=int, default=8192,
                    dest="cache_samples",
                    help="pre-generated sample pool size")
    ap.add_argument("--aug-codec", type=float, default=0.0,
                    dest="aug_codec", metavar="FRAC",
                    help="fraction of the sample pool run through real "
                         "H.264/H.265/MPEG-4 round trips (needs libav*)")
    ap.add_argument("--aug-crfs", default="18,23,28", dest="aug_crfs",
                    metavar="CRF,CRF,...",
                    help="CRF set --aug-codec draws from")
    ap.add_argument("--logit-l2", type=float, default=0.0,
                    dest="logit_l2", metavar="COEF",
                    help="score-scale regulariser COEF*mean(z^2)")
    ap.add_argument("--warmup", type=int, default=0, metavar="K",
                    help="linear LR warmup over K steps")
    ap.add_argument("--schedule", default="const",
                    choices=("const", "cosine"),
                    help="LR schedule; cosine decays to 1%% of --lr by "
                         "the final optimizer step")
    ap.add_argument("--schedule-horizon", type=int, default=0,
                    dest="schedule_horizon", metavar="N",
                    help="cosine horizon in TOTAL steps across --resume "
                         "phases (default: this invocation's --steps)")
    ap.add_argument("--grad-clip", type=float, default=0.0,
                    dest="grad_clip", metavar="NORM",
                    help="global-norm gradient clipping (0 = off)")
    ap.add_argument("--accum", type=int, default=1, metavar="K",
                    help="average K micro-batch gradients per step")
    ap.add_argument("--ema", type=float, default=0.0, metavar="DECAY",
                    help="parameter EMA with this decay, saved to "
                         "<out>.ema")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard the parameters (not in the port yet)")
    ap.add_argument("--zero1", action="store_true",
                    help="shard the optimizer state (not in the port yet)")
    ap.add_argument("--resume", action="store_true",
                    help="continue the run saved at --out (state from "
                         "<out>.train)")
    ap.add_argument("--save-every", type=int, default=0,
                    dest="save_every", metavar="K",
                    help="checkpoint every K steps besides the end")
    ap.add_argument("--seed", type=int, default=0,
                    help="param init + data-pool RNG seed")
    ap.add_argument("--families", default="blobs",
                    help="comma-separated procedural generator families "
                         f"(available: {','.join(sorted(GENERATOR_FAMILIES))}"
                         "; 'texture' is the held-out family)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.arch == "cnn":
        ignored = [f for f, d in (("--width", 256), ("--depth", 4),
                                  ("--heads", 4), ("--experts", 0))
                   if getattr(args, f.lstrip("-")) != d]
        if args.remat:
            ignored.append("--remat")
        if ignored:
            ap.error(f"{', '.join(ignored)} only apply to --arch vit")
    if args.arch == "temporal" and (args.experts or args.remat
                                    or args.pp_stages):
        ap.error("--experts/--remat/--pp only apply to --arch vit")
    _, losses = train(steps=args.steps, batch=args.batch, lr=args.lr,
                      out=args.out, data=args.data, seed=args.seed,
                      image_size=args.image_size, width=args.width,
                      depth=args.depth, heads=args.heads, arch=args.arch,
                      experts=args.experts, pp_stages=args.pp_stages,
                      pp_tp=args.pp_tp, remat=args.remat,
                      seq_len=args.seq_len, init_from=args.init_from,
                      cache_samples=args.cache_samples,
                      families=tuple(args.families.split(",")),
                      aug_codec=args.aug_codec, logit_l2=args.logit_l2,
                      aug_crfs=tuple(int(c) for c in
                                     args.aug_crfs.split(",")),
                      resume=args.resume, save_every=args.save_every,
                      zero1=args.zero1, fsdp=args.fsdp,
                      warmup=args.warmup, schedule=args.schedule,
                      schedule_horizon=args.schedule_horizon,
                      grad_clip=args.grad_clip, accum=args.accum,
                      ema=args.ema,
                      device=args.device)
    if losses:
        print(f"final loss {losses[-1]:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
