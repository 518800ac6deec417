"""Detector generalization / robustness / calibration eval on the port.

Port of ``tools/eval_detector.py``.  For a checkpoint directory of the
port (default: the shipped one of the family and preset) it reports:

* per-generator-family held-out accuracy and AUC, including the family no
  shipped recipe trains on (``texture``, ``models/train.HELDOUT_FAMILY``)
  and the eval-only ``waves``;
* robustness sweeps: H.264 (libx264) CRF 18/28/35/45 through
  ``ingest/codec.py`` where the libav* encoder exists, and the JPEG
  quality sweep (95/75/50/30) with cv2; the temporal family gets the codec
  sweep on whole sequences, and splice localization (per-frame accuracy
  and span IoU on partially AI clips, seen and unseen families);
* ECE (15 equal-width bins over the predicted AI probability), raw and
  after temperature scaling: a scalar T fitted by NLL on a calibration
  draw from the training families only (clean, plus H.264 CRF 28 or, with
  no encoder, JPEG q50).  ``--write-calibration`` writes T and the fit's
  provenance to ``<ckpt>/calibration.json``, which the port's scoring
  serves by dividing the logits by T.

Usage:
  python tools/torch_eval_detector.py [--arch vit|cnn|temporal]
      [--preset small|full|moe_small] [--ckpt DIR] [--n 512]
      [--device cuda|cpu] [--write-calibration]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ece(p: np.ndarray, y: np.ndarray, bins: int = 15) -> float:
    """Binary reliability ECE over the predicted P(ai)."""
    edges = np.linspace(0.0, 1.0, bins + 1)
    total = len(p)
    ece = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        m = (p >= lo) & (p < hi) if hi < 1.0 else (p >= lo) & (p <= hi)
        if not m.any():
            continue
        ece += abs(float(p[m].mean()) - float((y[m] == 1).mean())) \
            * (m.sum() / total)
    return ece


def fit_temperature(logits: np.ndarray, y: np.ndarray) -> float:
    """Fit a scalar temperature T minimizing binary NLL of
    sigmoid(logit / T) — the standard post-hoc calibration (Guo et al.
    2017).  1-D golden-section search on log T; no scipy dependency.

    Constrained to T >= 1 (soften-only): when the calibration set is
    perfectly separated (these synthetic curricula often are), the
    unconstrained NLL minimizer is T -> 0 (sharpen to certainty), which
    is exactly the overconfidence calibration exists to remove; a
    boundary fit at T=1 honestly means "no reliable temperature
    signal", not "sharpen"."""
    z = logits.astype(np.float64)
    t = y.astype(np.float64)

    def nll(log_T: float) -> float:
        s = z / np.exp(log_T)
        # stable log(sigmoid): -softplus(-s); log(1-sigmoid): -softplus(s)
        sp = np.logaddexp(0.0, -s)
        sn = np.logaddexp(0.0, s)
        return float(np.mean(t * sp + (1.0 - t) * sn))

    lo, hi = np.log(1.0), np.log(50.0)
    gr = (np.sqrt(5.0) - 1.0) / 2.0
    a, b = lo, hi
    c, d = b - gr * (b - a), a + gr * (b - a)
    fc, fd = nll(c), nll(d)
    for _ in range(60):
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - gr * (b - a)
            fc = nll(c)
        else:
            a, c, fc = c, d, fd
            d = a + gr * (b - a)
            fd = nll(d)
    return float(np.exp((a + b) / 2.0))


def _sigmoid(z: np.ndarray) -> np.ndarray:
    """Overflow-safe sigmoid (exact to f64 precision: |z|>60 saturates)."""
    return 1.0 / (1.0 + np.exp(-np.clip(z, -60.0, 60.0)))


def _jpeg_roundtrip(frames: np.ndarray, quality: int) -> np.ndarray:
    """[N,H,W,3] f32 RGB in [0,1] → same, through a JPEG encode/decode."""
    import cv2
    out = np.empty_like(frames)
    for i, f in enumerate(frames):
        bgr = (np.clip(f[..., ::-1], 0, 1) * 255).astype(np.uint8)
        ok, buf = cv2.imencode(".jpg", bgr,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        assert ok
        dec = cv2.imdecode(buf, cv2.IMREAD_COLOR)
        out[i] = dec[..., ::-1].astype(np.float32) / 255.0
    return out


def _codec_transform(crf: int, codec: str = "libx264", seed: int = 0):
    """Per-frame transform: a real video-codec round trip at ``crf``
    (P-frame artifacts through ``ingest/codec.py``'s jittered mini-GOPs)."""
    from avd_tpu_torch.ingest import codec as codec_mod

    def tf(frames: np.ndarray) -> np.ndarray:
        return codec_mod.roundtrip_frames(
            frames, codec=codec, crf=crf,
            rng=np.random.default_rng(seed))
    return tf


def _codec_available() -> bool:
    from avd_tpu_torch.ingest import codec as codec_mod
    return codec_mod.available()


def _logits_fn(fam, params, cfg, dev):
    """numpy frames → numpy f32 logits (per frame, or [B, T] for the
    temporal family)."""
    import torch

    @torch.inference_mode()
    def fn(frames: np.ndarray) -> np.ndarray:
        out = fam.forward(params, torch.from_numpy(
            np.ascontiguousarray(frames)).to(dev), cfg)
        return out[..., 0].float().cpu().numpy()
    return fn


def eval_checkpoint(arch: str = "vit", preset: str = "small",
                    ckpt: str | None = None, n: int = 512,
                    batch: int = 64, seed: int = 999,
                    jpeg_qualities=(95, 75, 50, 30),
                    h264_crfs=(18, 28, 35, 45), device=None):
    """(label, {family: (acc, auc, ece, ece_at_T)}, {sweep: {level: (acc,
    auc)}}, calib, extras) for the checkpoint (default: the shipped one of
    (arch, preset)) on ``device`` (default CUDA).  ``calib`` is what
    ``--write-calibration`` writes: the temperature and the fit's draws."""
    from avd_tpu_torch import device as device_mod
    from avd_tpu_torch import models
    from avd_tpu_torch.models import convert, scoring, temporal
    from avd_tpu_torch.models.train import (GENERATOR_FAMILIES,
                                            HELDOUT_FAMILY, TRAIN_FAMILIES,
                                            _acc_auc, synthetic_batch)

    dev = device_mod.resolve(device)
    # the sweeps keep one composition (the three training families and the
    # texture holdout) so their numbers compare across checkpoints
    sweep_families = ("blobs", "geometric", "texture", "cellular")

    fam_mod = models.family(arch)
    cfg = fam_mod.make_config(preset)
    ckpt = ckpt or scoring._shipped_ckpt(arch, preset)
    params = (convert.load_checkpoint(ckpt, cfg) if ckpt
              else fam_mod.init_params(0, cfg))
    params = fam_mod.cast_for_inference(params, dev)
    label = ckpt or "random_init"
    have_codec = _codec_available()
    logits_fn = _logits_fn(fam_mod, params, cfg, dev)

    if arch == "temporal":
        from avd_tpu_torch.ingest import codec as codec_mod

        def run(families, transform=None, rng_seed=seed):
            rng = np.random.default_rng(rng_seed)
            zs, ys = [], []
            for _ in range(max(1, n // (batch * 8))):
                frames, labels = temporal.synthetic_sequences(
                    rng, batch // 4, 8, cfg.image_size, families=families)
                if transform is not None:
                    frames = transform(frames)
                zs.append(logits_fn(frames).ravel())
                ys.append(labels.ravel())
            return np.concatenate(zs), np.concatenate(ys)

        zc, yc = run(tuple(TRAIN_FAMILIES), rng_seed=seed + 1)
        draws = [{"kind": "clean", "seed": seed + 1}]
        if have_codec:
            zx, yx = run(tuple(TRAIN_FAMILIES), rng_seed=seed + 2,
                         transform=lambda f: codec_mod.roundtrip_sequences(
                             f, codec="libx264", crf=28))
            zc, yc = np.concatenate([zc, zx]), np.concatenate([yc, yx])
            draws.append({"kind": "h264-crf28", "seed": seed + 2})
        T = fit_temperature(zc, yc)
        calib = {"temperature": T,
                 "fit": {"families": list(TRAIN_FAMILIES), "n": n,
                         "draws": draws, "codec_available": have_codec}}

        per_family = {}
        for fam in GENERATOR_FAMILIES:
            z, y = run((fam,))
            p = _sigmoid(z)
            acc, auc = _acc_auc(p, y)
            per_family[fam] = (acc, auc, _ece(p, y), _ece(_sigmoid(z / T),
                                                          y))

        sweeps = {}
        if have_codec and h264_crfs:
            tbl = {}
            for crf in h264_crfs:
                z, y = run(sweep_families,
                           transform=lambda f, crf=crf:
                           codec_mod.roundtrip_sequences(
                               f, codec="libx264", crf=crf))
                tbl[crf] = _acc_auc(_sigmoid(z), y)
            sweeps["h264 CRF"] = tbl

        # splice localization: on clips with a partial AI span, how well
        # the per-frame scores recover it (per-frame accuracy, span IoU)
        loc = {}
        for key, fams in (("seen", tuple(TRAIN_FAMILIES)),
                          ("unseen", (HELDOUT_FAMILY,))):
            rng = np.random.default_rng(seed + 7)
            accs, ious = [], []
            got = 0
            while got < max(64, n // 8):
                frames, labels = temporal.synthetic_sequences(
                    rng, 16, 8, cfg.image_size, families=fams)
                part = ((labels.sum(1) > 0)
                        & (labels.sum(1) < labels.shape[1]))
                if not part.any():
                    continue
                pred = _sigmoid(logits_fn(frames[part])) > 0.5
                lab = labels[part].astype(bool)
                accs.append((pred == lab).mean(axis=1))
                inter = (pred & lab).sum(1).astype(np.float64)
                union = (pred | lab).sum(1).astype(np.float64)
                ious.append(inter / np.maximum(union, 1.0))
                got += int(part.sum())
            loc[key] = (float(np.concatenate(accs).mean()),
                        float(np.concatenate(ious).mean()))
        return label, per_family, sweeps, calib, {"splice_loc": loc}

    def run(families, transform=None, rng_seed=seed):
        rng = np.random.default_rng(rng_seed)
        zs, ys = [], []
        for _ in range(max(1, n // batch)):
            frames, labels = synthetic_batch(rng, batch, cfg.image_size,
                                             families)
            if transform is not None:
                frames = transform(frames)
            zs.append(logits_fn(frames))
            ys.append(labels)
        return np.concatenate(zs), np.concatenate(ys)

    # T is fitted on the training families only (disjoint seeds); half the
    # draw is compressed (H.264 CRF 28, else JPEG q50), since these models
    # separate the clean curriculum perfectly (see fit_temperature)
    zc, yc = run(tuple(TRAIN_FAMILIES), rng_seed=seed + 1)
    draws = [{"kind": "clean", "seed": seed + 1}]
    if have_codec:
        zx, yx = run(tuple(TRAIN_FAMILIES), rng_seed=seed + 2,
                     transform=_codec_transform(28, seed=seed + 2))
        zc, yc = np.concatenate([zc, zx]), np.concatenate([yc, yx])
        draws.append({"kind": "h264-crf28", "seed": seed + 2})
    else:
        try:
            import cv2  # noqa: F401
            zj, yj = run(tuple(TRAIN_FAMILIES), rng_seed=seed + 2,
                         transform=lambda f: _jpeg_roundtrip(f, 50))
            zc, yc = np.concatenate([zc, zj]), np.concatenate([yc, yj])
            draws.append({"kind": "jpeg-q50", "seed": seed + 2})
        except ImportError:
            pass
    T = fit_temperature(zc, yc)
    calib = {"temperature": T,
             "fit": {"families": list(TRAIN_FAMILIES), "n": n,
                     "draws": draws, "codec_available": have_codec}}

    per_family = {}
    for fam in GENERATOR_FAMILIES:
        z, y = run((fam,))
        p = _sigmoid(z)
        acc, auc = _acc_auc(p, y)
        per_family[fam] = (acc, auc, _ece(p, y), _ece(_sigmoid(z / T), y))

    sweeps = {}
    if have_codec and h264_crfs:
        tbl = {}
        for crf in h264_crfs:
            z, y = run(sweep_families,
                       transform=_codec_transform(crf, seed=seed + 3))
            tbl[crf] = _acc_auc(_sigmoid(z), y)
        sweeps["h264 CRF"] = tbl
    if jpeg_qualities:
        try:
            import cv2  # noqa: F401
            tbl = {}
            for q in jpeg_qualities:
                z, y = run(sweep_families,
                           transform=lambda f, q=q: _jpeg_roundtrip(f, q))
                tbl[q] = _acc_auc(_sigmoid(z), y)
            sweeps["JPEG q"] = tbl
        except ImportError:
            pass
    return label, per_family, sweeps, calib, {}


def write_calibration(ckpt_dir: str, calib: dict, seed: int) -> str:
    """Write ``calib`` (with the eval's seed) to
    ``<ckpt_dir>/calibration.json``; return the path."""
    path = os.path.join(ckpt_dir, "calibration.json")
    calib["fit"]["seed"] = seed
    with open(path, "w") as f:
        json.dump(calib, f)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="vit",
                    choices=("vit", "cnn", "temporal"))
    ap.add_argument("--preset", default="small")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--seed", type=int, default=999)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--write-calibration", action="store_true",
                    help="write the fitted temperature and its provenance "
                         "to <ckpt>/calibration.json (served by "
                         "avd_tpu_torch/models/scoring.py)")
    args = ap.parse_args(argv)

    from avd_tpu_torch.models.train import HELDOUT_FAMILY, TRAIN_FAMILIES
    label, fams, sweeps, calib, extras = eval_checkpoint(
        args.arch, args.preset, args.ckpt, n=args.n, seed=args.seed,
        device=args.device)
    T = calib["temperature"]
    print(f"checkpoint: {label}")
    print(f"(training families: {'+'.join(TRAIN_FAMILIES)}; "
          f"unseen: {HELDOUT_FAMILY}; fitted temperature T={T:.3f})")
    print("| family | acc | AUC | ECE | ECE@T |")
    print("|---|---|---|---|---|")
    for fam, (acc, auc, ece, ece_t) in fams.items():
        tag = " (unseen)" if fam == HELDOUT_FAMILY else ""
        print(f"| {fam}{tag} | {acc:.3f} | {auc:.3f} | {ece:.3f} "
              f"| {ece_t:.3f} |")
    for name, tbl in sweeps.items():
        print(f"| {name} | acc | AUC |")
        print("|---|---|---|")
        for level, (acc, auc) in tbl.items():
            print(f"| {level} | {acc:.3f} | {auc:.3f} |")
    if "splice_loc" in extras:
        print("| splice localization | per-frame acc | span IoU |")
        print("|---|---|---|")
        for key, (acc, iou) in extras["splice_loc"].items():
            print(f"| {key} | {acc:.3f} | {iou:.3f} |")
    if args.write_calibration:
        if not os.path.isdir(str(label)):
            print("--write-calibration: no checkpoint dir to write into",
                  file=sys.stderr)
            return 1
        print(f"wrote {write_calibration(label, calib, args.seed)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
