#!/usr/bin/env python
"""Build the on-disk real/ai fixture corpus for the trainer's ``--data``
path with the PyTorch port (``avd_tpu_torch``).

The port's counterpart of ``tools/make_fixture_corpus.py``: the same
layout, seed, sizes, JPEG qualities and CRFs, so it writes the same
corpus:

    <root>/real/  camera-like frames as JPEGs (quality 75-92) and H.264
                  clips (CRF 23/28): sensor noise, crisp detail
    <root>/ai/    generator-like frames and clips: over-smoothed, low
                  detail

Frames come from the port's procedural families
(``avd_tpu_torch.models.train.GENERATOR_FAMILIES``) and go through real
encoders: cv2's JPEG, and libx264 through the port's libav* layer
(``avd_tpu_torch.native.decode.encode_video``), with cv2's mp4v where
that layer is not built.  The JPEGs are byte-equal to the JAX tool's at
the same seed; libx264's output is not repeatable from run to run.  It
makes data on the host and uses no torch device.

The committed copy lives at tests/data/corpus_v1.

Usage: python tools/torch_make_fixture_corpus.py [--out DIR] [--seed 42]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from avd_tpu_torch.models import train as train_mod  # noqa: E402
from avd_tpu_torch.native import decode as ndec  # noqa: E402

SIZE = 64
N_IMAGES = 24          # per class
N_CLIPS = 2            # per class
CLIP_FRAMES = 16
FAMILIES = ("blobs", "geometric")
JPEG_QUALITIES = (75, 93)  # rng.integers bounds: qualities 75-92
CRFS = (23, 28)
FPS = 12.0


def _frame(rng, ai_like: bool) -> np.ndarray:
    fam = FAMILIES[int(rng.integers(0, len(FAMILIES)))]
    img = train_mod.GENERATOR_FAMILIES[fam](rng, SIZE, ai_like)
    return (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)[..., ::-1]  # BGR


def _write_clip(path: str, frames: np.ndarray, crf: int) -> None:
    import cv2
    if ndec.encode_video(path, frames, fps=FPS, codec="libx264", crf=crf):
        return
    # no libav encoder on this host: cv2's mp4v keeps the corpus buildable
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), FPS,
                         (SIZE, SIZE))
    for fr in frames:
        vw.write(fr)
    vw.release()


def build(root: str, seed: int = 42) -> dict:
    """Write the corpus under ``root``; returns the files per class."""
    import cv2
    rng = np.random.default_rng(seed)
    counts = {}
    for label, sub in ((0, "real"), (1, "ai")):
        d = os.path.join(root, sub)
        os.makedirs(d, exist_ok=True)
        ai = label == 1
        for i in range(N_IMAGES):
            q = int(rng.integers(*JPEG_QUALITIES))
            ok, buf = cv2.imencode(".jpg", _frame(rng, ai),
                                   [cv2.IMWRITE_JPEG_QUALITY, q])
            if not ok:
                raise RuntimeError(f"cv2 could not encode {sub} image {i}")
            with open(os.path.join(d, f"img_{i:03d}_q{q}.jpg"), "wb") as f:
                f.write(buf.tobytes())
        for c in range(N_CLIPS):
            frames = np.stack([_frame(rng, ai) for _ in range(CLIP_FRAMES)])
            crf = CRFS[c % 2]
            _write_clip(os.path.join(d, f"clip_{c:02d}_crf{crf}.mp4"),
                        frames, crf)
        counts[sub] = N_IMAGES + N_CLIPS
    return counts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="tests/data/corpus_v1")
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    counts = build(args.out, args.seed)
    total = sum(os.path.getsize(os.path.join(r, f))
                for r, _, fs in os.walk(args.out) for f in fs)
    print(f"corpus at {args.out}: {counts} ({total / 1024:.0f} KB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
