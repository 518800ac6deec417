"""Real video-codec compression round trips (H.264 / H.265 / MPEG-4).

Port of ``avd_tpu/ingest/codec.py`` on the port's libav* feeder
(``native/decode.py``: ``encode_video`` drives the encoders, the GOP-skip
decoder reads the clip back at step 1).  The trainer's codec augmentation
(``models/train.augment_pool_codec``) and the eval tool's CRF sweep use it;
it is host-side tooling, the device never sees it.  ``available()`` is
False where the libav* headers or libraries are missing (the feeder is not
built there), and the callers then raise or skip the sweep.

* ``roundtrip_sequences`` — [B, T, H, W, 3] clips, each encoded as one real
  video (the temporal family's form);
* ``roundtrip_frames`` — [N, H, W, 3] independent frames, each the last
  frame of a tiny jittered motion clip of itself, so what comes back is a
  P-frame with real motion-compensated history, as sampled frames of a
  compressed upload are.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

# CRF sweep of tools/torch_eval_detector.py (and tools/eval_detector.py): 18 is
# near-transparent, 28 a typical web re-encode, 35 heavy, 45 destroyed.
CRF_SWEEP = (18, 28, 35, 45)


def available() -> bool:
    """True when the native libav* encoder entry point is loadable."""
    from avd_tpu_torch.native import decode
    return decode.lib() is not None


def _encode_decode(frames_bgr_u8: np.ndarray, codec: str, crf: int,
                   fps: float, gop: int, preset: str) -> np.ndarray:
    """[T, H, W, 3] BGR u8 -> same through one real encode/decode."""
    from avd_tpu_torch.native import decode
    t = frames_bgr_u8.shape[0]
    fd, path = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    try:
        if not decode.encode_video(path, frames_bgr_u8, fps=fps,
                                   codec=codec, crf=crf, gop=gop,
                                   preset=preset):
            raise RuntimeError(
                f"codec round-trip: encode failed ({codec}, crf={crf})")
        vs = decode.VideoSampler.open(path, 1)
        if vs is None:
            raise RuntimeError("codec round-trip: decode open failed")
        try:
            chunks = [f.copy() for f, _ in vs.chunks(64)]
        finally:
            vs.close()
        out = np.concatenate(chunks) if chunks else np.empty(
            (0,) + frames_bgr_u8.shape[1:], np.uint8)
        if out.shape[0] != t:
            raise RuntimeError(
                f"codec round-trip: {out.shape[0]} of {t} frames decoded")
        return out
    finally:
        try:
            os.unlink(path)
        except OSError:
            pass


def _to_bgr_u8(frames_rgb_f32: np.ndarray) -> np.ndarray:
    return (np.clip(frames_rgb_f32[..., ::-1], 0.0, 1.0)
            * 255.0 + 0.5).astype(np.uint8)


def _to_rgb_f32(frames_bgr_u8: np.ndarray) -> np.ndarray:
    return frames_bgr_u8[..., ::-1].astype(np.float32) / 255.0


def roundtrip_sequences(seqs: np.ndarray, codec: str = "libx264",
                        crf: int = 28, fps: float = 12.0, gop: int = 0,
                        preset: str = "veryfast") -> np.ndarray:
    """[B, T, H, W, 3] f32 RGB in [0,1] -> same, each sequence encoded
    as one real video and decoded back."""
    out = np.empty_like(seqs, dtype=np.float32)
    for b in range(seqs.shape[0]):
        dec = _encode_decode(_to_bgr_u8(seqs[b]), codec, crf, fps, gop,
                             preset)
        out[b] = _to_rgb_f32(dec)
    return out


def roundtrip_frames(frames: np.ndarray, codec: str = "libx264",
                     crf: int = 28, rng: np.random.Generator | None = None,
                     clip_len: int = 4, fps: float = 12.0,
                     preset: str = "veryfast",
                     group: int = 16) -> np.ndarray:
    """[N, H, W, 3] f32 RGB in [0,1] -> same through real P-frame decode.

    Each frame is expanded into a ``clip_len``-frame mini-clip of
    integer-pixel rolled copies of itself (small pans), ``group`` such
    mini-clips are concatenated into one encode call with
    ``gop=clip_len`` (every mini-clip starts at a keyframe boundary so
    prediction never crosses unrelated frames), and the LAST frame of
    each mini-clip — a P-frame whose reference chain is the jittered
    history — is returned.  Encoding cost is ``clip_len`` x the input
    pixels; use clip_len=1, gop=1 for an all-intra sweep."""
    rng = rng or np.random.default_rng(0)
    n, h, w = frames.shape[:3]
    out = np.empty_like(frames, dtype=np.float32)
    for g0 in range(0, n, group):
        g1 = min(n, g0 + group)
        clip = np.empty(((g1 - g0) * clip_len, h, w, 3), np.uint8)
        for j, i in enumerate(range(g0, g1)):
            bgr = _to_bgr_u8(frames[i])
            for k in range(clip_len):
                if k == clip_len - 1:
                    clip[j * clip_len + k] = bgr
                else:
                    dy, dx = rng.integers(-2, 3, 2)
                    clip[j * clip_len + k] = np.roll(bgr, (dy, dx),
                                                     axis=(0, 1))
        dec = _encode_decode(clip, codec, crf, fps, max(1, clip_len),
                             preset)
        out[g0:g1] = _to_rgb_f32(
            dec[clip_len - 1::clip_len][:g1 - g0])
    return out
