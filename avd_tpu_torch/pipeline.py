"""Decoded media → reference-compatible JSON envelope.

The slice of ``avd_tpu/pipeline.analyze_path`` that starts after decode:
hints from the clip's metadata, the video analyzer over the sampled frames,
the audio analyzer over the mono waveform, fusion, and the envelope in the
reference's key order (api.py:149-162).  Container probe, decode and the
forensic block belong to the file path, which this package does not have
yet.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.analyzers import fusion as fusion_an
from avd_tpu_torch.analyzers import heuristics_v2 as hx
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.ops import audio_features


def envelope(meta: Dict[str, Any], hints: Dict[str, Any], video: Dict,
             audio: Dict) -> Dict[str, Any]:
    """Fuse and assemble the response dict (pipeline.py:172-182 order).
    Decoded media has no URL, so ``source_url`` and ``resolved_url`` are
    None."""
    fused = fusion_an.fuse(audio, video, hints)
    return {
        "ok": True,
        "meta": {**meta, "source_url": None, "resolved_url": None},
        "hints": hints,
        "video": video,
        "audio": audio,
        "result": fused["result"],
        "timeline_binned": fused["timeline_binned"],
        "peaks": fused["peaks"],
    }


def analyze_decoded(fb: video_reader.FrameBatch, wav: np.ndarray, sr: int,
                    meta: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Analyze decoded media on ``device`` (default CUDA) → envelope.

    ``meta`` carries the probed fields (width, height, fps, duration,
    bit_rate, vcodec, acodec, format_name)."""
    dev = device_mod.resolve(device)
    hints = hx.compute_hints(meta, "")
    video = video_an.analyze_batch(fb, device=dev)
    audio = audio_features.analyze_waveform(wav, sr, device=dev)
    return envelope(meta, hints, video, audio)
