"""Audio analyzer — public entry point.

Port of ``avd_tpu/analyzers/audio.py``.  Contract from the reference's
app/analyzers/audio.py: ``analyze(path, meta)`` returns
``{"scores": {...}, "flags_audio": {...}, "timeline": [...]}``; any
internal failure yields the neutral result
``{"scores": {}, "flags_audio": {"error": str(e)}, "timeline": [0.5]*tlen}``
with ``tlen = max(1, round(meta duration))`` (audio.py:112-118).

The host extracts mono 16 kHz PCM (``ingest/audio_reader.py``); the
window features run batched on ``device`` (``ops/audio_features.py``).
"""

from __future__ import annotations

import os
from typing import Any, Dict

from avd_tpu_torch import device as device_mod
from avd_tpu_torch.ingest import audio_reader


def _backend() -> str:
    """``avd_tpu``'s selection, same names: ``jax`` (the default) is the
    batched device path, here ``ops/audio_features`` on ``device``;
    ``AVD_AUDIO_BACKEND=host`` forces the float64 host loop
    (``oracle/audio_ref``); ``AVD_BACKEND=oracle`` forces it globally."""
    if os.getenv("AVD_BACKEND", "jax") == "oracle":
        return "oracle"
    return os.getenv("AVD_AUDIO_BACKEND", "jax")


def _neutral(meta: dict, err: str) -> Dict[str, Any]:
    tlen = int(max(1, round(meta.get("duration") or 0.0)))
    return {"scores": {}, "flags_audio": {"error": err},
            "timeline": [0.5] * tlen}


def analyze(path: str, meta: dict, device=None) -> Dict[str, Any]:
    """Analyze the audio of ``path`` on ``device`` (default CUDA; raises
    without it unless the caller asks for the CPU, before any fallback)."""
    dev = device_mod.resolve(device)
    try:
        wav, sr = audio_reader.load_mono_16k(path)
        if wav.ndim > 1:
            wav = wav[:, 0]
        if _backend() == "jax":
            from avd_tpu_torch.ops import audio_features
            return audio_features.analyze_waveform(wav, sr, device=dev)
        from avd_tpu_torch.oracle import audio_ref
        return audio_ref.analyze_waveform(wav.astype("float64"), sr)
    except Exception as e:  # neutral-fallback contract (audio.py:112-118)
        return _neutral(meta, str(e))
