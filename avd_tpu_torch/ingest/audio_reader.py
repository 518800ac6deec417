"""Mono 16 kHz audio extraction.

The port's copy of ``avd_tpu/ingest/audio_reader.py``.  The reference
pipes the container through ``ffmpeg -ac 1 -ar 16000`` to a temp WAV and
reads it with libsndfile as float32 (reference app/analyzers/audio.py:7-20).
Backends, in ``avd_tpu``'s order:

1. ``ffmpeg`` subprocess → raw s16le pipe when the binary exists; sample
   values are bit-identical to the reference's WAV round trip (s16 / 32768
   → float32).
2. libav* extraction through the port's decoder (``native/decode.py``):
   the libavcodec + libswresample pipeline the ffmpeg CLI wraps.
3. For ``.wav`` inputs: the C++ host runtime's WAV decode and resample
   (``avd_tpu_torch.native``; ``AVD_NATIVE=0`` skips it), then stdlib
   ``wave`` + polyphase resample/downmix for what it declines.
4. Otherwise ``AudioExtractError("ffmpeg_convert_failed")`` — the error
   string the reference raises (audio.py:13), which the analyzer maps to
   the neutral timeline contract (audio.py:112-118).
"""

from __future__ import annotations

import shutil
import subprocess
import wave
from typing import Tuple

import numpy as np

from avd_tpu_torch import config as config_mod

TARGET_SR = 16000


class AudioExtractError(RuntimeError):
    pass


def _ffmpeg_pcm(path: str, sr: int = TARGET_SR) -> np.ndarray:
    cmd = [
        "ffmpeg", "-v", "error", "-i", path,
        "-ac", "1", "-ar", str(sr), "-f", "s16le", "-",
    ]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.DEVNULL, check=False)
    except OSError as e:
        raise AudioExtractError("ffmpeg_convert_failed") from e
    if proc.returncode != 0:
        raise AudioExtractError("ffmpeg_convert_failed")
    pcm = np.frombuffer(proc.stdout, dtype="<i2")
    return (pcm.astype(np.float32) / 32768.0)


def _read_wav_native(path: str) -> Tuple[np.ndarray, int]:
    """Stdlib WAV read → float32 in [-1, 1), shape [n] or [n, ch]."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32)
                - 128.0) / 128.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    else:
        raise AudioExtractError("soundfile_read_failed")
    if ch > 1:
        data = data.reshape(-1, ch)
    return data, sr


def _resample(x: np.ndarray, sr: int, target: int) -> np.ndarray:
    if sr == target:
        return x
    from scipy.signal import resample_poly
    from math import gcd
    g = gcd(sr, target)
    return resample_poly(x, target // g, sr // g).astype(np.float32)


def load_mono_16k(path: str) -> Tuple[np.ndarray, int]:
    """Return (wav_float32_mono, sample_rate=16000).

    Raises AudioExtractError when no backend can produce audio, matching the
    reference's failure strings so the neutral-fallback contract and the
    ``flags_audio.error`` field stay byte-compatible.
    """
    if shutil.which("ffmpeg"):
        wav = _ffmpeg_pcm(path)
        return wav, TARGET_SR
    if not path.lower().endswith(".wav"):
        # libav*-linked extraction — s16-mono-16k semantics identical to
        # the CLI pipeline (same libswresample defaults)
        try:
            from avd_tpu_torch.native import decode as native_decode
            got = native_decode.decode_audio_mono16k(path, TARGET_SR)
        except Exception:
            got = None
        if got is not None:
            return got[0], TARGET_SR
    if path.lower().endswith(".wav"):
        # the C++ host runtime (parse + downmix + windowed-sinc resample)
        # unless AVD_NATIVE=0; like the rest of the port's host prep it
        # raises when it cannot be built instead of falling back
        if config_mod.get_config().native:
            from avd_tpu_torch import native
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError as e:
                raise AudioExtractError("soundfile_read_failed") from e
            decoded = native.wav_decode_mono(data)
            if decoded is not None:
                data, sr = decoded
                if sr != TARGET_SR:
                    from math import gcd
                    g = gcd(sr, TARGET_SR)
                    return native.resample(data, TARGET_SR // g,
                                           sr // g), TARGET_SR
                return data, TARGET_SR
        try:
            data, sr = _read_wav_native(path)
        except AudioExtractError:
            raise
        except Exception as e:
            raise AudioExtractError("soundfile_read_failed") from e
        if data.ndim > 1:
            # ffmpeg -ac 1 downmixes by averaging channels; mirror that.
            data = data.mean(axis=1)
        return _resample(data, sr, TARGET_SR), TARGET_SR
    raise AudioExtractError("ffmpeg_convert_failed")
