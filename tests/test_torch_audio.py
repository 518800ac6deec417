"""Audio window features: the port (CPU) against ``avd_tpu``.

The waves are those of tests/fixtures.py (sine, noise, speech-like), cut so
that a ragged last window goes through the host float64 path, and
quantized to 16-bit PCM as decoded audio is (as in
tests/test_audio_features.py).  Per-window features agree to f32
precision; the timeline holds |Δ| <= 5e-5 (docs/KERNELS.md, Audio); the
flatness guard fires on the pure tone in both packages.

On the unquantized speech-like fixture the window flatness (~2e-3) sits
just above the guard's floor, where f32 FFT rounding decides its last
digits: there avd_tpu itself is 5.6e-3 off the float64 oracle (measured),
so the port is held to the bound avd_tpu holds against the oracle
(2e-2, tests/test_audio_features.py).
"""

import numpy as np
import pytest
import torch

from avd_tpu.oracle import audio_ref as jaudio_ref
from avd_tpu.ops import audio_features as jaf
from avd_tpu_torch.ops import audio_features as taf
from tests import fixtures

torch.set_num_threads(1)


def _pcm16(wav):
    return (np.round(np.asarray(wav, np.float64) * 16384)
            / 32768).astype(np.float32)


_WAVES = {
    "sine": lambda: _pcm16(fixtures.sine_wav(3.3)),
    "noise": lambda: _pcm16(fixtures.noise_wav(3.3)),
    "speechy": lambda: _pcm16(fixtures.speechy_wav(3.3)),
    "silence": lambda: np.zeros(16000 * 2, np.float32),
}


@pytest.mark.parametrize("name", sorted(_WAVES))
def test_window_features(name):
    wav = _WAVES[name]()
    ref = jaf.window_features(wav, 16000)
    ours = taf.window_features(wav, 16000, device="cpu")
    assert ours.keys() == ref.keys()
    for k in ref:
        assert len(ours[k]) == len(ref[k])
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("name", sorted(_WAVES))
def test_analyze_waveform(name):
    wav = _WAVES[name]()
    ref = jaf.analyze_waveform(wav, 16000)
    ours = taf.analyze_waveform(wav, 16000, device="cpu")
    assert len(ours["timeline"]) == len(ref["timeline"])
    assert np.max(np.abs(np.subtract(ours["timeline"],
                                     ref["timeline"]))) <= 5e-5
    assert ours["scores"]["tts_like"] == pytest.approx(
        ref["scores"]["tts_like"], abs=1e-4)
    # A pure tone has the same RMS in every full window up to f32 rounding,
    # so its speech_ratio (share of windows at or above the 60th-percentile
    # RMS) is decided by last-bit ties: measured 1.0 in the port against
    # 0.857 in avd_tpu on the sine.  It is compared on the other waves.
    if name != "sine":
        assert ours["scores"]["speech_ratio"] == \
            ref["scores"]["speech_ratio"]


def test_unquantized_speech_like_wave():
    wav = fixtures.speechy_wav(3.3)
    ours = taf.analyze_waveform(wav, 16000, device="cpu")
    ref = jaf.analyze_waveform(wav, 16000)
    ora = jaudio_ref.analyze_waveform(wav.astype(np.float64), 16000)
    np.testing.assert_allclose(ours["timeline"], ora["timeline"], atol=2e-2)
    np.testing.assert_allclose(ours["timeline"], ref["timeline"], atol=2e-2)
    assert ours["scores"] == ref["scores"] == ora["scores"]


def test_flatness_guard_recomputes_in_float64():
    """A pure tone trips the guard: flatness equals the float64 oracle."""
    wav = fixtures.sine_wav(2.0)
    ours = taf.window_features(wav, 16000, device="cpu")
    ref = jaudio_ref.window_features(wav.astype(np.float64), 16000)
    assert min(ours["flat"]) < 1e-3
    np.testing.assert_allclose(ours["flat"], ref["flat"], rtol=1e-9)


def test_stereo_takes_the_first_channel():
    wav = fixtures.speechy_wav(1.2)
    st = np.stack([wav, np.zeros_like(wav)], axis=1)
    assert taf.analyze_waveform(st, 16000, device="cpu") == \
        taf.analyze_waveform(wav, 16000, device="cpu")
