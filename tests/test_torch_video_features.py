"""Video features on the golden clips: the port (CPU) against ``avd_tpu``.

The clips are those of tests/test_video_parity.py (24 frames at 128 px,
sampled at the reference cadence).  Duplicate density is exact; flow_mean
holds rtol 1e-4, except on the gradient clip (see ``_FLOW_RTOL``); through
fusion the ai_score holds |Δ| <= 1e-3 with the same label.  The port's
streaming path equals its batch path exactly.
"""

import copy

import numpy as np
import pytest
import torch

from avd_tpu.analyzers import fusion as jfusion
from avd_tpu.analyzers import heuristics_v2 as jhx
from avd_tpu.ops import video_features as jvf
from avd_tpu_torch.analyzers import fusion as tfusion
from avd_tpu_torch.analyzers import heuristics_v2 as thx
from avd_tpu_torch.analyzers import video as tvideo
from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.ops import video_features as tvf
from tests import fixtures

torch.set_num_threads(1)

_CLIPS = {
    "solid": lambda: fixtures.solid_clip(24, 128),
    "noise": lambda: fixtures.noise_clip(24, 128),
    "gradient": lambda: fixtures.gradient_clip(24, 128),
    "spliced": lambda: fixtures.spliced_clip(24, 128),
}

# The gradient clip moves a sawtooth 75 px between its sampled frames (the
# aperture-problem case of tests/test_video_parity.py): the flow there is
# ambiguous, and f32 summation order alone moves flow_mean.  Measured: the
# port against avd_tpu differs by 2.3e-4 relative, while avd_tpu against
# itself differs by 5.2e-3 between a 1-pair and a 12-pair batch (the same
# pair).  So this clip holds 1e-3; the others hold 1e-4.
_FLOW_RTOL = {"gradient": 1e-3}


def _sampled(name):
    frames = _CLIPS[name]()
    step = video_reader.sampling_step(30.0)
    return frames[::step], len(frames) / 30.0


@pytest.fixture(scope="module")
def results():
    out = {}
    for name in _CLIPS:
        s, dur = _sampled(name)
        out[name] = (jvf.analyze_frames(s, 128, 128, 30.0, dur),
                     tvf.analyze_frames(s, 128, 128, 30.0, dur,
                                        device="cpu"), dur)
    return out


@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_feature_parity(results, name):
    ref, ours, _ = results[name]
    s_r, s_o = ref["summary"], ours["summary"]
    assert s_o["dup_density"] == s_r["dup_density"]
    assert s_o["texture_var"] == s_r["texture_var"]
    np.testing.assert_allclose(s_o["flow_mean"], s_r["flow_mean"],
                               rtol=_FLOW_RTOL.get(name, 1e-4), atol=1e-6)
    assert s_o["scene_change_rate"] == s_r["scene_change_rate"]
    assert len(ours["timeline"]) == len(ref["timeline"])
    np.testing.assert_allclose(ours["timeline"], ref["timeline"], atol=1e-4)


@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_ai_score_parity(results, name):
    ref_v, ours_v, dur = results[name]
    meta = {"width": 128, "height": 128, "fps": 30.0, "bit_rate": 1_000_000}
    neutral_audio = {"scores": {}, "flags_audio": {},
                     "timeline": [0.5] * int(max(1, round(dur)))}
    fused_ref = jfusion.fuse(copy.deepcopy(neutral_audio),
                             copy.deepcopy(ref_v),
                             jhx.compute_hints(meta, ""))
    fused_ours = tfusion.fuse(copy.deepcopy(neutral_audio),
                              copy.deepcopy(ours_v),
                              thx.compute_hints(meta, ""))
    assert fused_ours["result"]["label"] == fused_ref["result"]["label"]
    t_r = np.mean(fused_ref["timeline_binned"])
    t_o = np.mean(fused_ours["timeline_binned"])
    assert abs(t_o - t_r) <= 1e-3, f"{name}: {t_o} vs {t_r}"


def test_streaming_equals_batch(monkeypatch):
    """Any split of the input into chunks gives the batch result exactly
    (the windows depend only on the frames and the device chunk)."""
    frames = fixtures.gradient_clip(90, 96)[::15]  # 6 frames
    monkeypatch.setattr(tvf, "_DEFAULT_CHUNK", 4)
    batch = tvf.compute_features(frames, device="cpu")
    splits = [1, 2, 3]  # chunks of 1, 2 and 3 frames
    chunks, i = [], 0
    for k in splits * 3:
        if i < len(frames):
            chunks.append(frames[i:i + k])
            i += k
    chunks.insert(1, frames[:0])  # an empty chunk is skipped
    stream = tvf.compute_features_streaming(iter(chunks), device="cpu")
    assert stream == batch
    assert batch["total"] == 6 and len(batch["flow_means"]) == 5


# With the chunk at 8 the windows are 9 frames (the lead-in and 8) and a
# tail rounds up to 3, 5, 7 or 9.  These clip lengths put a tail of every
# bucket in the first window (2, 3, 5, 7) and in a later one (9, 12, 14,
# 15), plus one, two and two full windows and a tail (8, 16, 17).
_TAIL_CHUNK = 8
_TAIL_LENGTHS = (2, 3, 5, 7, 8, 9, 12, 14, 15, 16, 17)


@pytest.fixture(scope="module")
def pan():
    """17 frames, 48×64 BGR, of a (1, 2) px/frame pan over smooth seeded
    noise: every pair moves, so the flow stats hold relative bounds."""
    n, h, w = max(_TAIL_LENGTHS), 48, 64
    rng = np.random.default_rng(17)
    hh, ww = h + n, w + 2 * n
    ky, kx = np.meshgrid(np.fft.fftfreq(hh), np.fft.fftfreq(ww),
                         indexing="ij")
    base = np.fft.ifft2(np.fft.fft2(rng.normal(size=(hh, ww)))
                        * np.exp(-60.0 * (kx ** 2 + ky ** 2))).real
    base = np.clip((base - base.mean()) / base.std() * 40 + 128, 0, 255)
    gray = np.stack([base[k:k + h, 2 * k:2 * k + w] for k in range(n)])
    return np.repeat(gray.astype(np.uint8)[..., None], 3, axis=-1)


@pytest.mark.parametrize("n", _TAIL_LENGTHS)
def test_streaming_tail_buckets_match_avd_tpu(monkeypatch, pan, n):
    """The port's streaming path, fed in chunks of 5, against the JAX
    package's ``compute_features`` on the same frames, at the flow
    contract of tests/test_pallas_blur_solve.py:108-111: textures and
    duplicates exact, flow means rtol 1e-4, variances rtol 1e-3."""
    monkeypatch.setattr(tvf, "_DEFAULT_CHUNK", _TAIL_CHUNK)
    monkeypatch.setattr(jvf, "_DEFAULT_CHUNK", _TAIL_CHUNK)
    frames = pan[:n]
    ours = tvf.compute_features_streaming(
        (frames[i:i + 5] for i in range(0, n, 5)), device="cpu")
    ref = jvf.compute_features(frames)
    assert ours["total"] == ref["total"] == n
    assert ours["dup"] == ref["dup"]
    assert ours["textures"] == ref["textures"]
    assert len(ours["flow_means"]) == len(ref["flow_means"]) == n - 1
    np.testing.assert_allclose(ours["flow_means"], ref["flow_means"],
                               rtol=1e-4)
    np.testing.assert_allclose(ours["flow_vars"], ref["flow_vars"],
                               rtol=1e-3)


def test_analyze_batch_aliases_the_timelines():
    frames, dur = _sampled("spliced")
    fb = video_reader.FrameBatch(frames, len(frames), 30.0, 128, 128, dur)
    out = tvideo.analyze_batch(fb, device="cpu")
    assert out["timeline"] is out["timeline_ai"]
    assert set(out) == {"timeline", "summary", "timeline_ai"}


def test_empty_and_single_frame():
    out = tvf.analyze_frames(np.zeros((0, 64, 64, 3), np.uint8), 64, 64,
                             30.0, 2.0, device="cpu")
    assert out["timeline"] == [0.5, 0.5]
    frames = fixtures.noise_clip(1, 64)
    ours = tvf.analyze_frames(frames, 64, 64, 30.0, 1.0, device="cpu")
    ref = jvf.analyze_frames(frames, 64, 64, 30.0, 1.0)
    assert ours["summary"] == ref["summary"]
    assert ours["timeline"] == ref["timeline"]
