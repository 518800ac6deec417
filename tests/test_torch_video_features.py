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
