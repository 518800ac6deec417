"""Decoded media → envelope: the port (CPU) against ``avd_tpu``.

Both packages take the same sampled BGR frames and mono 16 kHz waveform;
``avd_tpu``'s side is assembled the way ``avd_tpu.pipeline.analyze_path``
assembles it after decode (hints, video, audio, fusion, the envelope in
the reference key order).  The port's envelope passes its own
``schema.validate`` and ``avd_tpu``'s, with the same label and
|Δai_score| <= 1e-3.
"""

import copy

import numpy as np
import pytest
import torch

from avd_tpu import schema as jschema
from avd_tpu.analyzers import fusion as jfusion
from avd_tpu.analyzers import heuristics_v2 as jhx
from avd_tpu.analyzers import video as jvideo
from avd_tpu.ingest import video_reader as jreader
from avd_tpu.ops import audio_features as jaf
from avd_tpu_torch import pipeline, schema
from avd_tpu_torch.ingest import video_reader
from tests import fixtures

torch.set_num_threads(1)

_FPS = 30.0


def _media(kind):
    n, size = 45, 96
    frames = {"spliced": fixtures.spliced_clip(n, size),
              "noise": fixtures.noise_clip(n, size),
              "solid": fixtures.solid_clip(n, size)}[kind]
    dur = n / _FPS
    sampled = frames[::video_reader.sampling_step(_FPS)]
    wav = {"spliced": fixtures.speechy_wav(dur),
           "noise": fixtures.noise_wav(dur),
           "solid": fixtures.sine_wav(dur)}[kind]
    wav = (np.round(wav.astype(np.float64) * 16384) / 32768).astype(
        np.float32)
    meta = {"width": size, "height": size, "fps": _FPS, "duration": dur,
            "bit_rate": 1_000_000, "vcodec": "h264", "acodec": "aac",
            "format_name": "mov,mp4,m4a,3gp,3g2,mj2"}
    return sampled, wav, meta


def _reference_envelope(sampled, wav, meta):
    hints = jhx.compute_hints(meta, "")
    fb = jreader.FrameBatch(sampled, len(sampled), meta["fps"],
                            meta["width"], meta["height"], meta["duration"])
    video = jvideo.analyze_batch(fb)
    audio = jaf.analyze_waveform(wav, 16000)
    fused = jfusion.fuse(audio, video, hints)
    return {"ok": True,
            "meta": {**meta, "source_url": None, "resolved_url": None},
            "hints": hints, "video": video, "audio": audio,
            "result": fused["result"],
            "timeline_binned": fused["timeline_binned"],
            "peaks": fused["peaks"]}


@pytest.mark.parametrize("kind", ["spliced", "noise", "solid"])
def test_envelope_matches_avd_tpu(kind):
    sampled, wav, meta = _media(kind)
    fb = video_reader.FrameBatch(sampled, len(sampled), meta["fps"],
                                 meta["width"], meta["height"],
                                 meta["duration"])
    ours = pipeline.analyze_decoded(fb, wav, 16000, copy.deepcopy(meta),
                                    device="cpu")
    ref = _reference_envelope(sampled, wav, copy.deepcopy(meta))
    schema.validate(ours)
    jschema.validate(ours)
    assert list(ours) == list(ref)
    assert ours["meta"] == ref["meta"]
    assert ours["hints"] == ref["hints"]
    assert ours["result"]["label"] == ref["result"]["label"]
    t_o = np.mean(ours["timeline_binned"])
    t_r = np.mean(ref["timeline_binned"])
    assert abs(t_o - t_r) <= 1e-3, f"{kind}: {t_o} vs {t_r}"
    assert ours["result"]["ai_score"] == ref["result"]["ai_score"]
    assert ours["video"]["timeline"] is ours["video"]["timeline_ai"]
