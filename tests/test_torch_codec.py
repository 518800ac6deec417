"""Codec round trips of the port (``avd_tpu_torch/ingest/codec.py``, on
the port's libav* feeder) against ``avd_tpu``'s.

The encoders are not repeatable: libx264 and libx265 run frame threads,
and the same frames encoded twice in one process can give two bitstreams
(measured: 21730 and 21536 bytes for one 12-frame H.264 clip, the same
settings string), in ``avd_tpu`` as in the port (``ROADMAP.md`` §3 item
9).  So the two packages are held to each other through one shared
encode: the first package to encode a clip records its input and the
bitstream, the second must hand the encoder the same input bit for bit
and gets the same bitstream back; each package decodes it with its own
feeder.  The round trips are then equal bit for bit.
"""

import hashlib

import numpy as np
import pytest

from avd_tpu.ingest import codec as jcodec
from avd_tpu.native import decode as jdecode
from avd_tpu_torch.ingest import codec as tcodec
from avd_tpu_torch.native import decode as tdecode

needs_libav = pytest.mark.skipif(not jcodec.available(),
                                 reason="libav* encoder unavailable")


@pytest.fixture
def shared_encoder(monkeypatch):
    """Both packages' ``encode_video`` through one cache keyed by the call:
    a clip is encoded once (by the first caller's own library) and every
    identical call gets the same file bytes.  Returns the per-key call
    counts."""
    cache, calls = {}, {}

    def wrap(real):
        def encode_video(path, frames_bgr, fps=30.0, codec="libx264",
                         crf=-1, gop=0, preset="veryfast"):
            frames_bgr = np.ascontiguousarray(frames_bgr, np.uint8)
            key = (hashlib.sha256(frames_bgr.tobytes()).hexdigest(),
                   frames_bgr.shape, float(fps), codec, int(crf), int(gop),
                   preset)
            calls[key] = calls.get(key, 0) + 1
            if key not in cache:
                if not real(path, frames_bgr, fps, codec, crf, gop, preset):
                    return False
                with open(path, "rb") as f:
                    cache[key] = f.read()
            with open(path, "wb") as f:
                f.write(cache[key])
            return True
        return encode_video

    monkeypatch.setattr(jdecode, "encode_video", wrap(jdecode.encode_video))
    monkeypatch.setattr(tdecode, "encode_video", wrap(tdecode.encode_video))
    return calls


def test_availability_and_sweep():
    assert tcodec.available() == jcodec.available()
    assert tcodec.CRF_SWEEP == jcodec.CRF_SWEEP


@needs_libav
@pytest.mark.parametrize("codec,crf", [("libx264", 18), ("libx264", 35),
                                       ("libx265", 28), ("mpeg4", 23)])
def test_roundtrip_frames_equal(codec, crf, shared_encoder):
    # 64² frames: libx265 corrupts the heap on frames 48 px wide
    frames = np.random.default_rng(crf).random((5, 64, 64, 3), np.float32)
    ours = tcodec.roundtrip_frames(frames, codec=codec, crf=crf,
                                   rng=np.random.default_rng(1), group=3)
    ref = jcodec.roundtrip_frames(frames, codec=codec, crf=crf,
                                  rng=np.random.default_rng(1), group=3)
    assert ours.dtype == np.float32 and ours.shape == frames.shape
    # the same two encoder inputs (groups of 3 and 2 mini-clips), each
    # asked for once by either package
    assert sorted(shared_encoder.values()) == [2, 2]
    np.testing.assert_array_equal(ours, ref)
    assert not np.array_equal(ours, frames)


@needs_libav
@pytest.mark.parametrize("codec", ["libx264", "mpeg4"])
def test_roundtrip_sequences_equal(codec, shared_encoder):
    seqs = np.random.default_rng(2).random((2, 6, 32, 32, 3), np.float32)
    ours = tcodec.roundtrip_sequences(seqs, codec=codec, crf=28)
    ref = jcodec.roundtrip_sequences(seqs, codec=codec, crf=28)
    assert ours.shape == seqs.shape
    assert sorted(shared_encoder.values()) == [2, 2]
    np.testing.assert_array_equal(ours, ref)


@needs_libav
def test_augment_pool_codec_equals_avd_tpu(shared_encoder):
    """The selection, the codec and CRF draws, the encoder inputs and the
    round trips."""
    from avd_tpu.models import train as jtrain
    from avd_tpu_torch.models import train as ttrain
    frames = np.random.default_rng(4).random((6, 64, 64, 3), np.float32)
    ours = ttrain.augment_pool_codec(frames, 0.5, np.random.default_rng(7))
    ref = jtrain.augment_pool_codec(frames, 0.5, np.random.default_rng(7))
    assert shared_encoder and set(shared_encoder.values()) == {2}
    np.testing.assert_array_equal(ours, ref)
