"""Device prep (``AVD_PREP=device``) of the port against ``avd_tpu``.

Full-resolution gray goes to the device; the 32² and 320² planes are
fp32 resize products there and the texture a float32 stencil variance.
On the CPU: the port's ``run_window`` against the JAX package's (Hamming
exact, flow stats at rtol 1e-4, texture at rtol 1e-5), the gray
conversion bit-exact, the texture against cv2 within 1e-2 (as
``tests/test_kernels.py``), and a device-prep ``analyze_frames`` through
fusion against the JAX package's under ``AVD_PREP=device``
(|Δai_score| <= 1e-3, the same label).
"""

import copy

import numpy as np
import pytest
import torch

from avd_tpu import native as jnative
from avd_tpu.analyzers import fusion as jfusion
from avd_tpu.analyzers import heuristics_v2 as jhx
from avd_tpu.ops import video_features as jvf
from avd_tpu_torch import config
from avd_tpu_torch.analyzers import fusion as tfusion
from avd_tpu_torch.analyzers import heuristics_v2 as thx
from avd_tpu_torch.ingest import video_reader
from avd_tpu_torch.ops import color, host_prep, laplacian
from avd_tpu_torch.ops import video_features as tvf
from tests import fixtures

torch.set_num_threads(1)
CPU = torch.device("cpu")


@pytest.fixture
def device_prep(monkeypatch):
    monkeypatch.setenv("AVD_PREP", "device")
    config.reset_config()
    yield
    monkeypatch.delenv("AVD_PREP")
    config.reset_config()


def _pan_gray(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 40, w + 40), dtype=np.uint8)
    return np.stack([base[3 * i:3 * i + h, 2 * i:2 * i + w]
                     for i in range(n)])


# At 96 rows the 32² hash plane is a mean of 12 pixels (1/3 by rows, 1/4
# by columns): exact halves occur, the float32 products land on either side
# of them by their order of sums, and the rounded plane follows.  Measured
# on this window: 60 of 7·1024 hash pixels differ between the port and the
# JAX package, and the JAX package's plane differs from a float64 product's
# in 260.  So that shape holds the Hamming distances to 1; the others, with
# no such ties, hold them exactly.
_HAM_ATOL = {(7, 96, 128): 1}


@pytest.mark.parametrize("n,h,w", [(7, 128, 128), (7, 96, 128),
                                   (5, 200, 150), (4, 320, 320)])
def test_run_window_matches_jax(n, h, w):
    window = _pan_gray(n, h, w, seed=h + w)
    ref = jvf.run_window(window)
    got = [x.numpy() for x in tvf.run_window(window, CPU,
                                             config.get_config())]
    tex, ham, fmean, fvar = got
    assert ham.dtype == np.int32
    np.testing.assert_allclose(ham, ref[1], rtol=0,
                               atol=_HAM_ATOL.get((n, h, w), 0))
    np.testing.assert_allclose(tex, ref[0], rtol=1e-5)
    np.testing.assert_allclose(fmean, ref[2], rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(fvar, ref[3], rtol=1e-4, atol=1e-6)


def test_gray_bit_exact():
    frames = fixtures.noise_clip(3, 70)
    ours = color.bgr_to_gray_u8(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(ours, jnative.bgr_to_gray(frames))
    np.testing.assert_array_equal(ours, tvf._to_gray_host(frames))
    np.testing.assert_array_equal(ours, tvf._to_gray_host(frames, False))
    assert color.bgr_to_gray_f32(torch.from_numpy(frames)).dtype == \
        torch.float32


def test_texture_variance_against_cv2():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (6, 96, 128, 3), dtype=np.uint8)
    gray = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in frames])
    ours = laplacian.texture_variance(
        torch.from_numpy(gray).float()).numpy()
    for i in range(len(frames)):
        ref = cv2.Laplacian(gray[i], cv2.CV_64F).var()
        assert abs(ours[i] - ref) < 1e-2 * max(1.0, ref)
        # and the host path's exact float64 variance
        assert abs(ours[i] - host_prep.laplacian_var(gray[i])) < \
            1e-2 * max(1.0, ref)


def test_chunk_size_shrinks_above_1080p():
    assert tvf._chunk_size(1080, 1920) == tvf._DEFAULT_CHUNK
    assert tvf._chunk_size(2160, 3840) == max(8, tvf._DEFAULT_CHUNK // 4)


_CLIPS = {
    "noise": lambda: fixtures.noise_clip(24, 128),
    "spliced": lambda: fixtures.spliced_clip(24, 128),
}


@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_device_prep_analyze_frames_matches_jax(name, device_prep):
    frames = _CLIPS[name]()[::video_reader.sampling_step(30.0)]
    dur = 24 / 30.0
    ours = tvf.analyze_frames(frames, 128, 128, 30.0, dur, device="cpu")
    ref = jvf.analyze_frames(frames, 128, 128, 30.0, dur)
    s_o, s_r = ours["summary"], ref["summary"]
    assert s_o["dup_density"] == s_r["dup_density"]
    np.testing.assert_allclose(s_o["flow_mean"], s_r["flow_mean"],
                               rtol=1e-4, atol=1e-6)
    meta = {"width": 128, "height": 128, "fps": 30.0, "bit_rate": 1_000_000}
    audio = {"scores": {}, "flags_audio": {}, "timeline": [0.5]}
    f_r = jfusion.fuse(copy.deepcopy(audio), copy.deepcopy(ref),
                       jhx.compute_hints(meta, ""))
    f_o = tfusion.fuse(copy.deepcopy(audio), copy.deepcopy(ours),
                       thx.compute_hints(meta, ""))
    assert f_o["result"]["label"] == f_r["result"]["label"]
    assert abs(np.mean(f_o["timeline_binned"])
               - np.mean(f_r["timeline_binned"])) <= 1e-3


def test_device_prep_streaming_matches_batch(device_prep, monkeypatch):
    """The streaming path pads its tail to a bucket, the batch path to the
    full chunk: the same features, the flow to float32 rounding."""
    monkeypatch.setattr(tvf, "_DEFAULT_CHUNK", 4)
    frames = fixtures.gradient_clip(90, 96)[::15]  # 6 frames: 4 + 2
    batch = tvf.compute_features(frames, device="cpu")
    stream = tvf.compute_features_streaming(
        iter([frames[:1], frames[1:5], frames[5:]]), device="cpu")
    assert batch["total"] == stream["total"] == 6
    assert batch["dup"] == stream["dup"]
    assert batch["textures"] == stream["textures"]
    np.testing.assert_allclose(stream["flow_means"], batch["flow_means"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(stream["flow_vars"], batch["flow_vars"],
                               rtol=1e-5, atol=1e-6)


def test_device_prep_differs_from_host_prep_only_in_rounding(device_prep,
                                                             monkeypatch):
    """Device prep's f32 texture and resize products against host prep's
    integer-exact planes on the same clip: texture within 1e-5, the same
    duplicates."""
    frames = fixtures.spliced_clip(24, 128)[::3]
    dev = tvf.compute_features(frames, device="cpu")
    monkeypatch.setenv("AVD_PREP", "host")
    config.reset_config()
    host = tvf.compute_features(frames, device="cpu")
    assert dev["dup"] == host["dup"]
    np.testing.assert_allclose(dev["textures"], host["textures"], rtol=1e-5,
                               atol=1e-6)
