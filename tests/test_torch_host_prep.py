"""The port's numpy host prep is bit-exact with ``avd_tpu``'s.

``avd_tpu.ops.video_features._host_prep`` takes the native C++ sweep for
frames larger than 320 on both sides and cv2 (320² bilinear) plus the
native Laplacian/area pass otherwise; the port has one numpy
implementation of the same integer semantics.  The 320² and 32² planes
must be equal and the texture equal to rtol 1e-12, on downscale and on
upscale.
"""

import numpy as np
import pytest

from avd_tpu.ops import video_features as jvf
from avd_tpu_torch.ops import host_prep

_SHAPES = [(360, 640), (128, 128), (1080, 1920), (720, 1280), (241, 333),
           (96, 128), (500, 200), (33, 47)]


def _frames(seed, h, w, n=3):
    rng = np.random.default_rng(seed)
    f = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    f[0] = f[0] // 64 * 64  # a posterized frame: many equal neighbours
    return f


@pytest.mark.parametrize("h,w", _SHAPES)
def test_host_prep_bit_exact(h, w):
    frames = _frames(h * 7 + w, h, w)
    ref320, ref32, ref_tex = jvf._host_prep(frames)
    s320, s32, tex = host_prep.host_prep(frames)
    assert s320.dtype == np.uint8 and s32.dtype == np.uint8
    np.testing.assert_array_equal(s320, ref320)
    np.testing.assert_array_equal(s32, ref32)
    np.testing.assert_allclose(tex, ref_tex, rtol=1e-12)


def test_single_thread_equals_threaded():
    frames = _frames(1, 200, 360, n=4)
    a = host_prep.host_prep(frames, threads=1)
    b = host_prep.host_prep(frames, threads=4)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_gray_and_laplacian_match_cv2():
    cv2 = pytest.importorskip("cv2")
    frame = _frames(2, 90, 130, n=1)[0]
    gray = host_prep.to_gray(frame)
    np.testing.assert_array_equal(gray,
                                  cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY))
    ref = cv2.Laplacian(gray, cv2.CV_64F).var()
    assert host_prep.laplacian_var(gray) == pytest.approx(ref, rel=1e-12)


def test_too_small_frames_raise():
    with pytest.raises(ValueError, match="at least"):
        host_prep.host_prep(np.zeros((1, 31, 64, 3), np.uint8))
