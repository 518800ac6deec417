"""The port's host-built constants equal the JAX package's builders.

The flow path carries no learned parameters; its state is the matrices and
scalars built on the host from numpy (band, resize and blur-resize
matrices, poly kernels and inverse-Gram scalars, the level plan, the
border taper).  The port keeps its own copies of those builders, so each
copy is held bit-equal to its counterpart in ``avd_tpu``.
"""

import numpy as np
import pytest
import torch

from avd_tpu.ops import band as jband
from avd_tpu.ops import flow as jflow
from avd_tpu.models import detector as jdetector
from avd_tpu.ops import resize as jresize
from avd_tpu.ops.pallas import flow_iter as jflow_iter
from avd_tpu_torch.models import detector as tdetector
from avd_tpu_torch.ops import band as tband
from avd_tpu_torch.ops import flow as tflow
from avd_tpu_torch.ops import resize as tresize
from avd_tpu_torch.ops.kernels import flow_iter as tflow_iter

torch.set_num_threads(1)

_SIZES = [(1080, 320), (720, 320), (360, 320), (128, 320), (320, 160),
          (160, 80), (80, 40), (40, 80), (1080, 32), (333, 32), (7, 3)]


@pytest.mark.parametrize("src,dst", _SIZES)
@pytest.mark.parametrize("quantize", [True, False])
def test_linear_matrix(src, dst, quantize):
    np.testing.assert_array_equal(tresize.linear_matrix(src, dst, quantize),
                                  jresize.linear_matrix(src, dst, quantize))


@pytest.mark.parametrize("src,dst", _SIZES)
def test_area_matrix(src, dst):
    np.testing.assert_array_equal(tresize.area_matrix(src, dst),
                                  jresize.area_matrix(src, dst))


@pytest.mark.parametrize("mode", ["edge", "reflect"])
def test_fold_index(mode):
    for size in (1, 2, 5, 40):
        for p in range(-12, size + 12):
            assert tband._fold_index(p, size, mode) == \
                jband._fold_index(p, size, mode), (p, size)


def _poly_taps():
    g, xg, xxg = jflow._poly_exp_kernels(5, 1.2)[:3]
    return [tuple(float(v) for v in k) for k in (g, xg, xxg)]


@pytest.mark.parametrize("size", [40, 80, 160, 320, 37])
@pytest.mark.parametrize("mode", ["edge", "reflect"])
def test_correlate_matrix(size, mode):
    for taps in _poly_taps() + [tuple([1.0] * 15)]:
        np.testing.assert_array_equal(
            tband.correlate_matrix(size, taps, mode),
            jband.correlate_matrix(size, taps, mode))


@pytest.mark.parametrize("src", [320, 160, 128])
def test_blur_resize_matrices_of_the_level_plan(src):
    for scale, sigma, ksize, lh, _ in jflow._level_plan(src, src, 0.5, 3):
        gk = tuple(float(x) for x in jflow._gaussian_blur_kernel(ksize,
                                                                 sigma))
        np.testing.assert_array_equal(
            tband.blur_resize_matrix(src, lh, gk),
            jband.blur_resize_matrix(src, lh, gk))


@pytest.mark.parametrize("n,sigma", [(5, 1.2), (7, 1.5), (3, 0.9)])
def test_poly_exp_kernels(n, sigma):
    ours = tflow._poly_exp_kernels(n, sigma)
    ref = jflow._poly_exp_kernels(n, sigma)
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert ours[3:] == ref[3:]


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (5, 0.0), (7, 0.0),
                                         (3, 0.5), (7, 1.5), (17, 3.5),
                                         (9, 0.0)])
def test_gaussian_blur_kernel(ksize, sigma):
    np.testing.assert_array_equal(tflow._gaussian_blur_kernel(ksize, sigma),
                                  jflow._gaussian_blur_kernel(ksize, sigma))


def test_cv_round():
    for x in np.arange(-5.0, 5.0, 0.25):
        assert tflow._cv_round(float(x)) == jflow._cv_round(float(x))


@pytest.mark.parametrize("h,w", [(320, 320), (160, 220), (64, 64), (40, 40),
                                 (31, 500)])
@pytest.mark.parametrize("levels", [1, 3, 5])
def test_level_plan(h, w, levels):
    assert tflow._level_plan(h, w, 0.5, levels) == \
        jflow._level_plan(h, w, 0.5, levels)


@pytest.mark.parametrize("h,w", [(320, 320), (160, 160), (80, 80), (40, 40),
                                 (8, 9), (3, 12)])
def test_border_taper(h, w):
    np.testing.assert_array_equal(tflow._border_taper(h, w),
                                  jflow._border_taper(h, w))


def test_border_scale():
    """The taper factors handed to the fused-iteration kernel are the JAX
    kernel's, and the ones the port's update arithmetic uses."""
    assert tflow_iter.BORDER_SCALE == jflow_iter._BORDER_SCALE
    np.testing.assert_array_equal(tflow._BORDER_SCALE, jflow._BORDER_SCALE)
    np.testing.assert_array_equal(
        tflow._BORDER_SCALE, np.asarray(tflow_iter.BORDER_SCALE, np.float32))
    assert tflow._BORDER == len(tflow_iter.BORDER_SCALE) == 5


@pytest.mark.parametrize("preset", sorted(jdetector.PRESETS))
def test_detector_presets(preset):
    assert sorted(tdetector.PRESETS) == sorted(jdetector.PRESETS)
    assert tdetector.PRESETS[preset] == jdetector.PRESETS[preset]
