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


@pytest.mark.parametrize("arch", ["cnn", "temporal"])
def test_family_presets_and_defaults(arch):
    """Each family's presets and config defaults are avd_tpu's.  The port
    leaves out only the training-only loss weight of the temporal family
    (``aux_frame_loss``); the training slice adds it back."""
    import dataclasses

    from avd_tpu import models as jmodels
    from avd_tpu_torch import models as tmodels
    j, t = jmodels.family(arch), tmodels.family(arch)
    assert t.PRESETS == j.PRESETS
    for preset in j.PRESETS:
        jc, tc = j.make_config(preset), t.make_config(preset)
        names = {f.name for f in dataclasses.fields(tc)}
        assert {f.name for f in dataclasses.fields(jc)} - names == \
            ({"aux_frame_loss"} if arch == "temporal" else set())
        assert {n: getattr(jc, n) for n in names} == \
            {n: getattr(tc, n) for n in names}


def test_moe_routing_constants():
    assert tdetector._ROUTER_GRID == jdetector._ROUTER_GRID
    j, t = jdetector.make_config("moe_small"), tdetector.make_config(
        "moe_small")
    assert t.capacity_factor == j.capacity_factor
    assert t.expert_capacity == j.expert_capacity == 6
    for cf in (0.5, 1.0, 2.0):
        assert tdetector.make_config("moe_small", capacity_factor=cf) \
            .expert_capacity == jdetector.make_config(
                "moe_small", capacity_factor=cf).expert_capacity


def test_quant_key_lists():
    from avd_tpu.models import quant as jquant
    from avd_tpu_torch.models import quant as tquant
    assert tquant._VIT_LAYER_KEYS == jquant._VIT_LAYER_KEYS
    assert tquant._CNN_BLOCK_KEYS == jquant._CNN_BLOCK_KEYS



# ---------------------------------------------------------------------------
# the file path's copied tables and builders
# ---------------------------------------------------------------------------

def test_bmff_tag_tables():
    from avd_tpu.ingest import bmff as jbmff
    from avd_tpu_torch.ingest import bmff as tbmff
    for name in ("_CONTAINERS", "_META", "_C2PA_UUID", "_UDTA_KEYS",
                 "_QT_KEYS", "_MAX_METADATA_BOX", "_MAX_DEPTH"):
        assert getattr(tbmff, name) == getattr(jbmff, name), name


def test_meta_keys_and_timeouts():
    from avd_tpu.analyzers import meta as jmeta
    from avd_tpu.ingest import audio_reader as jaudio
    from avd_tpu.ingest import probe as jprobe
    from avd_tpu_torch.analyzers import meta as tmeta
    from avd_tpu_torch.ingest import audio_reader as taudio
    from avd_tpu_torch.ingest import probe as tprobe
    assert tmeta._DEVICE_KEYS == jmeta._DEVICE_KEYS
    assert tmeta._EXIFTOOL_TIMEOUT_S == jmeta._EXIFTOOL_TIMEOUT_S
    assert tprobe._FFPROBE_TIMEOUT_S == jprobe._FFPROBE_TIMEOUT_S
    assert tprobe._empty_meta() == jprobe._empty_meta()
    assert list(tprobe._empty_meta()) == list(jprobe._empty_meta())
    assert taudio.TARGET_SR == jaudio.TARGET_SR
    for code in (0, -1, 0x7634706D, 0x31637661, 0x20202020):
        assert tprobe._fourcc_name(code) == jprobe._fourcc_name(code)


@pytest.mark.parametrize("duration", [0.0, 0.4, 0.5, 1.5, 2.5, 7.2, None])
def test_neutral_results(duration):
    from avd_tpu import pipeline as jpipeline
    from avd_tpu.analyzers import audio as jaudio
    from avd_tpu.analyzers import video as jvideo
    from avd_tpu_torch import pipeline as tpipeline
    from avd_tpu_torch.analyzers import audio as taudio
    from avd_tpu_torch.analyzers import video as tvideo
    meta = {"duration": duration}
    exc = TimeoutError()
    assert tpipeline._neutral_audio(meta, exc) == \
        jpipeline._neutral_audio(meta, exc)
    assert tpipeline._neutral_video(meta, exc) == \
        jpipeline._neutral_video(meta, exc)
    assert taudio._neutral(meta, "x") == jaudio._neutral(meta, "x")
    assert tvideo._empty_result() == jvideo._empty_result()


@pytest.mark.parametrize("fps", [0.0, 1.0, 2.0, 5.0, 12.0, 23.976, 25.0,
                                 29.97, 30.0, 59.94, 60.0, 120.0])
def test_sampling_step(fps):
    from avd_tpu.ingest import video_reader as jreader
    from avd_tpu_torch.ingest import video_reader as treader
    assert treader.sampling_step(fps) == jreader.sampling_step(fps)


@pytest.mark.parametrize("chunk", [48, 24, 7, 1])
def test_window_buckets(chunk):
    from avd_tpu.ops import video_features as jvf
    from avd_tpu_torch.ops import video_features as tvf
    assert tvf._window_buckets(chunk) == jvf._window_buckets(chunk)
    for n in range(1, chunk + 3):
        assert tvf._bucket_len(n, chunk) == jvf._bucket_len(n, chunk)
    assert tvf._DEFAULT_CHUNK == jvf._DEFAULT_CHUNK


def test_cli_and_oracle_tables():
    from avd_tpu import analyze as jcli
    from avd_tpu.oracle import video_ref as jref
    from avd_tpu_torch import analyze as tcli
    from avd_tpu_torch.oracle import video_ref as tref
    assert tcli._VIDEO_EXTS == jcli._VIDEO_EXTS
    assert tref.FARNEBACK_PARAMS == jref.FARNEBACK_PARAMS


def test_native_decode_structs():
    from avd_tpu.native import decode as jdecode
    from avd_tpu_torch.native import decode as tdecode
    for name in ("MediaInfoStruct", "ProbeInfoStruct"):
        assert getattr(tdecode, name)._fields_ == \
            getattr(jdecode, name)._fields_, name


def _code(module, strip_docstrings=False) -> str:
    """A module's code: without its module docstring, or as an AST dump
    without any docstring and with the port's package name folded."""
    import ast
    import inspect
    src = inspect.getsource(module)
    if not strip_docstrings:
        return "\n".join(src.splitlines()[ast.parse(src).body[0].end_lineno:])
    tree = ast.parse(src.replace("avd_tpu_torch", "avd_tpu"))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            node.body = body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_serving_copies_and_tables():
    """The stdlib serving modules are copies: ``serve/http.py`` the same
    code, the resolver the same but for docstrings and package names, the
    client the same public surface; the batcher's ladder, the master's
    control signals and the app's service name are ``avd_tpu``'s."""
    from avd_tpu import client as jclient
    from avd_tpu.ingest import url as jurl
    from avd_tpu.serve import app as japp
    from avd_tpu.serve import batching as jbatching
    from avd_tpu.serve import http as jhttp
    from avd_tpu.serve import master as jmaster
    from avd_tpu_torch import client as tclient
    from avd_tpu_torch.ingest import url as turl
    from avd_tpu_torch.serve import app as tapp
    from avd_tpu_torch.serve import batching as tbatching
    from avd_tpu_torch.serve import http as thttp
    from avd_tpu_torch.serve import master as tmaster
    assert _code(thttp) == _code(jhttp)
    assert _code(turl, True) == _code(jurl, True)
    for name in ("Client", "AnalysisResult", "APIError", "ClientError"):
        assert sorted(vars(getattr(tclient, name))) == \
            sorted(vars(getattr(jclient, name)))
    assert tbatching._BUCKETS == jbatching._BUCKETS
    assert tbatching.WindowBatcher._IDLE_EXIT_S == \
        jbatching.WindowBatcher._IDLE_EXIT_S
    assert (tmaster._SIG_RECYCLE, tmaster._SIG_READY) == \
        (jmaster._SIG_RECYCLE, jmaster._SIG_READY)
    assert tapp.SERVICE_NAME == japp.SERVICE_NAME
