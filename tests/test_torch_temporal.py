"""The temporal detector of the port (CPU) against
``avd_tpu.models.temporal``.

The same numpy inputs go through both packages: the time encoding and the
attention cores within f32 rounding, the forward (masked and not, with the
per-frame head) and ``forward_clip`` on converted seeded parameters and on
the shipped ``temporal_small`` within the bf16 atol/rtol 2e-2 of
``tests/test_pallas_attention.py``.  The port's own properties at the
bounds of ``tests/test_temporal.py``: padding masked out of attention
moves no real frame (atol 1e-5), window scores do not depend on the clip's
length, and the streaming slabs give the batch path's scores (1e-6).  A
tree of the template before the per-frame head raises the one-line error
``avd_tpu``'s loader raises.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avd_tpu.models import scoring as jscoring
from avd_tpu.models import temporal as jtemporal
from avd_tpu.parallel import attention as jattn
from avd_tpu_torch.analyzers import video as video_an
from avd_tpu_torch.models import convert, scoring
from avd_tpu_torch.models import temporal as ttemporal
from avd_tpu_torch.parallel import attention as tattn

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_WEIGHTS = os.path.join(REPO, "avd_tpu", "models", "weights")
_PORT_WEIGHTS = os.path.join(REPO, "avd_tpu_torch", "models", "weights")
_TINY = dict(image_size=32, width=64, depth=2, frame_depth=2, heads=2)
_DET_ENV = ("AVD_DETECTOR", "AVD_DETECTOR_BLEND", "AVD_DETECTOR_ARCH",
            "AVD_DETECTOR_PRESET", "AVD_DETECTOR_CKPT", "AVD_DETECTOR_TEMP",
            "AVD_DETECTOR_QUANT", "AVD_DETECTOR_EXPORTED", "AVD_ATTN_FUSED",
            "AVD_TEMPORAL_WINDOW", "AVD_DETECTOR_SLAB")


@jax.jit
def _jax_forward(params, frames, mask):
    cfg = jtemporal.TemporalConfig(**_TINY)
    return jtemporal.forward(params, frames, cfg, mask=mask,
                             return_aux=True)


@pytest.fixture
def env(monkeypatch):
    for name in _DET_ENV:
        monkeypatch.delenv(name, raising=False)
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()
    yield monkeypatch
    scoring._bundle.cache_clear()
    jscoring._bundle.cache_clear()


@pytest.fixture(scope="module")
def tiny():
    """Seeded JAX parameters of the tiny config and their conversion."""
    jcfg = jtemporal.TemporalConfig(**_TINY)
    jp = jtemporal.init_params(jax.random.PRNGKey(0), jcfg)
    tcfg = ttemporal.TemporalConfig(**_TINY)
    tp = convert.from_jax_params(jax.tree_util.tree_map(np.asarray, jp),
                                 tcfg)
    return jp, tp, tcfg


def _clip(b, t, size, seed=1):
    return np.random.default_rng(seed).random((b, t, size, size, 3),
                                              np.float32)


@pytest.mark.parametrize("t0,n,d", [(0, 6, 64), (7, 32, 256), (40, 5, 384)])
def test_time_encoding_matches(t0, n, d):
    want = np.asarray(jtemporal._time_encoding(jnp.int32(t0), n, d))
    got = ttemporal._time_encoding(t0, n, d)
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, d)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_attention_cores_match():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 3, 9, 16)).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jattn.full_attention(*map(jnp.asarray, (q, k, v))))
    got = tattn.full_attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    mask = np.arange(9)[None].repeat(2, 0) < np.array([[6], [9]])
    want = np.asarray(jtemporal.masked_attention(jnp.asarray(mask))(
        *map(jnp.asarray, (q, k, v))))
    got = ttemporal.masked_attention(torch.from_numpy(mask))(
        *map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
    # bf16 in, bf16 out
    qb = torch.from_numpy(q).bfloat16()
    assert tattn.full_attention(qb, qb, qb).dtype == torch.bfloat16


def test_param_shapes_are_the_jax_tree():
    for kw in (_TINY, {}, dict(jtemporal.PRESETS["full"])):
        jp = jax.eval_shape(lambda: jtemporal.init_params(
            jax.random.PRNGKey(0), jtemporal.TemporalConfig(**kw)))
        want = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
        assert ttemporal.param_shapes(ttemporal.TemporalConfig(**kw)) == want


@pytest.mark.parametrize("masked", [False, True])
def test_forward_and_aux_match_avd_tpu(tiny, masked):
    jp, tp, cfg = tiny
    frames = _clip(2, 7, 32)
    mask = np.arange(7)[None].repeat(2, 0) < np.array([[7], [4]])
    want, want_aux = _jax_forward(jp, jnp.asarray(frames),
                                  jnp.asarray(mask) if masked else None)
    got, aux = ttemporal.forward(
        ttemporal.cast_for_inference(tp, "cpu"), torch.from_numpy(frames),
        cfg, mask=torch.from_numpy(mask) if masked else None,
        return_aux=True)
    assert got.dtype == aux.dtype == torch.float32
    assert tuple(got.shape) == tuple(aux.shape) == (2, 7, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), atol=2e-2,
                               rtol=2e-2)


def test_forward_clip_matches_avd_tpu(tiny):
    jp, tp, cfg = tiny
    frames = _clip(1, 9, 32, seed=4)[0]
    mask = np.arange(9) < 6
    jcfg = jtemporal.TemporalConfig(**_TINY)
    want = np.asarray(jax.jit(jtemporal.forward_clip, static_argnums=2)(
        jp, jnp.asarray(frames), jcfg, jnp.asarray(mask)))
    got = ttemporal.forward_clip(tp, torch.from_numpy(frames), cfg,
                                 mask=torch.from_numpy(mask))
    assert tuple(got.shape) == (9, 1)
    np.testing.assert_allclose(got.numpy()[:6], want[:6], atol=2e-2,
                               rtol=2e-2)


def test_masked_forward_ignores_padding(tiny):
    """As tests/test_temporal.py:202-212: real frames' scores equal with
    and without masked tail padding; unmasked padding moves them."""
    _, tp, cfg = tiny
    frames = torch.from_numpy(_clip(1, 6, 32, seed=5))
    ref = ttemporal.forward(tp, frames, cfg)[:, :6]
    pad = torch.cat([frames, frames[:, -1:].repeat(1, 4, 1, 1, 1)], dim=1)
    mask = (torch.arange(10) < 6)[None]
    out = ttemporal.forward(tp, pad, cfg, mask=mask)[:, :6]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-5)
    nomask = ttemporal.forward(tp, pad, cfg)[:, :6]
    assert float((nomask - ref).abs().max()) > 1e-5


def test_shipped_temporal_small_logits_match_avd_tpu():
    jcfg = jtemporal.make_config("small")
    tcfg = ttemporal.make_config("small")
    like = jtemporal.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jtemporal.load_checkpoint(os.path.join(_JAX_WEIGHTS,
                                                "temporal_small"), like)
    tp = convert.load_npz(os.path.join(_PORT_WEIGHTS, "temporal_small",
                                       convert.PARAMS_FILE), tcfg)
    frames = _clip(1, 12, 64, seed=6)[0]
    mask = np.arange(12) < 10
    want = np.asarray(jax.jit(jtemporal.forward_clip, static_argnums=2)(
        jp, jnp.asarray(frames), jcfg, jnp.asarray(mask)))
    got = ttemporal.forward_clip(ttemporal.cast_for_inference(tp, "cpu"),
                                 torch.from_numpy(frames), tcfg,
                                 mask=torch.from_numpy(mask)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[:10], want[:10], atol=2e-2, rtol=2e-2)


def test_served_timeline_matches_avd_tpu(env):
    """Both packages' detector timelines on one clip of 40 frames with the
    shipped temporal_small: two windows of 32, the second padded and
    masked."""
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_ARCH", "temporal")
    frames = np.random.default_rng(7).integers(0, 256, (40, 48, 64, 3),
                                               np.uint8)
    got = scoring.detector_timeline(frames, device="cpu")
    want = jscoring.detector_timeline(frames)
    assert "temporal_small" in got["weights"]
    assert got["weights"].replace(_PORT_WEIGHTS, _JAX_WEIGHTS) == \
        want["weights"]
    np.testing.assert_allclose(got["timeline"], want["timeline"], atol=2e-2)


def test_window_scoring_independent_of_clip_length(env):
    """As tests/test_temporal.py:231-247: with AVD_TEMPORAL_WINDOW=8 the
    first 40 frames score the same in a 40- and a 72-frame clip."""
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_ARCH", "temporal")
    env.setenv("AVD_TEMPORAL_WINDOW", "8")
    frames = np.random.default_rng(3).integers(0, 255, (72, 48, 64, 3),
                                               np.uint8)
    short = scoring.detector_timeline(frames[:40], device="cpu")
    long = scoring.detector_timeline(frames, device="cpu")
    assert scoring.clip_window("cpu") == 8
    np.testing.assert_allclose(short["timeline"][:40], long["timeline"][:40],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("slab", ["16", "40"])
def test_streaming_slabs_equal_the_batch_path(env, slab):
    """Chunks through ``_DetAccum``: only whole windows flush mid-stream,
    so the streaming timeline equals the batch path's within 1e-6."""
    env.setenv("AVD_DETECTOR", "1")
    env.setenv("AVD_DETECTOR_ARCH", "temporal")
    env.setenv("AVD_TEMPORAL_WINDOW", "8")
    env.setenv("AVD_DETECTOR_SLAB", slab)
    frames = np.random.default_rng(8).integers(0, 256, (45, 48, 64, 3),
                                               np.uint8)
    flushed = []
    real = scoring.detector_timeline_resized

    def spy(resized, device=None):
        flushed.append(resized.shape[0])
        return real(resized, device=device)

    env.setattr(scoring, "detector_timeline_resized", spy)
    acc = video_an._DetAccum("cpu")
    for i in range(0, 45, 13):
        acc.add(frames[i:i + 13])
    got = acc.result()
    assert all(n % 8 == 0 for n in flushed[:-1]) and sum(flushed) == 45
    assert len(flushed) > 1
    env.setattr(scoring, "detector_timeline_resized", real)
    want = scoring.detector_timeline(frames, device="cpu")
    assert got["weights"] == want["weights"]
    np.testing.assert_allclose(got["timeline"], want["timeline"], rtol=0,
                               atol=1e-6)


def test_a_tree_of_the_old_template_raises_the_one_line_error(tiny,
                                                               tmp_path):
    _, tp, _ = tiny
    cfg = ttemporal.make_config("small")
    full = ttemporal.init_params(0, cfg)
    no_aux = {k: v for k, v in full.items() if k not in ("aux_w", "aux_b")}
    two = dict(no_aux, frame_layers=full["frame_layers"][:2])
    for tree in (no_aux, two):
        with pytest.raises(ValueError, match="pre-round-4 temporal"):
            convert.from_jax_params(tree, cfg)
    path = str(tmp_path / convert.PARAMS_FILE)
    convert.save_npz(path, two, cfg)
    with pytest.raises(ValueError, match=f"{path} holds a pre-round-4"):
        convert.load_npz(path, cfg)
    # the current template loads
    convert.save_npz(path, full, cfg)
    assert sorted(convert.load_npz(path, cfg)) == sorted(full)
