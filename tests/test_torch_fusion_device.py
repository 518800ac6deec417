"""The tensor fusion core (``avd_tpu_torch/ops/fusion_device.py``) against
``avd_tpu/ops/fusion_jax.py`` vmapped over the same clips: within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avd_tpu.ops import fusion_jax
from avd_tpu_torch.ops import fusion_device


def _inputs(rng, b):
    return dict(
        speech_ratio=rng.random(b).astype(np.float32),
        tts_like=rng.choice([0.0, 0.5, 0.97], b).astype(np.float32),
        compression_heavy=rng.random(b) < 0.5,
        bpp=rng.choice([0.03, 0.1, 0.3], b).astype(np.float32),
        dup_avg=rng.choice([0.0, 0.1, 0.3], b).astype(np.float32),
        flow_mean=rng.choice([1.0, 6.0, 9.0], b).astype(np.float32),
        texture_var=rng.choice([100.0, 250.0, 400.0], b).astype(np.float32),
        scene_change_rate=rng.choice([0.1, 0.8, 0.95], b).astype(np.float32),
        dup_density=rng.choice([0.0, 0.03, 0.2], b).astype(np.float32))


@pytest.mark.parametrize("t", [1, 2, 3, 17])
def test_fuse_timelines_matches_fusion_jax(t):
    rng = np.random.default_rng(t)
    b = 64
    a = rng.random((b, t)).astype(np.float32)
    v = rng.random((b, t)).astype(np.float32)
    feats = _inputs(rng, b)
    ref = jax.vmap(fusion_jax.fuse_timelines)(
        jnp.asarray(a), jnp.asarray(v),
        fusion_jax.FusionInputs(**{k: jnp.asarray(x)
                                   for k, x in feats.items()}))
    got = fusion_device.fuse_timelines(
        torch.from_numpy(a), torch.from_numpy(v),
        fusion_device.FusionInputs(**{k: torch.from_numpy(np.asarray(x))
                                      for k, x in feats.items()}))
    assert set(got) == set(ref)
    for k in ref:
        want = np.asarray(ref[k])
        out = got[k].numpy()
        assert out.shape == want.shape, k
        if want.dtype == bool:
            np.testing.assert_array_equal(out, want)
        else:
            np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)


def test_bin_timeline_matches():
    x = np.random.default_rng(0).random((3, 9)).astype(np.float32)
    want = np.stack([np.asarray(fusion_jax.bin_timeline(jnp.asarray(r)))
                     for r in x])
    np.testing.assert_allclose(
        fusion_device.bin_timeline(torch.from_numpy(x)).numpy(), want,
        atol=1e-7)
