"""The attention kernel's plain version (avd_tpu_torch) against the JAX
package's Pallas kernel in interpret mode and its einsum reference.

Inputs are rounded to bf16 once in numpy, so both packages get the same
values.  Tolerance atol/rtol 2e-2 on bf16 (tests/test_pallas_attention.py);
the measured max |Δ| is one bf16 ulp of the output (3.9e-3 at |o| < 1,
7.8e-3 above).
"""


import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avd_tpu.ops.pallas import attention as pattn
from avd_tpu_torch.models import detector as tdetector
from avd_tpu_torch.ops.kernels import attention as tattn

torch.set_num_threads(1)

_SHAPES = [(2, 17, 3, 8), (1, 197, 6, 64)]


def _qkv(shape, seed=0):
    """Three [B, T, H, D] arrays of bf16 values held as float32."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        x = rng.normal(0, 1, shape).astype(np.float32)
        out.append(np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32))
    return out


def _einsum_reference(q, k, v):
    """The einsum pair of models/detector.py::block_forward_aux."""
    b, t, h, d = q.shape
    att = jnp.einsum("bthd,bshd->bhts", q, k,
                     preferred_element_type=jnp.float32)
    att = jax.nn.softmax(att / np.sqrt(d), axis=-1)
    o = jnp.einsum("bhts,bshd->bthd", att.astype(jnp.bfloat16), v,
                   preferred_element_type=jnp.float32)
    return o.reshape(b, t, h * d).astype(jnp.bfloat16)


def _torch(x):
    return torch.from_numpy(x).to(torch.bfloat16)


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("ref", ["pallas_interpret", "einsum"])
def test_attention_plain_matches_avd_tpu(shape, ref):
    q, k, v = _qkv(shape)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    if ref == "einsum":
        want = _einsum_reference(jq, jk, jv)
    else:
        want = pattn.attention(jq, jk, jv, interpret=True)
    want = np.asarray(want, np.float32)
    got = tattn.attention_plain(_torch(q), _torch(k), _torch(v))
    assert got.dtype == torch.bfloat16
    b, t, h, d = shape
    assert tuple(got.shape) == (b, t, h * d)
    np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("shape", _SHAPES)
def test_mha_plain_is_the_head_major_form(shape):
    q, k, v = (_torch(x) for x in _qkv(shape, seed=1))
    b, t, h, d = shape
    o = tattn.mha_plain(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2))
    assert tuple(o.shape) == (b, h, t, d) and o.dtype == torch.bfloat16
    assert torch.equal(o.transpose(1, 2).reshape(b, t, h * d),
                       tattn.attention_plain(q, k, v))
    want = np.asarray(pattn.mha(*(jnp.asarray(x.transpose(1, 2).float()
                                              .numpy(), jnp.bfloat16)
                                  for x in (q, k, v)), interpret=True),
                      np.float32)
    np.testing.assert_allclose(o.float().numpy(), want, atol=2e-2, rtol=2e-2)


def test_rows_of_p_sum_to_one_before_the_bf16_rounding():
    """A constant V comes back unchanged up to the rounding of P: the
    softmax is normalised before P is cast to bf16."""
    q, k, _ = (_torch(x) for x in _qkv((1, 33, 2, 16), seed=2))
    v = torch.full((1, 33, 2, 16), 0.5, dtype=torch.bfloat16)
    o = tattn.attention_plain(q, k, v).float()
    assert float((o - 0.5).abs().max()) <= 2 ** -8


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = (_torch(x) for x in _qkv((2, 17, 3, 8), seed=3))
    before = tattn.LAUNCHES
    o = tattn.attention(q, k, v)
    o2 = tattn.mha(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    assert tattn.LAUNCHES == before == 0
    assert torch.equal(o, tattn.attention_plain(q, k, v))
    assert torch.equal(o2, tattn.mha_plain(q.transpose(1, 2),
                                           k.transpose(1, 2),
                                           v.transpose(1, 2)))


def _preset_shape(preset):
    """(tokens, head dim) of a detector preset: ``moe_small`` attends at
    [B, 4, 17, 64], as ``small`` does."""
    cfg = tdetector.make_config(preset)
    return cfg.tokens, cfg.head_dim


@pytest.mark.parametrize("preset", sorted(tdetector.PRESETS))
def test_variant_sends_every_preset_to_the_tensor_core_kernel(preset):
    t, d = _preset_shape(preset)
    assert (t, d) in {(17, 64), (197, 64)}
    assert tattn.variant(t, d) == "mma"


@pytest.mark.parametrize("t,d,want", [
    (65, 64, "mma"),                       # the 128 px training size
    (17, 8, "mma"), (197, 64, "mma"),      # _SHAPES above
    (33, 16, "mma"), (1, 16, "mma"),
    (16, 128, "mma"), (208, 128, "mma"), (208, 8, "mma"),
    (209, 64, "general"), (300, 40, "general"), (4000, 64, "general"),
])
def test_variant_is_a_function_of_the_shape_alone(t, d, want):
    assert tattn.MMA_MAX_TOKENS == 208
    assert tattn.variant(t, d) == want
    assert tattn.variant(t, d) == want  # no state between calls


@pytest.mark.parametrize("d", [0, 4, 12, 136, 256])
def test_variant_refuses_a_head_dim_the_kernels_do_not_take(d):
    with pytest.raises(ValueError, match="multiple of 8"):
        tattn.variant(17, d)


def _tile_walk_model(q, k, v, tile=16):
    """The tensor-core kernel's walk over one [B, H, T, D] problem, in plain
    torch: keys and values padded with zero rows to a multiple of 16, query
    rows taken 16 at a time (the last tile zero-padded), scores scaled in
    f32, padded key columns set to −∞, exact row softmax normalised by one
    reciprocal per row, P rounded to bf16, f32 sums, bf16 output; rows past
    T are dropped."""
    b, h, t, d = q.shape
    tp = -(-t // tile) * tile
    pad = (0, 0, 0, tp - t)
    qp, kp, vp = (torch.nn.functional.pad(x.float(), pad) for x in (q, k, v))
    scale = float(1.0 / np.sqrt(d))
    dead = torch.arange(tp) >= t
    out = torch.empty((b, h, tp, d), dtype=torch.bfloat16)
    for r0 in range(0, tp, tile):
        s = (qp[:, :, r0:r0 + tile] @ kp.mT) * scale
        s = s.masked_fill(dead, float("-inf"))
        e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
        p = (e * (1.0 / e.sum(dim=-1, keepdim=True))).bfloat16()
        assert not p[..., dead].any()
        out[:, :, r0:r0 + tile] = (p.float() @ vp).bfloat16()
    return out[:, :, :t]


def _bf16_ulp(x):
    """The spacing of bf16 values at |x| (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
                      - 7)


@pytest.mark.parametrize("t", [16, 17, 33, 197])
def test_tile_walk_model_matches_mha_plain(t):
    d = 64 if t == 197 else 16
    q, k, v = (_torch(x).transpose(1, 2)
               for x in _qkv((2, t, 2, d), seed=10 + t))
    want = tattn.mha_plain(q, k, v).float()
    got = _tile_walk_model(q, k, v).float()
    assert got.shape == want.shape
    ulp = _bf16_ulp(torch.maximum(got.abs(), want.abs()))
    assert bool(((got - want).abs() <= ulp).all())


def test_an_unmasked_pad_column_would_show():
    """The model without its −∞ mask is visibly wrong at T = 17: the check
    above can see the fault it guards against."""
    q, k, v = (_torch(x).transpose(1, 2)
               for x in _qkv((1, 17, 2, 16), seed=4))
    want = tattn.mha_plain(q, k, v).float()
    pad = (0, 0, 0, 15)
    kp, vp = (torch.nn.functional.pad(x, pad) for x in (k, v))
    unmasked = tattn.mha_plain(torch.nn.functional.pad(q, pad), kp,
                               vp)[:, :, :17].float()
    assert float((unmasked - want).abs().max()) > 2e-2


def test_cpu_calls_count_no_variant_launch():
    q, k, v = (_torch(x) for x in _qkv((1, 17, 2, 8), seed=5))
    before = dict(tattn.VARIANT_LAUNCHES)
    tattn.attention(q, k, v)
    assert tattn.VARIANT_LAUNCHES == before == {"mma": 0, "general": 0}
