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
