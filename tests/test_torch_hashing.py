"""Average-hash duplicates: the port is bit-exact with ``avd_tpu``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from avd_tpu.ops import hashing as jhash
from avd_tpu_torch.ops import hashing as thash

torch.set_num_threads(1)


def _planes(seed, kind, n=9):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        p = rng.integers(0, 256, (n, 32, 32))
    elif kind == "constant":  # every pixel ties the mean
        p = np.full((n, 32, 32), 77)
    elif kind == "two_level":  # many pixels sit exactly on the mean
        p = np.where(rng.random((n, 32, 32)) < 0.5, 10, 30)
        p[:, :16] = 20
    else:  # repeated frames: exact duplicates
        base = rng.integers(0, 256, (3, 32, 32))
        p = np.repeat(base, 3, axis=0)
    return p.astype(np.uint8)


@pytest.mark.parametrize("kind", ["noise", "constant", "two_level", "dups"])
def test_bits_and_hamming_bit_exact(kind):
    p = _planes(0, kind).astype(np.float32)
    bits_j = jhash.average_hash_bits(jnp.asarray(p))
    bits_t = thash.average_hash_bits(torch.from_numpy(p))
    np.testing.assert_array_equal(bits_t.numpy(), np.asarray(bits_j))
    np.testing.assert_array_equal(
        thash.consecutive_hamming(bits_t).numpy(),
        np.asarray(jhash.consecutive_hamming(bits_j)))
    assert thash.consecutive_hamming(bits_t).dtype == torch.int32


@pytest.mark.parametrize("kind", ["noise", "constant", "dups"])
def test_duplicate_count_bit_exact(kind):
    p = _planes(1, kind).astype(np.float32)
    bits_j = jhash.average_hash_bits(jnp.asarray(p))
    bits_t = thash.average_hash_bits(torch.from_numpy(p))
    assert int(thash.duplicate_count(bits_t)) == \
        int(jhash.duplicate_count(bits_j))
    valid = np.arange(p.shape[0]) < p.shape[0] - 2
    assert int(thash.duplicate_count(bits_t, torch.from_numpy(valid))) == \
        int(jhash.duplicate_count(bits_j, jnp.asarray(valid)))
