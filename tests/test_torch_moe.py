"""The Switch-MoE ViT of the port (CPU) against ``avd_tpu.models.detector``.

* On the shipped ``moe_small`` the top-1 expert of every token in every
  layer equals ``avd_tpu``'s exactly: both route on the embedding
  recomputed in f32 with the logits snapped to the 1/4 grid.
* ``_moe_mlp``'s dispatch and combine equal the per-token loop of
  ``tests/test_moe.py:39-84`` (its numpy reference and bounds), and a
  token past its expert's capacity passes through with a zero delta.
* The logits are within the bf16 atol/rtol 2e-2 of
  ``tests/test_pallas_attention.py``, with the einsum attention and with
  the fused one (its plain version on the CPU; avd_tpu's Pallas kernel in
  interpret mode).
"""

import functools
import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from avd_tpu.models import detector as jdet
from avd_tpu.ops.pallas import attention as pattn
from avd_tpu_torch.models import convert
from avd_tpu_torch.models import detector as tdet

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_JAX_WEIGHTS = os.path.join(REPO, "avd_tpu", "models", "weights")
_PORT_WEIGHTS = os.path.join(REPO, "avd_tpu_torch", "models", "weights")


@pytest.fixture(scope="module")
def shipped():
    """avd_tpu's moe_small tree and the port's committed conversion."""
    jcfg = jdet.make_config("moe_small")
    like = jdet.init_params(jax.random.PRNGKey(0), jcfg)
    jp = jdet.load_checkpoint(os.path.join(_JAX_WEIGHTS, "moe_small"), like)
    tcfg = tdet.make_config("moe_small")
    tp = convert.load_npz(os.path.join(_PORT_WEIGHTS, "moe_small",
                                       convert.PARAMS_FILE), tcfg)
    frames = np.random.default_rng(12).random((6, 64, 64, 3), np.float32)
    return jp, tp, jcfg, tcfg, frames


def _jax_indices(params, frames, cfg):
    rx = jdet._router_features(params, jnp.asarray(frames), cfg)
    return np.stack([np.asarray(jnp.argmax(jnp.round(
        (rx @ lp["router_w"]) * jdet._ROUTER_GRID), axis=-1))
        for lp in params["layers"]])


def test_expert_choices_equal_avd_tpu_on_moe_small(shipped):
    jp, tp, jcfg, tcfg, frames = shipped
    want = _jax_indices(jp, frames, jcfg)
    for tree in (tp, tdet.cast_for_inference(tp, "cpu")):
        got = tdet.expert_indices(tree, torch.from_numpy(frames), tcfg)
        assert tuple(got.shape) == (tcfg.depth, 6, tcfg.tokens)
        np.testing.assert_array_equal(got.numpy(), want)
    # the routing input itself, in f32
    rx_j = np.asarray(jdet._router_features(jp, jnp.asarray(frames), jcfg))
    rx_t = tdet._router_features(tdet.cast_for_inference(tp, "cpu"),
                                 torch.from_numpy(frames), tcfg)
    assert rx_t.dtype == torch.float32
    np.testing.assert_allclose(rx_t.numpy(), rx_j, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_moe_small_logits_match_avd_tpu(shipped, fused):
    jp, tp, jcfg, tcfg, frames = shipped
    jcfg_f = jdet.make_config("moe_small", fused_attn=fused)
    orig = pattn.attention
    try:
        if fused:
            pattn.attention = functools.partial(orig, interpret=True)
        want = np.asarray(jax.jit(jdet.forward, static_argnums=2)(
            jp, jnp.asarray(frames), jcfg_f))
    finally:
        pattn.attention = orig
    cfg = tdet.make_config("moe_small", fused_attn=fused)
    got = tdet.forward(tdet.cast_for_inference(tp, "cpu"),
                       torch.from_numpy(frames), cfg).numpy()
    assert np.all(np.isfinite(got)) and got.shape == (6, 1)
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2e-2)


def _moe_case(seed=1, B=2, T=5, D=8, E=4, H=16):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((B, T, D)).astype(np.float32)
    lp = {"router_w": 10.0 * rng.standard_normal((D, E)).astype(np.float32),
          "moe_in_w": rng.standard_normal((E, D, H)).astype(np.float32)
          * 0.3,
          "moe_in_b": np.zeros((E, H), np.float32),
          "moe_out_w": rng.standard_normal((E, H, D)).astype(np.float32)
          * 0.3,
          "moe_out_b": np.zeros((E, D), np.float32)}
    return h, lp


def _loop_reference(hq, lp, C):
    """The per-token loop of tests/test_moe.py:39-84."""
    B, T, D = hq.shape
    E = lp["router_w"].shape[1]
    ref = np.zeros((B, T, D), np.float32)
    for b in range(B):
        counts = {e: 0 for e in range(E)}
        logits = hq[b] @ lp["router_w"]
        gate = np.exp(logits - logits.max(-1, keepdims=True))
        gate /= gate.sum(-1, keepdims=True)
        for t in range(T):
            e = int(np.argmax(gate[t]))
            if counts[e] >= C:
                continue  # dropped: the residual passes it through
            counts[e] += 1
            z = hq[b, t] @ lp["moe_in_w"][e]
            z = z * 0.5 * (1 + np.vectorize(math.erf)(z / np.sqrt(2)))
            ref[b, t] = gate[t, e] * (z @ lp["moe_out_w"][e])
    return ref


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_dispatch_and_combine_equal_the_loop_reference(capacity_factor):
    """Through ``_moe_mlp`` routing on ``h`` (no router input), as the JAX
    test calls it; at capacity factor 0.5 one of a group's five tokens
    fits each expert and the rest are dropped."""
    cfg = tdet.ViTConfig(image_size=32, patch=16, width=256, depth=2,
                         heads=4, n_experts=4,
                         capacity_factor=capacity_factor)
    h, lp = _moe_case()
    C = cfg.expert_capacity
    assert cfg.tokens == 5 and C == (1 if capacity_factor == 0.5 else 2)
    hb = torch.from_numpy(h).bfloat16()
    y, aux = tdet._moe_mlp(hb, {k: torch.from_numpy(v)
                                for k, v in lp.items()}, cfg)
    y = y.float().numpy()
    ref = _loop_reference(hb.float().numpy(), lp, C)
    np.testing.assert_allclose(y, ref, atol=0.15, rtol=0.05)
    # and avd_tpu's own _moe_mlp on the same inputs
    jcfg = jdet.ViTConfig(image_size=32, patch=16, width=256, depth=2,
                          heads=4, n_experts=4,
                          capacity_factor=capacity_factor)
    jy, jaux = jdet._moe_mlp(jnp.asarray(h, jnp.bfloat16),
                             {k: jnp.asarray(v) for k, v in lp.items()},
                             jcfg, lambda x, s: x)
    np.testing.assert_allclose(y, np.asarray(jy, np.float32), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def test_capacity_drops_pass_through():
    """Every token routed to one expert: the first C of each example get
    a delta, the rest exactly zero (the residual carries them)."""
    cfg = tdet.ViTConfig(image_size=64, patch=16, width=32, depth=1,
                         heads=2, n_experts=4)
    C, T = cfg.expert_capacity, cfg.tokens
    assert (T, C) == (17, 6)
    rng = np.random.default_rng(5)
    lp = {"router_w": np.zeros((32, 4), np.float32),
          "moe_in_w": rng.standard_normal((4, 32, 128)).astype(np.float32),
          "moe_in_b": np.zeros((4, 128), np.float32),
          "moe_out_w": rng.standard_normal((4, 128, 32)).astype(np.float32),
          "moe_out_b": np.zeros((4, 32), np.float32)}
    lp["router_w"][:, 2] = 1.0  # expert 2 wins for positive features
    lp = {k: torch.from_numpy(v) for k, v in lp.items()}
    h = torch.from_numpy(rng.random((3, T, 32)).astype(np.float32) + 0.5)
    y = tdet._moe_mlp(h.bfloat16(), lp, cfg)[0].float()
    kept = y[:, :C].abs().sum(dim=-1)
    assert bool((kept > 0).all())
    assert torch.equal(y[:, C:], torch.zeros_like(y[:, C:]))
    # a tie on the snapped grid goes to the lowest expert index
    logits, eidx = tdet._route(torch.zeros((1, 2, 32)),
                               torch.zeros((32, 4)))
    assert eidx.tolist() == [[0, 0]]
