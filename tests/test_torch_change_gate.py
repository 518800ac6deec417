"""The change gate (``AVD_CHANGE_GATE=1``) of the port against ``avd_tpu``.

On ``tests/test_change_gate.py``'s three clips (static, dynamic, mixed)
with its tolerances: ``skipped_pairs`` and the duplicates equal, flow
stats of the moving pairs at rtol 1e-5 / atol 1e-6 (the gated path runs
the same flow as the ungated one), textures equal, gated pairs exactly 0.
"""

import numpy as np
import pytest
import torch

from avd_tpu.ops import video_features as jvf
from avd_tpu_torch import config
from avd_tpu_torch.ops import video_features as tvf
from tests import fixtures

torch.set_num_threads(1)


def _mixed():
    rng = np.random.default_rng(5)
    base = rng.integers(0, 255, (64, 64, 3)).astype(np.uint8)
    return np.stack([base] * 10
                    + [np.roll(base, i * 3, axis=1) for i in range(10)])


_CLIPS = {
    "static": lambda: fixtures.solid_clip(40, 64),
    "dynamic": lambda: fixtures.noise_clip(14, 64),
    "mixed": _mixed,
}


def _gated(monkeypatch, fn, clip, gate="1"):
    monkeypatch.setenv("AVD_CHANGE_GATE", gate)
    config.reset_config()
    try:
        return fn(clip)
    finally:
        monkeypatch.delenv("AVD_CHANGE_GATE")
        config.reset_config()


@pytest.mark.parametrize("name", sorted(_CLIPS))
def test_gate_matches_jax(monkeypatch, name):
    clip = _CLIPS[name]()
    ref = _gated(monkeypatch, jvf.compute_features, clip)
    ours = _gated(monkeypatch,
                  lambda c: tvf.compute_features(c, device="cpu"), clip)
    assert ours["skipped_pairs"] == ref["skipped_pairs"]
    assert ours["total"] == ref["total"] and ours["dup"] == ref["dup"]
    assert ours["textures"] == ref["textures"]
    for key in ("flow_means", "flow_vars"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                   atol=1e-6)
        skipped = np.asarray(ref[key]) == 0.0
        assert (np.asarray(ours[key])[skipped] == 0.0).all()
    np.testing.assert_allclose(ours["timeline_ai"], ref["timeline_ai"],
                               atol=1e-6)


def test_gate_off_by_default_and_skips_on_static(monkeypatch):
    monkeypatch.delenv("AVD_CHANGE_GATE", raising=False)
    config.reset_config()
    assert not config.get_config().change_gate
    clip = fixtures.solid_clip(12, 64)
    plain = tvf.compute_features(clip, device="cpu")
    assert "skipped_pairs" not in plain
    gated = _gated(monkeypatch,
                   lambda c: tvf.compute_features(c, device="cpu"), clip)
    assert gated["skipped_pairs"] == 11
    assert gated["dup"] == plain["dup"]
    assert gated["textures"] == plain["textures"]


def test_gate_threshold_is_read(monkeypatch):
    """A threshold above every pair's mean |Δ| gates the dynamic clip
    too."""
    monkeypatch.setenv("AVD_CHANGE_GATE_THR", "300")
    try:
        out = _gated(monkeypatch,
                     lambda c: tvf.compute_features(c, device="cpu"),
                     fixtures.noise_clip(5, 64))
    finally:
        monkeypatch.delenv("AVD_CHANGE_GATE_THR")
        config.reset_config()
    assert out["skipped_pairs"] == 4
    assert out["flow_means"] == [0.0] * 4


def test_flow_pairs_match_the_window_path():
    """``flow_pairs`` on explicit pairs equals the window path's flow for
    the same consecutive frames."""
    rng = np.random.default_rng(2)
    planes = rng.integers(0, 256, (4, 320, 320), dtype=np.uint8)
    vec = tvf.flow_pairs(planes[:-1], planes[1:], torch.device("cpu"),
                         config.get_config()).numpy()
    _, fmean, fvar = tvf._prep_body(
        torch.from_numpy(planes), torch.from_numpy(planes[:, :32, :32]),
        config.get_config())
    np.testing.assert_array_equal(vec, np.concatenate([fmean.numpy(),
                                                       fvar.numpy()]))
