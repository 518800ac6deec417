"""The fusion core on tensors, batched over clips.

Counterpart of ``avd_tpu/ops/fusion_jax.py``.  The served fusion runs on
the host in float64 (``analyzers/fusion.py``: exact, and timelines are
tiny); this is the same arithmetic as differentiable tensor ops over a
batch of clips at once, on any device: the weights, penalties and
real-footage bonuses of the reference's fuse, the fused timeline, score,
spread-based confidence and the 3-tap binning.  Labels and reasons (string
logic) stay on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch


@dataclasses.dataclass(frozen=True)
class FusionInputs:
    """Per-clip scalar features of the mixture logic, each a [B] tensor."""

    speech_ratio: torch.Tensor
    tts_like: torch.Tensor
    compression_heavy: torch.Tensor  # bool: heavy/very_heavy
    bpp: torch.Tensor
    dup_avg: torch.Tensor
    flow_mean: torch.Tensor
    texture_var: torch.Tensor
    scene_change_rate: torch.Tensor
    dup_density: torch.Tensor


def _where(cond, a, b):
    return torch.where(cond, torch.as_tensor(a, dtype=torch.float32),
                       torch.as_tensor(b, dtype=torch.float32))


def fuse_timelines(a: torch.Tensor, v: torch.Tensor,
                   f: FusionInputs) -> Dict[str, torch.Tensor]:
    """Fuse equal-length audio and video timelines [B, T] → the fused
    quantities per clip: ``timeline`` and ``timeline_binned`` [B, T],
    ``ai_score`` and ``confidence`` [B] (unrounded), ``peaks_mask``
    [B, T], with the reference's arithmetic (fusion.py:26-107)."""
    a = a.float()
    v = v.float()
    a_mean, v_mean = a.mean(dim=-1), v.mean(dim=-1)
    w_audio = torch.full_like(a_mean, 0.65)
    w_video = torch.full_like(a_mean, 0.25)
    agree = torch.sign(a_mean - 0.5) == torch.sign(v_mean - 0.5)
    bonus_agree = _where(agree, 0.10, 0.0)

    low_speech = f.speech_ratio < 0.25
    w_audio = torch.where(low_speech, w_audio * 0.6, w_audio)
    w_video = torch.where(low_speech, torch.clamp(
        1.0 - w_audio - bonus_agree, min=0.2), w_video)

    penalties = (_where(f.compression_heavy, 0.05, 0.0)
                 + _where(f.bpp < 0.07, 0.05, 0.0)
                 + _where(f.dup_avg > 0.2, 0.05, 0.0))

    real_bonus = (
        _where((f.flow_mean > 5.0) & (f.texture_var > 200.0)
               & (f.dup_density < 0.05), -0.10, 0.0)
        + _where(f.scene_change_rate > 0.7, -0.05, 0.0)
        + _where((f.scene_change_rate >= 0.9) & (f.texture_var > 300.0)
                 & (f.dup_density < 0.02), -0.08, 0.0))

    damp = ((f.tts_like >= 0.95) & (f.flow_mean > 8.0)
            & (f.texture_var > 300.0) & (f.dup_density < 0.05))
    w_audio = torch.where(damp, w_audio * 0.55, w_audio)
    w_video = torch.where(damp, torch.clamp(
        1.0 - w_audio - bonus_agree, min=0.25), w_video)

    fused = (w_audio[:, None] * a + w_video[:, None] * v
             + bonus_agree[:, None] * (a + v) / 2.0
             - penalties[:, None] + real_bonus[:, None])
    fused = torch.clamp(fused, 0.0, 1.0)

    peaks_mask = (fused <= 0.25) | (fused >= 0.75)
    score = fused.mean(dim=-1)
    spread = fused.std(dim=-1, unbiased=False)
    disagree = torch.abs(a_mean - v_mean)
    confidence = torch.clamp(
        0.20 + 2.2 * spread - penalties
        - 0.5 * torch.clamp(0.3 - disagree, min=0.0), 0.10, 0.99)
    return {"timeline": fused, "timeline_binned": bin_timeline(fused),
            "ai_score": score, "confidence": confidence,
            "peaks_mask": peaks_mask}


def bin_timeline(t: torch.Tensor) -> torch.Tensor:
    """3-tap zero-padded moving average over the last axis (fusion.py:7-14)
    for T >= 3; shorter timelines pass through like the reference."""
    if t.shape[-1] < 3:
        return torch.clamp(t, 0.0, 1.0)
    zero = torch.zeros_like(t[..., :1])
    left = torch.cat([zero, t[..., :-1]], dim=-1)
    right = torch.cat([t[..., 1:], zero], dim=-1)
    return torch.clamp((left + t + right) / 3.0, 0.0, 1.0)
