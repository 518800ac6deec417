"""The detector families' optimizer, written to optax's arithmetic.

Counterpart of ``avd_tpu/models/detector.py::make_optimizer``, which builds
``optax.adamw(schedule, weight_decay=1e-4)``, optionally behind
``optax.clip_by_global_norm`` and inside ``optax.MultiSteps``.  This module
computes the same update over a list of f32 tensors, operation by
operation, in f32:

* the schedule is evaluated at the 0-based count of applied updates, so a
  warmup's first step has learning rate 0; ``cosine`` counts the warmup
  inside the decay horizon and ends at 1 % of the peak;
* clipping scales by ``max_norm / norm`` only when the global norm is not
  below the bound (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
* Adam divides by ``sqrt(v̂) + eps`` with both moments bias-corrected by
  ``1 - b**count``; the weight decay is added to the update before the
  learning rate scales it;
* accumulation over K calls keeps the running mean of the gradients
  (``acc + (g - acc) / (n + 1)``) and leaves the parameters and the
  schedule's count alone until the K-th call.

The state is a dict of Python numbers and lists of tensors, so
``torch.save`` keeps it and ``torch.load(weights_only=True)`` restores it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

_f32 = np.float32


def _linear(count: int, init: float, end: float, steps: int):
    """``optax.linear_schedule(init, end, steps)`` at ``count``."""
    if steps <= 0:
        return _f32(init)
    c = _f32(min(max(count, 0), steps))
    frac = _f32(1) - c / _f32(steps)
    return _f32(init - end) * frac + _f32(end)


def _cosine(count: int, init: float, steps: int, alpha: float):
    """``optax.cosine_decay_schedule(init, steps, alpha)`` at ``count``."""
    c = _f32(min(count, steps))
    decay = _f32(0.5) * (_f32(1) + np.cos(_f32(math.pi) * c / _f32(steps)))
    return _f32(init) * (_f32(1 - alpha) * decay + _f32(alpha))


def make_schedule(lr: float, steps: int = 0, warmup: int = 0,
                  schedule: str = "const"):
    """count → learning rate (``np.float32``), or the float ``lr`` itself
    for a constant rate without warmup (optax then scales by the Python
    number)."""
    if schedule not in ("const", "cosine"):
        raise ValueError(f"unknown schedule {schedule!r}")
    if schedule == "cosine":
        if steps <= 0:
            raise ValueError("schedule='cosine' needs total steps")
        if not steps - warmup > 0:
            raise ValueError(
                "The cosine_decay_schedule requires positive decay_steps, "
                f"got decay_steps={steps - warmup}.")
        alpha = 0.0 if lr == 0.0 else (lr * 0.01) / lr

        def fn(count: int):
            if count < warmup:
                return _linear(count, 0.0, lr, warmup)
            return _cosine(count - warmup, lr, steps - warmup, alpha)
        return fn
    if warmup > 0:
        def fn(count: int):
            if count < warmup:
                return _linear(count, 0.0, lr, warmup)
            return _f32(lr)
        return fn
    return lr


class AdamW:
    """AdamW (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on every leaf)
    with an optional global-norm clip before it and K-step accumulation
    around both."""

    def __init__(self, lr, grad_clip: float = 0.0, accum: int = 1,
                 weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.lr = lr
        self.grad_clip = grad_clip
        self.accum = max(1, int(accum))
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, leaves: List[torch.Tensor]) -> Dict:
        zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
        state = {"count": 0, "mu": zeros,
                 "nu": [torch.zeros_like(z) for z in zeros]}
        if self.accum > 1:
            state["mini_step"] = 0
            state["acc"] = [torch.zeros_like(z) for z in zeros]
        return state

    def learning_rate(self, count: int):
        """The rate the update numbered ``count`` (0-based) applies."""
        return self.lr(count) if callable(self.lr) else self.lr

    @torch.no_grad()
    def update(self, leaves: List[torch.Tensor], grads: List[torch.Tensor],
               state: Dict, sq_sum=None) -> bool:
        """Apply one call's gradients to ``leaves`` in place; True when the
        parameters moved (always, unless a mini-step of accumulation).
        ``sq_sum(grads)`` gives the clip's squared global norm where the
        leaves are shards of a larger tree (``parallel/zero.py``); by
        default the sum of squares of ``grads`` themselves."""
        grads = [g.float() for g in grads]
        if self.accum > 1:
            n = state["mini_step"]
            acc = state["acc"]
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), float(n + 1)))
            if n < self.accum - 1:
                state["mini_step"] = n + 1
                return False
            grads = [a.clone() for a in acc]
            for a in acc:
                a.zero_()
            state["mini_step"] = 0
        if self.grad_clip > 0:
            grads = _clip_by_global_norm(grads, self.grad_clip, sq_sum)
        self._adamw(leaves, grads, state)
        return True

    def _adamw(self, leaves, grads, state) -> None:
        b1, b2 = self.b1, self.b2
        count = state["count"]
        c = count + 1
        mu = torch._foreach_mul(grads, 1 - b1)
        torch._foreach_add_(mu, torch._foreach_mul(state["mu"], b1))
        nu = torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
        torch._foreach_add_(nu, torch._foreach_mul(state["nu"], b2))
        bc1 = float(_f32(1) - _f32(b1) ** _f32(c))
        bc2 = float(_f32(1) - _f32(b2) ** _f32(c))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        torch._foreach_add_(upd, torch._foreach_mul(leaves,
                                                    self.weight_decay))
        torch._foreach_mul_(upd, -float(self.learning_rate(count)))
        torch._foreach_add_(leaves, upd)
        state["mu"], state["nu"], state["count"] = mu, nu, c


def sum_of_squares(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.stack([torch.sum(g * g) for g in grads]).sum()


def _clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                         sq_sum=None):
    """``optax.clip_by_global_norm``: ``g / norm * max_norm`` unless the
    global norm is below ``max_norm``; no host synchronisation."""
    norm = torch.sqrt((sq_sum or sum_of_squares)(grads))
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads]


def make_optimizer(lr: float = 3e-4, steps: int = 0, warmup: int = 0,
                   schedule: str = "const", grad_clip: float = 0.0,
                   accum: int = 1) -> AdamW:
    """AdamW with the trainer's controls, all default-off: ``cosine``
    (linear warmup over ``warmup`` steps, then cosine to 1 % of ``lr`` at
    ``steps``), ``const`` with ``warmup`` > 0 (linear warmup, then hold),
    ``grad_clip`` (global norm, before the Adam moments) and ``accum``
    (K calls average their gradients into one update, so accum=K at batch
    B steps like batch K·B)."""
    return AdamW(make_schedule(lr, steps, warmup, schedule),
                 grad_clip=grad_clip, accum=accum)


def ema_update(ema: List[torch.Tensor], leaves: List[torch.Tensor],
               decay: float) -> None:
    """Polyak average in place: ``decay · e + (1 - decay) · p``."""
    with torch.no_grad():
        torch._foreach_mul_(ema, decay)
        torch._foreach_add_(ema, torch._foreach_mul(leaves, 1.0 - decay))


def leaves_of(tree, out: Optional[list] = None) -> List[torch.Tensor]:
    """The tensors of a parameter tree in its insertion order (nested dicts
    and lists of dicts)."""
    out = [] if out is None else out
    items = tree.values() if isinstance(tree, dict) else tree
    for v in items:
        if isinstance(v, (dict, list)):
            leaves_of(v, out)
        else:
            out.append(v)
    return out


def unflatten(tree, leaves: List[torch.Tensor]):
    """A tree of ``tree``'s structure holding ``leaves`` in ``leaves_of``
    order (the inverse of ``leaves_of``)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(v) for k, v in node.items()}
        if isinstance(node, list):
            return [build(v) for v in node]
        return next(it)
    return build(tree)
