"""Plain PyTorch training steps of the ViT detector, float32: the loss of
``vit.loss``, its gradients by autograd, and AdamW (b1 0.9, b2 0.999, eps
1e-8, weight decay 1e-4 on every leaf, applied as ``lr·(m̂/(√v̂+eps) +
wd·p)``) under the recipe's schedule: a linear warm-up from 0 over
``warmup`` updates, then a cosine to 1 % of ``lr`` at ``steps``.  It
follows the optax semantics the port's trainer was built to, and imports
nothing of the program."""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from . import vit


def lr_at(count: int, lr: float, steps: int, warmup: int) -> float:
    if count < warmup:
        return lr * count / warmup
    c = min(count - warmup, steps - warmup)
    return lr * (0.99 * 0.5 * (1 + math.cos(math.pi * c / (steps - warmup)))
                 + 0.01)


class Trainer:
    """The reference's parameters, moments and step count."""

    def __init__(self, params: Dict, recipe: Dict, heads: int, patch: int,
                 dtype=torch.float32):
        self.params = params
        self.names = [n for n, _ in vit.named(params)]
        self.leaves: List[torch.Tensor] = [p for _, p in vit.named(params)]
        self.m = [torch.zeros_like(p) for p in self.leaves]
        self.v = [torch.zeros_like(p) for p in self.leaves]
        self.count = 0
        self.recipe, self.heads, self.patch, self.dtype = (recipe, heads,
                                                           patch, dtype)

    def step(self, frames, labels, keep: int = 0):
        """One update; returns (loss, the gradient leaves).  ``keep`` > 0
        trains on the batch's first ``keep`` rows alone (a planted fault:
        half of the batch left out)."""
        r = self.recipe
        if keep:
            frames, labels = frames[:keep], labels[:keep]
        for p in self.leaves:
            p.requires_grad_(True)
        lval = vit.loss(self.params, frames, labels, self.heads, self.patch,
                        r["logit_l2"], self.dtype)
        grads = torch.autograd.grad(lval, self.leaves)
        b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-4
        c = self.count + 1
        lr = lr_at(self.count, r["lr"], r["steps"], r["warmup"])
        with torch.no_grad():
            for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
                m.mul_(b1).add_(g, alpha=1 - b1)
                v.mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m / (1 - b1 ** c)) / ((v / (1 - b2 ** c)).sqrt() + eps)
                p.add_(upd + wd * p, alpha=-lr)
        self.count = c
        return float(lval.detach()), grads
