"""AdamW in plain PyTorch, float32, as the cells state it: the gradient
clipped to a global norm first, moments bias-corrected from the step,
decoupled weight decay inside the learning-rate product:

    p -= lr · (m̂ / (√v̂ + eps) + weight_decay · p)
"""

from __future__ import annotations

from typing import List

import torch

Tensor = torch.Tensor


class AdamW:
    def __init__(self, leaves: List[Tensor], lr: float, b1: float, b2: float, eps: float,
                 weight_decay: float, clip_norm: float):
        self.leaves = leaves
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.wd, self.clip = weight_decay, clip_norm
        self.m = [torch.zeros_like(p) for p in leaves]
        self.v = [torch.zeros_like(p) for p in leaves]
        self.t = 0

    @torch.no_grad()
    def clip_grads(self, grads: List[Tensor]) -> List[Tensor]:
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        scale = torch.clamp(self.clip / torch.clamp(norm, min=1e-9), max=1.0)
        return [g * scale for g in grads]

    @torch.no_grad()
    def step(self, grads: List[Tensor]) -> None:
        """Updates the leaves in place with the clipped ``grads``."""
        self.t += 1
        c1, c2 = 1.0 - self.b1**self.t, 1.0 - self.b2**self.t
        for p, g, m, v in zip(self.leaves, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            p.sub_(self.lr * ((m / c1) / ((v / c2).sqrt() + self.eps) + self.wd * p))
