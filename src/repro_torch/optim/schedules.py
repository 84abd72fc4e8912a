"""Learning-rate schedules: step -> lr (a float32 0-d tensor).

The step may be a Python int or an integer tensor; the lr lies on the
step's device (the CPU for an int).
"""

from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(lr: float):
    def fn(step):
        return torch.full((), lr, dtype=torch.float32, device=_step(step).device)

    return fn


def linear_warmup(lr: float, warmup: int):
    def fn(step):
        frac = torch.clamp(_step(step) / max(warmup, 1), max=1.0)
        return lr * frac

    return fn


def cosine_warmup(lr: float, warmup: int, total: int, final_frac: float = 0.1):
    def fn(step):
        s = _step(step)
        warm = torch.clamp(s / max(warmup, 1), max=1.0)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
        return lr * warm * cos

    return fn
