"""Optimizers (functional over parameter trees) and learning-rate schedules."""

from repro_torch.optim.optimizers import (
    AdamState,
    Optimizer,
    adamw,
    apply_updates,
    global_norm,
)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup

__all__ = [
    "AdamState",
    "Optimizer",
    "adamw",
    "apply_updates",
    "constant",
    "cosine_warmup",
    "global_norm",
    "linear_warmup",
]
