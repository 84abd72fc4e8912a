"""Optimizers (functional over parameter trees) and learning-rate schedules."""

from repro_torch.optim.optimizers import (
    AdafactorState,
    AdamState,
    FactoredV,
    Optimizer,
    SgdState,
    adafactor,
    adamw,
    apply_updates,
    global_norm,
    make_optimizer,
    sgdm,
)
from repro_torch.optim.schedules import constant, cosine_warmup, linear_warmup

__all__ = [
    "AdafactorState",
    "AdamState",
    "FactoredV",
    "Optimizer",
    "SgdState",
    "adafactor",
    "adamw",
    "apply_updates",
    "constant",
    "cosine_warmup",
    "global_norm",
    "linear_warmup",
    "make_optimizer",
    "sgdm",
]
