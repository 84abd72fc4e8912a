"""AdamW over parameter trees (a pure transform, not ``torch.optim``).

``Optimizer`` mirrors the optax contract of the JAX package:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``apply_updates`` adds them.  AdamW folds in global-norm
gradient clipping (``clip_norm``) and a learning-rate schedule (step ->
lr).  Nothing is updated in place: every call returns new tensors.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor
Schedule = Callable[[Tensor], Tensor]


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple]


def global_norm(tree) -> Tensor:
    """sqrt(Σ over leaves of Σ x²), in float32."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def _clip_by_global_norm(grads, clip_norm: Optional[float]):
    if clip_norm is None:
        return grads, torch.zeros((), dtype=torch.float32)
    norm = global_norm(grads)
    scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply_updates(params, updates):
    """params + updates, added in float32 and cast back to each param's dtype."""
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


class AdamState(NamedTuple):
    step: Tensor  # int32 0-d: updates taken so far
    m: Any
    v: Any


def adamw(
    schedule: Schedule,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
) -> Optimizer:
    """AdamW with decoupled weight decay inside the lr product:
    ``u = -lr·(m̂/(√v̂ + eps) + weight_decay·p)``, bias-corrected from the
    incremented step.  The moments m and v are kept in float32."""

    def init(params):
        z = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        step0 = tree_leaves(params)[0]
        return AdamState(
            step=torch.zeros((), dtype=torch.int32, device=step0.device),
            m=tree_map(z, params),
            v=tree_map(z, params),
        )

    def update(grads, state, params):
        grads, _ = _clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr = schedule(step)
        s = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=s.device), s)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=s.device), s)

        m = tree_map(lambda g, m: b1 * m + (1 - b1) * g.float(), grads, state.m)
        v = tree_map(lambda g, v: b2 * v + (1 - b2) * g.float().square(), grads, state.v)
        updates = tree_map(
            lambda m, v, p: -lr * ((m / c1) / ((v / c2).sqrt() + eps)
                                   + weight_decay * p.float()),
            m, v, params,
        )
        return updates, AdamState(step=step, m=m, v=v)

    return Optimizer(init=init, update=update)
