"""Slot-indexed decode-state cache for continuous batching.

The engine holds ONE cache dict with a slot axis on every per-request leaf
(``lm_init_caches`` with ``batch = max_slots``).  A slot is the unit of
admission: prefill produces a batch-1 cache for a request and
``write_slot`` splices it in without touching the other slots.

Layout (the structure ``lm_prefill`` returns):

  caches["group"]  leaves  [n_groups, run_len, slots, ...]   (slot axis 2)
  caches["tail"]   leaves  [slots, ...]                      (slot axis 0)

``caches["group"]`` holds one state per run of ``schedule_runs``, each of
its own backend's type (a hybrid schedule mixes ``TaylorState`` and
``KVCache``); every slot operation walks each run's state alike.

``write_slot`` and ``clear_slot`` update the cache IN PLACE (the JAX
package donates the buffer for the same effect) and return it;
``read_slot`` and ``corrupt_slot`` return copies.  ``slot_health`` is the
per-slot finiteness sweep the engine's resilience boundary runs.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.backends import get_backend, resolve_backend
from repro_torch.models.config import ModelConfig, schedule_runs
from repro_torch.models.lm import lm_init_caches
from repro_torch.tree import tree_leaves

Tensor = torch.Tensor

GROUP_SLOT_AXIS = 2
TAIL_SLOT_AXIS = 0


def _map(fn: Callable, caches, *others) -> Dict[str, Any]:
    """Apply ``fn(leaf, *other_leaves, axis)`` to every state leaf, the
    int ``KVCache.length`` included; each state keeps its own NamedTuple
    type."""

    def one(key, axis):
        out = []
        for parts in zip(caches[key], *(o[key] for o in others)):
            out.append(type(parts[0])(*(
                None if leaves[0] is None else fn(*leaves, axis)
                for leaves in zip(*parts)
            )))
        return tuple(out)

    return {
        "group": one("group", GROUP_SLOT_AXIS),
        "tail": one("tail", TAIL_SLOT_AXIS),
        "kv_src": None,
    }


def slot_state_kinds(cfg: ModelConfig) -> Dict[str, str]:
    """Per-block-kind decode-state kinds of this config's cache.

    ``"kv"`` leaves are O(n_max) per slot (or O(window) for a ring),
    ``"moments"`` O(1) in context length.  Under a hybrid schedule a block
    kind can hold several state kinds at once; they are joined with "+" in
    first-appearance pattern order, e.g. ``{"attn": "moments+kv"}``.

    Returns:
      ``{block_kind: state_kind}`` for every kind of the pattern and tail.
    """
    resolve_backend(cfg)  # fail fast on an unservable default backend/impl
    out: Dict[str, str] = {}

    def add(kind, state_kind):
        kinds = out[kind].split("+") if kind in out else []
        if state_kind not in kinds:
            kinds.append(state_kind)
        out[kind] = "+".join(kinds)

    for kind, bk in zip(cfg.pattern, cfg.pattern_backends):
        add(kind, get_backend(bk).state_kind)
    for kind in cfg.tail:
        add(kind, get_backend(cfg.attention).state_kind)
    return out


def slot_bytes(caches, max_slots: int) -> int:
    """Decode-state bytes held per slot: every leaf carries the slot axis,
    so the cache's bytes over ``max_slots`` (the marginal memory of one
    admitted request)."""
    total = sum(x.numel() * x.element_size() for x in tree_leaves(caches))
    return total // max_slots


def init_slot_caches(cfg: ModelConfig, max_slots: int, n_max: int, device=None):
    """Zero slotted decode cache with ``max_slots`` batch rows.

    Validates the backend first, so an unservable config fails at engine
    construction."""
    resolve_backend(cfg)
    return lm_init_caches(cfg, max_slots, n_max, device)


def write_slot(caches, request_caches, slot: int):
    """Splice a batch-1 request cache into slot ``slot`` (in place)."""

    def put(full: Tensor, one: Tensor, axis: int) -> Tensor:
        full.narrow(axis, slot, 1).copy_(one)
        return full

    return _map(put, caches, request_caches)


def clear_slot(caches, slot: int):
    """Zero one slot's state (in place)."""

    def zero(full: Tensor, axis: int) -> Tensor:
        full.narrow(axis, slot, 1).zero_()
        return full

    return _map(zero, caches)


def read_slot(caches, slot: int):
    """One slot as a batch-1 cache (a copy)."""
    return _map(lambda full, axis: full.narrow(axis, slot, 1).clone(), caches)


def slot_health(caches, cfg: ModelConfig) -> Tensor:
    """Per-slot health of the whole slotted cache (the corruption sweep).

    Applies each run's backend ``state_health`` (finite moments / KV plus
    the backend's invariants, e.g. KV ``length`` bounds) with the group
    runs' stacking axes folded into the batch axis, then AND-reduces every
    layer of a slot.

    Args:
      caches: the slotted cache (``init_slot_caches`` / ``lm_prefill``
        layout).
      cfg: model config (decides each run's backend).

    Returns:
      ``[max_slots]`` bool — True where every leaf of that slot's state is
      healthy; a False slot must be quarantined before its next token is
      trusted.
    """
    parts = []
    for (_, bk, _), state in zip(schedule_runs(cfg), caches["group"]):
        rcfg = cfg.layer_cfg(bk)
        g, r, n_slots = next(x for x in state if x is not None).shape[:3]
        # [n_groups, run_len, slots, ...] -> [slots * n_groups * run_len, ...]
        flat = type(state)(*(
            None if x is None else x.movedim(GROUP_SLOT_AXIS, 0).reshape(
                (n_slots * g * r,) + x.shape[3:])
            for x in state
        ))
        h = resolve_backend(rcfg).state_health(flat, rcfg)
        parts.append(h.reshape(n_slots, g * r).all(dim=1))
    tail_cfg = cfg.layer_cfg(cfg.attention)
    for state in caches["tail"]:
        parts.append(resolve_backend(tail_cfg).state_health(state, tail_cfg))
    ok = parts[0]
    for p in parts[1:]:
        ok = ok & p
    return ok


def corrupt_slot(caches, slot: int, fill: float):
    """Copy of the cache with slot ``slot``'s floating leaves set to ``fill``.

    The fault-injection primitive behind ``serve.faults.SlotCorruption``
    (``fill`` NaN or Inf).  It poisons exactly the leaves ``slot_health``
    checks for finiteness: int leaves (KV ``length``) and every other slot
    stay bit-identical.  Out of place: ``caches`` is not modified.
    """

    def poison(full: Tensor, axis: int) -> Tensor:
        out = full.clone()
        if out.is_floating_point():
            out.narrow(axis, slot, 1).fill_(fill)
        return out

    return _map(poison, caches)


def select_slots(mask: Tensor, new, old):
    """Per-slot select between two slotted caches: ``new`` where ``mask``
    ([slots] bool) is True, ``old`` elsewhere."""

    def sel(n: Tensor, o: Tensor, axis: int) -> Tensor:
        shape = [1] * n.ndim
        shape[axis] = mask.shape[0]
        return torch.where(mask.reshape(shape), n, o)

    return _map(sel, new, old)
