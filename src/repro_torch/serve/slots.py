"""Slot-indexed decode-state cache for continuous batching.

The engine holds ONE cache dict with a slot axis on every per-request leaf
(``lm_init_caches`` with ``batch = max_slots``).  A slot is the unit of
admission: prefill produces a batch-1 cache for a request and
``write_slot`` splices it in without touching the other slots.

Layout (the structure ``lm_prefill`` returns):

  caches["group"]  leaves  [n_groups, run_len, slots, ...]   (slot axis 2)
  caches["tail"]   leaves  [slots, ...]                      (slot axis 0)
  caches["kv_src"] [slots, m, d] or None                     (slot axis 0)

``caches["group"]`` holds one state per run of ``schedule_runs``, each of
its own backend's type (a hybrid schedule mixes ``TaylorState`` and
``KVCache``, a Mamba2 hybrid adds ``MambaCache``, a cross block holds the
pair of its self state and its ``CrossCache``); every slot operation walks
each run's state alike, and the cross source ``kv_src`` of the vlm and
encdec families with them.

``write_slot`` and ``clear_slot`` update the cache IN PLACE (the JAX
package donates the buffer for the same effect) and return it;
``read_slot`` and ``corrupt_slot`` return copies.

On a mesh (``init_slot_caches(mesh=, rules=)``) each rank holds only its
block of every leaf, as ``distributed.sharding.slot_cache_specs`` names
it, and the ops take the cache's ``Placements``: a leaf whose slot axis
splits over "data" is written, cleared or poisoned only by the rank that
owns the slot (the others leave their block as it is), one that holds
every slot (a quantised leaf's replicated scale) by every rank, and
``read_slot`` hands the owner's row to every rank (one all-gather over
"data", which every rank calls).  ``slot_health`` is the
per-slot finiteness sweep the engine's resilience boundary runs.  The
splice, zero, read, poison and select ops also walk a quantised stored
tree (``QuantizedLeaf`` payloads and scales keep the slot axis); the
engine reaches them through ``SlotStateStore`` (``serve/state_repr.py``,
re-exported here), which owns the slot cache's storage representation.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict

import torch

from repro_torch.backends import get_backend, resolve_backend, state_backend, tree_slot_health
from repro_torch.distributed import collectives as col
from repro_torch.models.config import ModelConfig, schedule_runs
from repro_torch.models.lm import lm_init_caches
from repro_torch.tree import tree_leaves, tree_map

Tensor = torch.Tensor

GROUP_SLOT_AXIS = 2
TAIL_SLOT_AXIS = 0
_FP8 = (torch.float8_e4m3fn,)


def _map(fn: Callable, caches, *others) -> Dict[str, Any]:
    """Apply ``fn(leaf, *other_leaves, axis)`` to every state leaf, the
    int ``KVCache.length`` and ``kv_src`` included; each state keeps its own
    type.  Nested tuples (a cross block's pair, the ``QuantizedLeaf``
    payload/scale pairs of a stored tree) are walked too: their leaves keep
    the dense leaf's slot axis."""

    def node(axis, *parts):
        if parts[0] is None:
            return None
        if isinstance(parts[0], tuple):
            kids = (node(axis, *xs) for xs in zip(*parts))
            return type(parts[0])(*kids) if hasattr(parts[0], "_fields") else tuple(kids)
        return fn(*parts, axis)

    def one(key, axis):
        return tuple(node(axis, *parts)
                     for parts in zip(caches[key], *(o[key] for o in others)))

    return {
        "group": one("group", GROUP_SLOT_AXIS),
        "tail": one("tail", TAIL_SLOT_AXIS),
        "kv_src": node(TAIL_SLOT_AXIS, caches.get("kv_src"),
                       *(o.get("kv_src") for o in others)),
    }


def slot_state_kinds(cfg: ModelConfig) -> Dict[str, str]:
    """Per-block-kind decode-state kinds of this config's cache.

    ``"kv"`` leaves are O(n_max) per slot (or O(window) for a ring),
    ``"moments"`` and ``"ssm"`` O(1) in context length.  An ``"moe"`` or
    ``"shared_attn"`` block keeps its attention's state, as an ``"attn"``
    block does; a ``"mamba"`` block the ``"ssm"`` state.  Under a hybrid schedule a block
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

    ssm_kind = get_backend("ssm").state_kind
    for kind, bk in zip(cfg.pattern, cfg.pattern_backends):
        add(kind, ssm_kind if kind == "mamba" else get_backend(bk).state_kind)
    for kind in cfg.tail:
        add(kind, ssm_kind if kind == "mamba" else get_backend(cfg.attention).state_kind)
    return out


def slot_bytes(caches, max_slots: int) -> int:
    """Decode-state bytes held per slot: every leaf carries the slot axis,
    so the cache's bytes over ``max_slots`` (the marginal memory of one
    admitted request)."""
    total = sum(x.numel() * x.element_size() for x in tree_leaves(caches))
    return total // max_slots


def init_slot_caches(cfg: ModelConfig, max_slots: int, n_max: int, device=None, mesh=None,
                     rules=None):
    """Zero slotted decode cache with ``max_slots`` batch rows; on a mesh this
    rank's block of it (``slot_cache_specs`` under ``rules``).

    Validates the backend first, so an unservable config fails at engine
    construction."""
    resolve_backend(cfg)
    if mesh is None:
        return lm_init_caches(cfg, max_slots, n_max, device)
    from repro_torch.distributed.sharding import slot_cache_specs  # noqa: PLC0415 (cycle)

    return _local_zeros(lm_init_caches(cfg, max_slots, n_max, "meta"),
                       slot_cache_specs(cfg, max_slots, n_max, mesh, rules), mesh, device)


def _local_zeros(shapes, specs, mesh, device):
    """Zeros of each leaf's block (``shapes``: whole leaves, e.g. on the meta
    device; ``specs`` congruent)."""
    from repro_torch.distributed.sharding import block_shape  # noqa: PLC0415 (cycle)

    return tree_map(lambda x, s: torch.zeros(block_shape(x.shape, s, mesh), dtype=x.dtype,
                                             device=device), shapes, specs)


def _owned(full: Tensor, spec, axis: int, slot: int, placements):
    """This rank's index of ``slot`` in a leaf's block, or None where
    another rank of the slot axis holds it."""
    entry = spec[axis] if placements is not None and len(spec) > axis else None
    if not entry:
        return slot
    lo = col.axis_rank(placements.mesh, entry) * full.shape[axis]
    return slot - lo if lo <= slot < lo + full.shape[axis] else None


def _specs(caches, placements):
    return caches if placements is None else placements.specs


def write_slot(caches, request_caches, slot: int, placements=None):
    """Splice a batch-1 request cache into slot ``slot`` (in place).  With
    ``placements`` (a sharded cache's), the request cache is this rank's
    block of it apart from the slot axis."""

    def put(full: Tensor, one: Tensor, spec, axis: int) -> Tensor:
        i = _owned(full, spec, axis, slot, placements)
        if i is not None:
            full.narrow(axis, i, 1).copy_(one)
        return full

    return _map(put, caches, request_caches, _specs(caches, placements))


def clear_slot(caches, slot: int, placements=None):
    """Zero one slot's state (in place)."""

    def zero(full: Tensor, spec, axis: int) -> Tensor:
        i = _owned(full, spec, axis, slot, placements)
        if i is not None:
            full.narrow(axis, i, 1).zero_()
        return full

    return _map(zero, caches, _specs(caches, placements))


def read_slot(caches, slot: int, placements=None):
    """One slot as a batch-1 cache (a copy).  With ``placements`` every rank
    gets the owner's row: each rank offers its row at the slot's local
    index, and the owner's is kept from their all-gather."""

    def take(full: Tensor, spec, axis: int) -> Tensor:
        entry = spec[axis] if placements is not None and len(spec) > axis else None
        if not entry:
            return full.narrow(axis, slot, 1).clone()
        n = full.shape[axis]
        rows = col.gather_values(full.narrow(axis, slot % n, 1), axis, placements.mesh, entry)
        return rows.narrow(axis, slot // n, 1).clone()

    return _map(take, caches, _specs(caches, placements))


def slot_health(caches, cfg: ModelConfig) -> Tensor:
    """Per-slot health of the whole slotted cache (the corruption sweep).

    Applies each run's backend ``state_health`` (finite moments / KV /
    SSD state plus the backend's invariants, e.g. KV ``length`` bounds; a
    mamba run's from the "ssm" backend; a cross block's to its self state
    AND its source state) with the group runs' stacking axes folded into
    the batch axis, then AND-reduces every layer of a slot and the
    finiteness of ``kv_src``.

    Args:
      caches: the slotted cache (``init_slot_caches`` / ``lm_prefill``
        layout).
      cfg: model config (decides each run's backend).

    Returns:
      ``[max_slots]`` bool — True where every leaf of that slot's state is
      healthy; a False slot must be quarantined before its next token is
      trusted.
    """
    def health(kind, rcfg, state):
        backend = state_backend(kind, rcfg)
        if kind == "cross":
            self_state, cc = state
            return backend.state_health(self_state, rcfg) & backend.state_health(cc.kv, rcfg)
        return backend.state_health(state, rcfg)

    parts = []
    for (kind, bk, _), state in zip(schedule_runs(cfg), caches["group"]):
        g, r, n_slots = tree_leaves(state)[0].shape[:3]
        # [n_groups, run_len, slots, ...] -> [slots * n_groups * run_len, ...]
        flat = tree_map(lambda x: x.movedim(GROUP_SLOT_AXIS, 0).reshape(
            (n_slots * g * r,) + x.shape[3:]), state)
        h = health(kind, cfg.layer_cfg(bk), flat)
        parts.append(h.reshape(n_slots, g * r).all(dim=1))
    tail_cfg = cfg.layer_cfg(cfg.attention)
    for kind, state in zip(cfg.tail, caches["tail"]):
        parts.append(health(kind, tail_cfg, state))
    if caches.get("kv_src") is not None:
        parts.append(tree_slot_health(caches["kv_src"]))
    ok = parts[0]
    for p in parts[1:]:
        ok = ok & p
    return ok


def corrupt_slot(caches, slot: int, fill: float, placements=None):
    """Copy of the cache with slot ``slot``'s floating leaves set to ``fill``.

    The fault-injection primitive behind ``serve.faults.SlotCorruption``
    (``fill`` NaN or Inf).  It poisons exactly the leaves ``slot_health``
    checks for finiteness: int leaves (KV ``length``) and every other slot
    stay bit-identical.  Out of place: ``caches`` is not modified.
    """

    def poison(full: Tensor, spec, axis: int) -> Tensor:
        out = full.clone()
        i = _owned(full, spec, axis, slot, placements)
        if i is None:
            return out
        if out.dtype in _FP8:
            # float8_e4m3fn has no inf: a non-finite fill is stored as NaN,
            # the JAX package's cast of inf to it
            out.narrow(axis, i, 1).fill_(fill if math.isfinite(fill) else math.nan)
        elif out.is_floating_point():
            out.narrow(axis, i, 1).fill_(fill)
        return out

    return _map(poison, caches, _specs(caches, placements))


def select_slots(mask: Tensor, new, old):
    """Per-slot select between two slotted caches: ``new`` where ``mask``
    ([slots] bool) is True, ``old`` elsewhere."""

    def sel(n: Tensor, o: Tensor, axis: int) -> Tensor:
        shape = [1] * n.ndim
        shape[axis] = mask.shape[0]
        if n.dtype in _FP8:  # selected through the bits, which is exact
            return torch.where(mask.reshape(shape), n.view(torch.uint8),
                               o.view(torch.uint8)).view(n.dtype)
        return torch.where(mask.reshape(shape), n, o)

    return _map(sel, new, old)


def __getattr__(name: str):
    """Re-export the slot-state representation layer: the quantise and
    dequantise boundary lives at the slot layer, but ``SlotStateStore`` and
    ``make_state_store`` are defined in ``serve/state_repr.py`` (which
    builds on this module's splice and zero ops) and surfaced here lazily
    to avoid a circular import."""
    if name in ("SlotStateStore", "make_state_store"):
        from repro_torch.serve import state_repr  # noqa: PLC0415 (cycle)

        return getattr(state_repr, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
