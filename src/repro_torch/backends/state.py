"""Decode-state containers shared by the attention backends.

``TaylorState`` (the moment state) lives in ``core/taylor.py``; the KV
backends (softmax, linear_elu, softmax_window) keep a ``KVCache``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.tree import tree_leaves

Tensor = torch.Tensor


def tree_slot_health(tree) -> Tensor:
    """Per-batch-row finiteness of a decode state.

    Every floating leaf is checked with ``torch.isfinite`` reduced over its
    non-batch axes; integer leaves (e.g. ``KVCache.length``) are skipped —
    bounds on those are backend semantics, not finiteness.

    Args:
      tree: decode state whose tensor leaves share a leading batch
        (serving-slot) axis.

    Returns:
      ``[b]`` bool — True where every leaf of that row is finite (a 0-d
      True when no leaf is floating).
    """
    ok = torch.tensor(True)
    for leaf in tree_leaves(tree):
        if leaf.is_floating_point():
            ok = ok & torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
    return ok


class KVCache(NamedTuple):
    """Fixed-capacity KV cache (softmax / linear_elu), or the KV ring of
    softmax_window.

    ``length`` is per batch row: in slotted serving every slot decodes at
    its own position, so the number of valid entries is a per-slot
    quantity."""

    k: Tensor  # [b, hk, n_max, hd]
    v: Tensor  # [b, hk, n_max, hd]
    length: Tensor  # [b] int32 — valid tokens written per row/slot
