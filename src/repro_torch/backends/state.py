"""Decode-state containers shared by the attention backends.

``TaylorState`` (the moment state) lives in ``core/taylor.py``; the KV
backends (softmax, linear_elu, softmax_window) keep a ``KVCache``; a cross
block adds the fixed ``CrossCache`` of its source.  The
serve layer's compact storage forms (``serve/state_repr.py``) build on
``QuantizedLeaf`` (int8/fp8 payload and power-of-two scale) and the paged
``PagedKVCache`` / ``PagedMeta``, with their primitives here.
"""

from __future__ import annotations

from typing import Any, NamedTuple

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


def kv_cache_pspec() -> KVCache:
    """Logical axes of a ``KVCache``: slots over "dp", kv heads over "tp"
    (``k``/``v`` ``[b, hk, n_max, hd]``, ``length`` ``[b]``)."""
    from repro_torch.distributed.api import P  # noqa: PLC0415

    return KVCache(k=P("dp", "tp", None, None), v=P("dp", "tp", None, None), length=P("dp"))


class CrossCache(NamedTuple):
    """The fixed cross-attention read state of one source (encoder output
    or projected image tokens): its K/V (a ``KVCache`` whose length is the
    source length, KV-kind backends) or its moments (a ``TaylorState``).
    A cross block's decode cache is the pair ``(self cache, CrossCache)``."""

    kv: Any


class QuantizedLeaf(NamedTuple):
    """One quantised decode-state tensor and its dequantisation scale.

    ``q`` holds the payload in the storage dtype (int8 or
    ``float8_e4m3fn``); ``scale`` is float32 with the same leading
    (slot/head) axes and size-1 trailing axes, so ``q * scale`` broadcasts
    back to the dense leaf.  Scales are exact powers of two (see
    ``quantize_leaf``), which makes decode→encode→decode round trips
    bit-exact: the property the serve layer's snapshot handoff
    (preemption, speculative rollback) relies on."""

    q: Tensor
    scale: Tensor


class PagedKVCache(NamedTuple):
    """Page-pool form of one ``KVCache`` node (serve layer only).

    ``k_pages``/``v_pages`` are ``[*lead, total_pages, hk, page_size, hd]``
    where ``*lead`` are the group stacking axes (``[n_groups, run_len]``)
    or empty for tail nodes.  Which pages belong to which slot lives in the
    one top-level ``PagedMeta`` of the slot cache, shared by every paged
    node.  Free pages are kept zero (pool init and clear both zero them),
    so gathering an unallocated page reads like an unwritten dense row."""

    k_pages: Tensor
    v_pages: Tensor


class PagedMeta(NamedTuple):
    """Shared page table and per-slot lengths of a paged slot cache.

    ``table`` is ``[slots, pages_per_slot]`` int32 with ``-1`` marking an
    unallocated entry (allocated entries form a prefix of each row);
    ``length`` is ``[slots]`` int32, the valid-token count every dense
    ``KVCache.length`` of the decoded tree broadcasts from."""

    table: Tensor
    length: Tensor


# Mantissa budget per quantised storage dtype: scales are 2**(e - BITS)
# with e from frexp(amax), so payload magnitudes land in [2**(BITS-1),
# 2**BITS).  int8 uses 7 (round to int, clip at 127); fp8 e4m3 uses 8 and
# clips at 240, the largest multiple of 16 that round-to-nearest maps to
# itself, which keeps re-encoding a decoded leaf bit-exact.
_QBITS = {"int8": 7, "fp8": 8}


def quantize_leaf(x: Tensor, n_lead: int, qdtype: str) -> QuantizedLeaf:
    """Quantise one dense state leaf with per-head power-of-two scales.

    The scale of each leading-axes index (slot, kv head, ...) is
    ``2**(frexp(amax) - BITS)``, an exact power of two, so dequantised
    values re-encode to themselves bit for bit.  A non-finite ``amax``
    propagates into the scale, so corrupted state stays visible to
    ``state_health`` after the round trip.  The JAX package's bits: int8
    rounds half to even, fp8 casts to ``float8_e4m3fn`` after clipping.

    Args:
      x: dense leaf; axes ``< n_lead`` are kept (slot/head), the rest are
        reduced into one amax per head.
      n_lead: number of leading axes to keep per scale.
      qdtype: ``"int8"`` or ``"fp8"``.

    Returns:
      ``QuantizedLeaf`` with ``q`` in the storage dtype and a float32
      ``scale`` shaped like ``x`` with size-1 reduced axes.
    """
    scale = quant_scale(leaf_amax(x, n_lead), qdtype)
    return QuantizedLeaf(q=quant_payload(x, scale, qdtype), scale=scale)


def leaf_amax(x: Tensor, n_lead: int) -> Tensor:
    """``|x|``'s max over the axes from ``n_lead`` on (kept, size 1), in
    float32; NaN propagates."""
    xf = x.float().abs()
    axes = tuple(range(n_lead, x.ndim))
    return xf.amax(dim=axes, keepdim=True) if axes else xf


def quant_scale(amax: Tensor, qdtype: str) -> Tensor:
    """The power-of-two scale ``2**(frexp(amax) - BITS)`` (a non-finite
    ``amax`` is its own scale)."""
    _, e = torch.frexp(amax)
    scale = torch.exp2((e - _QBITS[qdtype]).float())
    return torch.where(torch.isfinite(amax), scale, amax)


def quant_payload(x: Tensor, scale: Tensor, qdtype: str) -> Tensor:
    """``x / scale`` in the storage dtype: int8 rounded half to even and
    clipped at ±127, fp8 e4m3 clipped at ±240."""
    y = x.float() / scale
    if qdtype == "int8":
        return y.round().clamp(-127.0, 127.0).to(torch.int8)
    return y.clamp(-240.0, 240.0).to(torch.float8_e4m3fn)


def dequantize_leaf(leaf: QuantizedLeaf, dtype=torch.float32) -> Tensor:
    """Dense leaf from a ``QuantizedLeaf`` (``q * scale``), in ``dtype``
    (float32 for the Taylor moment state: absorbs and reads accumulate in
    full precision)."""
    return (leaf.q.float() * leaf.scale).to(dtype)


def gather_pages(pages: Tensor, table: Tensor, n_max: int) -> Tensor:
    """Decode one paged pool leaf to its dense ``[*lead, slots, hk, n_max,
    hd]`` form.

    Unallocated table entries (``-1``) read as zeros, like an unwritten
    dense cache row.

    Args:
      pages: ``[*lead, total_pages, hk, page_size, hd]`` pool.
      table: ``[slots, pages_per_slot]`` int32 page table (-1 = free).
      n_max: dense per-slot capacity (``pages_per_slot * page_size`` may
        overshoot it; the tail is sliced off).

    Returns:
      Dense ``[*lead, slots, hk, n_max, hd]`` tensor (a new one).
    """
    lead = pages.ndim - 4
    total, hk, ps, hd = pages.shape[lead:]
    slots, pp = table.shape
    flat = table.reshape(-1).long()
    out = pages.index_select(lead, flat.clamp(0, total - 1))
    valid = (flat >= 0).reshape((1,) * lead + (slots * pp, 1, 1, 1))
    out = torch.where(valid, out, out.new_zeros(()))
    out = out.reshape(pages.shape[:lead] + (slots, pp, hk, ps, hd))
    out = out.transpose(lead + 1, lead + 2)
    out = out.reshape(pages.shape[:lead] + (slots, hk, pp * ps, hd))
    return out[..., :n_max, :].contiguous()


def scatter_pages(dense: Tensor, pages: Tensor, table: Tensor) -> Tensor:
    """Encode one dense ``[*lead, slots, hk, n_max, hd]`` leaf into a copy
    of its page pool.

    The inverse of ``gather_pages`` over allocated entries: each slot's
    token rows are split into pages and written to that slot's table ids;
    rows of unallocated entries are dropped, so a slot never writes outside
    its own pages.  They go to one extra trash page that is sliced off
    (the JAX package's out-of-range scatter with ``mode="drop"``).

    Args:
      dense: dense leaf (cast to the pool's dtype).
      pages: current ``[*lead, total_pages, hk, page_size, hd]`` pool; not
        modified.
      table: ``[slots, pages_per_slot]`` int32 page table (-1 = free).

    Returns:
      The updated pool; pages of other slots (and free pages) bit-identical.
    """
    lead = dense.ndim - 4
    total, hk, ps, hd = pages.shape[lead:]
    slots, pp = table.shape
    n_max = dense.shape[lead + 2]
    pad = pp * ps - n_max
    if pad:  # the token axis is the second to last
        dense = torch.nn.functional.pad(dense, (0, 0, 0, pad))
    x = dense.reshape(dense.shape[:lead] + (slots, hk, pp, ps, hd))
    x = x.transpose(lead + 1, lead + 2)
    x = x.reshape(dense.shape[:lead] + (slots * pp, hk, ps, hd))
    flat = table.reshape(-1).long()
    ids = torch.where(flat >= 0, flat, torch.full_like(flat, total))
    out = pages.new_empty(pages.shape[:lead] + (total + 1, hk, ps, hd))
    out.narrow(lead, 0, total).copy_(pages)
    out.index_copy_(lead, ids, x.to(pages.dtype))
    return out.narrow(lead, 0, total)
