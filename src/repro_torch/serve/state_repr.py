"""Slot-state representations: quantised Taylor moments and paged KV.

The serve engine's slotted cache (``serve/slots.py``) normally holds the
backends' decode state DENSE, exactly the tree ``lm_init_caches`` builds.
This module adds two compact storage representations behind a codec
boundary, chosen at engine construction
(``ServeEngine(state_dtype=..., kv_page_size=...)``):

  * ``QuantizedCodec`` — the Taylor backend's moment leaves (s0/z1/s1 and
    the order-2 s2/z2, which dominate per-slot bytes) held int8 or fp8 with
    per-head power-of-two scales (``backends/state.py``'s
    ``quantize_leaf``).  ``n0`` stays float32 (the health invariant's token
    count).
  * ``PagedKVCodec`` — the softmax-family ``[slots, n_max]`` KV slot cache
    held as page pools (power-of-two page size) plus ONE shared per-slot
    page table, so short requests stop paying the ``n_max`` ceiling; a
    host-side ``PageAllocator`` owns the free list.
  * ``HybridCodec`` — both at once under a hybrid ``attention_schedule``:
    taylor layers quantised and paged-capable softmax layers paged in one
    slot store (the node sets are disjoint; window rings stay dense).

The compute path never changes: a dispatch decodes the stored tree to the
dense one, runs the unmodified prefill/decode/verify functions, and
re-encodes (``wrap_cache_fn``), once per decode block or verify, never per
token.  Scales are exact powers of two, so decode→encode round trips are
bit-exact and the snapshot handoff (preemption, speculative rollback,
quarantine re-prefill) holds for lossy state: a restored snapshot
reproduces the exact pre-preemption tokens.  Encoding returns new tensors:
a stored tree handed to a wrapped function is never written in place, so a
snapshot or an in-place retry of a failed dispatch still sees it.

``SlotStateStore`` (also reachable as ``serve.slots.SlotStateStore``)
bundles a codec with the slot ops and the page allocator, and is what the
scheduler talks to.

On a mesh (``make_state_store(mesh=, rules=)``) every rank holds its block
of the stored tree, as ``distributed.sharding.slot_cache_specs(...,
state=codec)`` names it (each codec's ``logical_specs``): a quantised
payload lies as the dense leaf, its scale is whole on every rank and is
the single-device scale (the per-head amax is a max over every rank that
splits the head's leaf, its slots and heads gathered), so the stored
bytes equal the single-device engine's; a page pool splits its page axis
over "data" where it divides and is gathered around each decode and
encode, the page table and lengths are whole on every rank; the health
sweep ANDs each slot over "model" and gathers it over "data".
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.backends import get_backend, resolve_backend
from repro_torch.backends.state import (
    KVCache,
    PagedKVCache,
    PagedMeta,
    QuantizedLeaf,
    dequantize_leaf,
    gather_pages,
    leaf_amax,
    quant_payload,
    quant_scale,
    quantize_leaf,
    scatter_pages,
)
from repro_torch.core import TaylorState
from repro_torch.device import resolve_device
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives as col
from repro_torch.distributed.api import P
from repro_torch.distributed.sharding import Placements, block_of, slot_cache_specs
from repro_torch.models.config import ModelConfig, schedule_runs
from repro_torch.serve import slots as slots_mod
from repro_torch.tree import tree_leaves

Tensor = torch.Tensor


def _map_state_nodes(cfg: ModelConfig, fn, *trees, with_backend: bool = False) -> Dict[str, Any]:
    """Walk slotted-cache trees per backend NODE (not per leaf).

    The codec building block: applies ``fn`` to each attention-state node
    (``TaylorState`` / ``KVCache`` / their encoded forms) of one or more
    congruent cache trees, run by run as ``lm_init_caches`` built them, so
    a hybrid schedule's per-run states stay congruent.  A mamba block's
    O(1) ``MambaCache`` is never re-encoded: it stays dense under every
    codec.  A cross block's pair has ``fn`` applied to its self state only:
    the ``CrossCache`` of its source is written once at admission and only
    read after, so it stays dense too.  Other top-level keys of ``trees[0]``
    (``kv_src``, ``paged``) pass through untouched.

    Args:
      cfg: model config (pattern, tail and schedule decide the runs).
      fn: callable taking one node per input tree, returning the mapped
        node; with ``with_backend=True`` it is called as
        ``fn(backend_name, *nodes)``, which is how a codec avoids
        transforming another backend's node of the same type (the paged
        codec must not page a ``softmax_window`` ring).
      *trees: one or more ``{"group", "tail", ...}`` cache trees.
      with_backend: pass the owning run's backend name to ``fn`` first.

    Returns:
      A new dict with ``group``/``tail`` rebuilt from ``fn``'s outputs.
    """
    out = dict(trees[0])

    def call(kind, bk, *nodes):
        if kind == "mamba":
            return nodes[0]
        if kind == "cross":
            return (call("attn", bk, *(n[0] for n in nodes)),) + tuple(nodes[0][1:])
        return fn(bk, *nodes) if with_backend else fn(*nodes)

    out["group"] = tuple(
        call(kind, bk, *nodes)
        for (kind, bk, _), nodes in zip(schedule_runs(cfg), zip(*[t["group"] for t in trees]))
    )
    out["tail"] = tuple(call(kind, cfg.attention, *nodes)
                        for kind, nodes in zip(cfg.tail, zip(*[t["tail"] for t in trees])))
    return out


def wrap_cache_fn(fn, codec: "StateCodec"):
    """Wrap a ``(params, caches, *rest) -> (caches, *outs)`` cache function
    so that it runs dense inside a stored-representation boundary.

    The engine threads this around the decode block and the speculative
    verify: the wrapped function decodes the stored tree, runs ``fn``
    unmodified on the dense tree, and re-encodes the returned cache, so
    quantisation and paging stay invisible to every compute path.

    Args:
      fn: cache-transforming function whose FIRST output is the updated
        dense cache tree.
      codec: the representation codec.

    Returns:
      Callable with the same signature over stored trees.
    """

    def wrapped(params, stored, *rest):
        out = fn(params, codec.decode(stored), *rest)
        return (codec.encode(out[0], stored),) + tuple(out[1:])

    return wrapped


@dataclasses.dataclass(frozen=True)
class StateCodec:
    """Base slot-state codec: dense ⇄ stored representation.

    Subclasses implement ``decode``/``encode``/``init_stored``; the
    ``*_impl`` slot ops default to decode → dense op → encode (what the
    paged codec uses: a page gather/scatter is the decode), and may be
    overridden with leaf-level versions (the quantised codec's ops never
    materialise the full dense cache).
    """

    cfg: ModelConfig
    max_slots: int
    n_max: int
    device: torch.device
    # a mesh and its rules: every tree is then this rank's blocks
    mesh: Any = dataclasses.field(default=None, compare=False)
    rules: Any = dataclasses.field(default=None, compare=False)

    name = "base"

    def decode(self, stored):
        """Stored tree → dense ``{"group", "tail", "kv_src"}`` tree."""
        raise NotImplementedError

    def encode(self, dense, stored):
        """Dense tree → stored tree (``stored`` supplies representation
        metadata such as page pools and tables; quantisation ignores it)."""
        raise NotImplementedError

    def init_stored(self):
        """Zero-initialised stored-representation cache."""
        raise NotImplementedError

    def _dense_zeros(self):
        return slots_mod.init_slot_caches(self.cfg, self.max_slots, self.n_max, self.device,
                                          self.mesh, self.rules)

    # -- placements on a mesh (None off one) ---------------------------------

    @functools.cached_property
    def _slotted(self) -> Placements:
        return Placements(self.mesh, slot_cache_specs(self.cfg, self.max_slots, self.n_max,
                                                      self.mesh, self.rules))

    @functools.cached_property
    def _request(self) -> Placements:
        return Placements(self.mesh, slot_cache_specs(self.cfg, 1, self.n_max, self.mesh,
                                                      self.rules))

    @functools.cached_property
    def _stored(self) -> Placements:
        return Placements(self.mesh, slot_cache_specs(self.cfg, self.max_slots, self.n_max,
                                                      self.mesh, self.rules, state=self))

    def dense_placements(self, batch: Optional[int] = None) -> Optional[Placements]:
        """Where the dense tree of the slots (or of a batch-1 request,
        ``batch=1``) lies; None off a mesh."""
        if self.mesh is None:
            return None
        return self._request if batch == 1 else self._slotted

    def stored_placements(self) -> Optional[Placements]:
        """Where the stored tree lies (the dense one's for the dense codec)."""
        if self.mesh is None or self.name == "dense":
            return self.dense_placements()
        return self._stored

    def _axis(self, logical: str, size: int):
        """The physical axis of ``logical`` for a dim of ``size`` (None off a
        mesh or where it does not divide)."""
        if self.mesh is None:
            return None
        return dist_api.resolve_axes((logical,), (size,), self.mesh, self.rules)[0]

    # -- stored-tree slot ops ------------------------------------------------

    def write_impl(self, stored, dense_b1, slot: int):
        """Splice a batch-1 DENSE request cache into slot ``slot`` of the
        stored tree (generic: decode → splice → encode)."""
        dense = slots_mod.write_slot(self.decode(stored), dense_b1, slot, self.dense_placements())
        return self.encode(dense, stored)

    def clear_impl(self, stored, slot: int):
        """Zero one slot inside the stored tree (runs BEFORE any host page
        release, so freed pages are zeroed on the device)."""
        dense = slots_mod.clear_slot(self.decode(stored), slot, self.dense_placements())
        return self.encode(dense, stored)

    def read_impl(self, stored, slot: int):
        """One slot as a batch-1 DENSE cache (the snapshot the scheduler
        saves on preemption and before a speculative verify)."""
        return slots_mod.read_slot(self.decode(stored), slot, self.dense_placements())

    def corrupt_impl(self, stored, slot: int, fill: float):
        """Poison one slot's floating leaves with ``fill`` (fault injection;
        must stay visible to ``health_impl``)."""
        dense = slots_mod.corrupt_slot(self.decode(stored), slot, fill, self.dense_placements())
        return self.encode(dense, stored)

    def health_impl(self, stored) -> Tensor:
        """Per-slot backend ``state_health`` of the decoded tree (this rank's
        slots on a mesh)."""
        return slots_mod.slot_health(self.decode(stored), self.cfg)

    def logical_specs(self, logical):
        """The dense logical spec tree (``slot_cache_specs``) mapped to the
        stored tree's: the identity here."""
        return logical


@dataclasses.dataclass(frozen=True)
class DenseCodec(StateCodec):
    """Identity codec: the stored representation IS the dense tree, and the
    slot ops are those of ``serve/slots.py`` as they are."""

    name = "dense"

    def decode(self, stored):
        return stored

    def encode(self, dense, stored):
        return dense

    def init_stored(self):
        return self._dense_zeros()

    def write_impl(self, stored, dense_b1, slot: int):
        return slots_mod.write_slot(stored, dense_b1, slot, self.dense_placements())

    def clear_impl(self, stored, slot: int):
        return slots_mod.clear_slot(stored, slot, self.dense_placements())

    def read_impl(self, stored, slot: int):
        return slots_mod.read_slot(stored, slot, self.dense_placements())

    def corrupt_impl(self, stored, slot: int, fill: float):
        return slots_mod.corrupt_slot(stored, slot, fill, self.dense_placements())


@dataclasses.dataclass(frozen=True)
class QuantizedCodec(StateCodec):
    """int8 / fp8 Taylor moment state with per-head power-of-two scales.

    Every ``TaylorState`` node's moment leaves (s0, z1, s1, z2, s2) become
    ``QuantizedLeaf``s; ``n0`` stays float32.  The slot ops are leaf-level:
    writes quantise only the incoming batch-1 state and splice it, reads
    dequantise only the sliced slot.
    """

    qdtype: str = "int8"  # "int8" | "fp8"

    @property
    def name(self) -> str:
        """Representation name (the ``state_dtype`` value)."""
        return self.qdtype

    def _quantize(self, x: Tensor, spec, n_lead: int) -> QuantizedLeaf:
        """One leaf (this rank's block with dense ``spec`` on a mesh): the
        per-head amax is maxed over the ranks that split the head's leaf,
        then gathered over those that split its slots and heads, so every
        rank holds the whole scale, the single-device one."""
        if self.mesh is None:
            return quantize_leaf(x, n_lead, self.qdtype)
        amax = leaf_amax(x, n_lead)
        for dim, entry in enumerate(spec):
            if entry is not None:
                amax = col.gather_values(amax, dim, self.mesh, entry)
                if dim >= n_lead:
                    amax = amax.amax(dim=dim, keepdim=True)
        scale = quant_scale(amax, self.qdtype)
        return QuantizedLeaf(q=quant_payload(x, self._local_scale(scale, spec, n_lead),
                                             self.qdtype), scale=scale)

    def _local_scale(self, scale: Tensor, spec, n_lead: int) -> Tensor:
        """This rank's rows of a whole scale: its slots and heads."""
        if self.mesh is None:
            return scale
        return block_of(scale, P(*tuple(spec)[:n_lead]), self.mesh)

    def _q_node(self, node, spec):
        if not isinstance(node, TaylorState):
            return node
        n_lead = node.n0.ndim  # through the kv-head axis

        def q(x, s):
            return None if x is None else self._quantize(x, s, n_lead)

        return TaylorState(n0=node.n0, s0=q(node.s0, spec.s0), z1=q(node.z1, spec.z1),
                           s1=q(node.s1, spec.s1), z2=q(node.z2, spec.z2),
                           s2=q(node.s2, spec.s2))

    def _dq_node(self, node, spec):
        if not (isinstance(node, TaylorState) and isinstance(node.s0, QuantizedLeaf)):
            return node
        n_lead = node.n0.ndim

        def d(leaf, s):
            if leaf is None:
                return None
            return dequantize_leaf(QuantizedLeaf(leaf.q, self._local_scale(leaf.scale, s, n_lead)))

        return TaylorState(n0=node.n0, s0=d(node.s0, spec.s0), z1=d(node.z1, spec.z1),
                           s1=d(node.s1, spec.s1), z2=d(node.z2, spec.z2),
                           s2=d(node.s2, spec.s2))

    def _node_specs(self, tree, batch: Optional[int]):
        pl = self.dense_placements(batch)
        return tree if pl is None else pl.specs  # off a mesh: unread

    def decode(self, stored, batch: Optional[int] = None):
        """Dequantise every moment node back to dense float32 (``q *
        scale`` per leaf); a slotted tree, or one of ``batch`` rows."""
        return _map_state_nodes(self.cfg, self._dq_node, stored,
                                self._node_specs(stored, batch))

    def encode(self, dense, stored=None, batch: Optional[int] = None):
        """Quantise every moment node (``stored`` is unused: the
        representation carries no metadata between calls)."""
        del stored
        return _map_state_nodes(self.cfg, self._q_node, dense, self._node_specs(dense, batch))

    def init_stored(self):
        """Quantised zero cache (all-zero leaves get the minimum scale
        ``2**-BITS``, see ``quantize_leaf``)."""
        return self.encode(self._dense_zeros())

    # Leaf-level ops: the stored tree has the dense one's slot axes
    # (keepdim scales), so the generic splice/zero/poison ops apply to the
    # quantised leaves directly.

    def write_impl(self, stored, dense_b1, slot: int):
        return slots_mod.write_slot(stored, self.encode(dense_b1, batch=1), slot,
                                    self.stored_placements())

    def clear_impl(self, stored, slot: int):
        return slots_mod.clear_slot(stored, slot, self.stored_placements())

    def read_impl(self, stored, slot: int):
        return self.decode(slots_mod.read_slot(stored, slot, self.stored_placements()), batch=1)

    def corrupt_impl(self, stored, slot: int, fill: float):
        # Poisons scales and n0 (and the fp8 payload; int8 is integer and
        # skipped): q * NaN-scale decodes to NaN, so corruption survives the
        # representation and health_impl still flags the slot.
        return slots_mod.corrupt_slot(stored, slot, fill, self.stored_placements())

    def logical_specs(self, logical):
        """The stored tree's logical specs: each payload keeps its dense
        leaf's spec, each scale replicates."""

        def fn(node):
            if not isinstance(node, TaylorState):
                return node

            def q(spec):
                return None if spec is None else QuantizedLeaf(q=spec, scale=P())

            return TaylorState(n0=node.n0, s0=q(node.s0), z1=q(node.z1), s1=q(node.s1),
                               z2=q(node.z2), s2=q(node.s2))

        return _map_state_nodes(self.cfg, fn, logical)


@dataclasses.dataclass(frozen=True)
class PagedKVCodec(StateCodec):
    """Paged storage for the softmax-family KV slot cache.

    Each ``KVCache`` node's ``[*lead, slots, hk, n_max, hd]`` K/V pair
    becomes a ``PagedKVCache`` pool ``[*lead, total_pages, hk, page_size,
    hd]``; ONE ``PagedMeta`` (page table ``[slots, pages_per_slot]`` and
    per-slot lengths) under the cache's ``"paged"`` key is shared by every
    node: all layers of a slot grow in lockstep.  Page ownership is on the
    host (``PageAllocator``); the codec only gathers and scatters along
    the current table.
    """

    page_size: int = 0
    total_pages: int = 0

    name = "paged"

    @property
    def pages_per_slot(self) -> int:
        """Table width: pages needed to back ``n_max`` tokens."""
        return -(-self.n_max // self.page_size)

    def _whole(self, x: Tensor, dim: int, axis) -> Tensor:
        return x if axis is None else col.gather_values(x, dim, self.mesh, axis)

    def _block(self, x: Tensor, dim: int, axis) -> Tensor:
        return x if axis is None else col.slice_values(x, dim, self.mesh, axis).contiguous()

    def decode(self, stored):
        """Gather every pool back to the dense ``[slots, n_max]`` layout
        (unallocated entries read as zeros); the ``"paged"`` key is dropped,
        so the result is the tree the model functions expect.  On a mesh the
        pool is gathered whole over its page axis, and this rank keeps its
        slots."""
        meta = stored["paged"]
        rest = {k: v for k, v in stored.items() if k != "paged"}
        pages, slots = self._axis("dp", self.total_pages), self._axis("dp", self.max_slots)

        def fn(node):
            if not isinstance(node, PagedKVCache):
                return node
            lead = node.k_pages.ndim - 4

            def kv(pool):
                dense = gather_pages(self._whole(pool, lead, pages), meta.table, self.n_max)
                return self._block(dense, lead, slots)

            length = meta.length.expand(node.k_pages.shape[:lead] + (self.max_slots,))
            return KVCache(k=kv(node.k_pages), v=kv(node.v_pages),
                           length=self._block(length, lead, slots).clone())

        return _map_state_nodes(self.cfg, fn, rest)

    def encode(self, dense, stored):
        """Scatter every dense KV node into a copy of its pool along the
        CURRENT table; rows of unallocated entries are dropped.  The
        per-slot lengths come from the first KV node (every layer holds
        the same).  On a mesh the dense slots and the pool are gathered
        whole and this rank keeps its pages."""
        meta = stored["paged"]
        rest = {k: v for k, v in stored.items() if k != "paged"}
        pages, slots = self._axis("dp", self.total_pages), self._axis("dp", self.max_slots)
        length: List[Optional[Tensor]] = [None]

        def fn(dnode, snode):
            if not isinstance(snode, PagedKVCache):
                return dnode
            lead = snode.k_pages.ndim - 4
            if length[0] is None:
                n = dnode.length
                length[0] = self._whole(n.reshape(-1, n.shape[-1])[0].to(torch.int32), 0, slots)

            def kv(x, pool):
                whole = scatter_pages(self._whole(x, lead, slots), self._whole(pool, lead, pages),
                                      meta.table)
                return self._block(whole, lead, pages)

            return PagedKVCache(k_pages=kv(dnode.k, snode.k_pages),
                                v_pages=kv(dnode.v, snode.v_pages))

        out = _map_state_nodes(self.cfg, fn, dense, rest)
        out["paged"] = PagedMeta(table=meta.table,
                                 length=meta.length if length[0] is None else length[0])
        return out

    def logical_specs(self, logical):
        """Page pools reuse the dense K/V specs ("dp" lands on the page axis,
        where it divides); the page table and lengths replicate."""

        def fn(bk, node):
            if not isinstance(node, KVCache) or not get_backend(bk).supports_paged_kv:
                return node
            return PagedKVCache(k_pages=node.k, v_pages=node.v)

        out = _map_state_nodes(self.cfg, fn, logical, with_backend=True)
        out["paged"] = PagedMeta(table=P(), length=P())
        return out

    def init_stored(self):
        """Zero pools and an all-free (-1) table.  Free pages being zero is
        an invariant ``clear_impl`` keeps (zeroed on the device before the
        host releases them), so gathering a stale id never shows another
        request's tokens."""

        def fn(bk, node):
            # a softmax_window ring is a KVCache too, but already O(window)
            if not isinstance(node, KVCache) or not get_backend(bk).supports_paged_kv:
                return node

            def pool(x):
                return x.new_zeros(x.shape[:-4] + (self.total_pages // split, x.shape[-3],
                                                   self.page_size, x.shape[-1]))

            return PagedKVCache(k_pages=pool(node.k), v_pages=pool(node.v))

        pages = self._axis("dp", self.total_pages)
        split = 1 if pages is None else dist_api.mesh_axis_size(self.mesh, pages)
        out = _map_state_nodes(self.cfg, fn, self._dense_zeros(), with_backend=True)
        out["paged"] = PagedMeta(
            table=torch.full((self.max_slots, self.pages_per_slot), -1, dtype=torch.int32,
                             device=self.device),
            length=torch.zeros((self.max_slots,), dtype=torch.int32, device=self.device),
        )
        return out


@dataclasses.dataclass(frozen=True)
class HybridCodec(PagedKVCodec):
    """Quantised moments and paged KV in one slot store (hybrid schedules).

    Taylor layers' moments are held int8/fp8 (``QuantizedCodec``) while
    paged-capable softmax layers' KV runs as page pools
    (``PagedKVCodec``); window rings stay dense.  The node sets are
    disjoint, so the two compose by chaining: paged gather/scatter first
    (it owns the ``"paged"`` key), quantise/dequantise second.  Slot ops
    use the base class's generic decode → dense op → encode path.
    """

    qdtype: str = "int8"

    @property
    def name(self) -> str:
        """Representation name, e.g. ``"int8+paged"``."""
        return f"{self.qdtype}+paged"

    def _quant(self) -> QuantizedCodec:
        return QuantizedCodec(cfg=self.cfg, max_slots=self.max_slots, n_max=self.n_max,
                              device=self.device, mesh=self.mesh, rules=self.rules,
                              qdtype=self.qdtype)

    def decode(self, stored):
        """Gather KV pages AND dequantise moment nodes → dense tree."""
        return self._quant().decode(super().decode(stored))

    def encode(self, dense, stored):
        """Scatter KV into the current page table and quantise moments."""
        return self._quant().encode(super().encode(dense, stored))

    def init_stored(self):
        """Zero pools, an all-free table and quantised zero moments."""
        return self._quant().encode(super().init_stored())

    def logical_specs(self, logical):
        """Both transforms: pools as the dense K/V, payloads as the dense
        moments, scales and the page table replicated."""
        return self._quant().logical_specs(super().logical_specs(logical))


class PageAllocator:
    """Host-side free-list allocator for the paged KV representation.

    Owns which pool pages back which slot; the device only sees the
    resulting int32 table.  Pages are allocated as a prefix of each slot's
    table row (``ensure``) and returned together on release.  Invariant:
    every page is either on the free list or in exactly one table row —
    ``len(free) + (table >= 0).sum() == total_pages`` with no duplicates.
    """

    def __init__(self, max_slots: int, pages_per_slot: int, total_pages: int,
                 page_size: int, n_max: int):
        self.max_slots = max_slots
        self.pages_per_slot = pages_per_slot
        self.total_pages = total_pages
        self.page_size = page_size
        self.n_max = n_max
        self.free: List[int] = []
        self.table = np.full((max_slots, pages_per_slot), -1, np.int32)
        self.reset()

    def reset(self) -> None:
        """Return every page to the free list and blank the table (cache
        rebuild after a dispatch loss; the pools are re-zeroed there too)."""
        self.free = list(range(self.total_pages - 1, -1, -1))
        self.table[:] = -1

    def ensure(self, slot: int, n_tokens: int) -> bool:
        """Grow slot ``slot``'s page prefix to cover ``n_tokens`` tokens
        (clamped to ``n_max``).

        Returns:
          True if the table changed (the caller pushes it to the device).

        Raises:
          RuntimeError: the pool is exhausted (with the default pool size
            ``max_slots * pages_per_slot`` this cannot happen).
        """
        need = -(-min(int(n_tokens), self.n_max) // self.page_size)
        need = min(need, self.pages_per_slot)
        row = self.table[slot]
        have = int((row >= 0).sum())
        if need <= have:
            return False
        for j in range(have, need):
            if not self.free:
                raise RuntimeError(
                    f"paged KV pool exhausted: slot {slot} needs page "
                    f"{j + 1}/{need} but all {self.total_pages} pages are "
                    "allocated (raise kv_pages)"
                )
            row[j] = self.free.pop()
        return True

    def release(self, slot: int) -> bool:
        """Return all of slot ``slot``'s pages to the free list.  Must run
        AFTER the device-side clear (which zeroes the pages through the old
        table), so freed pages re-enter the pool zeroed.  Returns True if
        the table changed."""
        row = self.table[slot]
        ids = row[row >= 0]
        if ids.size == 0:
            return False
        self.free.extend(int(i) for i in ids)
        row[:] = -1
        return True

    @property
    def used_pages(self) -> int:
        """Pages currently backing live slots."""
        return self.total_pages - len(self.free)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


class SlotStateStore:
    """The scheduler's handle on the slot cache's storage representation.

    Bundles a codec (``DenseCodec`` when none is given) with the page
    allocator, so the engine has ONE object to ask for writes, reads,
    clears and health whatever the representation; ``codec`` is what the
    engine wraps its decode block and verify with.  As in ``serve/slots.py``,
    ``write_slot`` and ``clear_slot`` may update the stored tree in place
    and return it.  On a mesh (the codec's, or ``mesh=``/``rules=`` for the
    default dense one) every tree it holds or hands out is this rank's
    blocks: the stored tree as ``placements`` says, a batch-1 dense cache
    (``write_slot``'s input, ``read_slot``'s output) whole over "data".
    """

    def __init__(self, cfg: ModelConfig, max_slots: int, n_max: int, device=None,
                 codec: Optional[StateCodec] = None,
                 allocator: Optional[PageAllocator] = None, mesh=None, rules=None):
        self.cfg = cfg
        self.max_slots = max_slots
        self.n_max = n_max
        self.device = resolve_device(device)
        self.codec = codec if codec is not None else DenseCodec(
            cfg=cfg, max_slots=max_slots, n_max=n_max, device=self.device, mesh=mesh,
            rules=rules)
        self.mesh, self.rules = self.codec.mesh, self.codec.rules
        self.allocator = allocator

    @property
    def placements(self) -> Optional[Placements]:
        """Where the stored tree's blocks lie (None off a mesh)."""
        return self.codec.stored_placements()

    # -- representation queries ----------------------------------------------

    @property
    def name(self) -> str:
        """Representation name: "dense", "int8", "fp8", "paged" or a
        hybrid combination like "int8+paged"."""
        return self.codec.name

    @property
    def paged(self) -> bool:
        """True when the KV cache is paged (an allocator is attached)."""
        return self.allocator is not None

    # -- ops -----------------------------------------------------------------

    def init_caches(self):
        """Freshly zeroed stored slot cache; also resets the page allocator
        (construction, and the rebuild after a dispatch loss)."""
        if self.allocator is not None:
            self.allocator.reset()
        return self.codec.init_stored()

    def write_slot(self, caches, dense_b1, slot: int):
        """Splice a batch-1 DENSE request cache (prefill output or a
        ``read_slot`` snapshot) into slot ``slot``, encoding it into the
        stored representation.  Other slots stay bit-identical."""
        return self.codec.write_impl(caches, dense_b1, slot)

    def read_slot(self, caches, slot: int):
        """One slot as a batch-1 DENSE cache (a copy) — the snapshot
        contract: for lossy representations this is the dequantised state,
        and writing it back reproduces the stored bits exactly (power-of-two
        scales), so preemption and rollback round trips are token-identical."""
        return self.codec.read_impl(caches, slot)

    def read_dense(self, dense_caches, slot: int):
        """One row of an already-DENSE cache tree (the batched prefill
        output, which never passes through the stored representation)."""
        return slots_mod.read_slot(dense_caches, slot)

    def clear_slot(self, caches, slot: int):
        """Zero one slot and (when paged) return its pages to the pool.
        The device-side zeroing runs first, through the slot's current page
        table, so released pages re-enter the free list zeroed."""
        out = self.codec.clear_impl(caches, slot)
        if self.allocator is not None and self.allocator.release(int(slot)):
            out = self._push_table(out)
        return out

    def corrupt_slot(self, caches, slot: int, fill: float):
        """Copy of the cache with one slot's floating leaves poisoned (fault
        injection: the representation keeps the corruption visible to
        ``health``)."""
        return self.codec.corrupt_impl(caches, slot, fill)

    def health(self, caches) -> Tensor:
        """``[max_slots]`` bool: per-slot ``state_health`` of the decoded
        cache.  On a mesh the same on every rank: a slot is healthy where
        every "model" rank's block of it is (an AND over the axis), and the
        "data" ranks' slots are gathered."""
        ok = self.codec.health_impl(caches)
        if self.mesh is None:
            return ok
        tp = self.rules.get("tp")
        if tp is not None:
            ok = col.gather_values(ok[None], 0, self.mesh, tp).all(dim=0)
        slots = self.codec._axis("dp", self.max_slots)
        return ok if slots is None else col.gather_values(ok, 0, self.mesh, slots)

    def ensure_tokens(self, caches, slot: int, n_tokens: int):
        """Guarantee slot ``slot`` has pages for ``n_tokens`` tokens (a no-op
        for non-paged stores); pushes the table to the device only when it
        changed.  Returns the (possibly table-refreshed) stored cache."""
        if self.allocator is None:
            return caches
        if self.allocator.ensure(int(slot), int(n_tokens)):
            return self._push_table(caches)
        return caches

    def _push_table(self, caches):
        out = dict(caches)
        out["paged"] = PagedMeta(
            table=torch.as_tensor(self.allocator.table, device=self.device).clone(),
            length=caches["paged"].length,
        )
        return out

    # -- accounting ----------------------------------------------------------

    def live_bytes(self, caches) -> int:
        """Decode-state bytes LIVE on the device.  Dense and quantised state
        is fully resident (allocated == live); a paged pool counts only the
        pages in use."""
        total = _nbytes(caches)
        if self.allocator is None:
            return total
        pool_bytes = 0

        def fn(node):
            nonlocal pool_bytes
            if isinstance(node, PagedKVCache):
                pool_bytes += _nbytes(tuple(node))
            return node

        _map_state_nodes(self.cfg, fn, {k: v for k, v in caches.items() if k != "paged"})
        pages, used = self.allocator.total_pages, self.allocator.used_pages
        axis = self.codec._axis("dp", pages)
        if axis is not None:  # this rank's pages of the pool
            pages //= dist_api.mesh_axis_size(self.mesh, axis)
            lo = col.axis_rank(self.mesh, axis) * pages
            table = self.allocator.table
            used = int(((table >= lo) & (table < lo + pages)).sum())
        return total - pool_bytes + used * (pool_bytes // pages)

    def slot_bytes(self, caches) -> int:
        """Live decode-state bytes per slot (``live_bytes / max_slots``;
        ``slots.slot_bytes`` when the state is dense)."""
        return self.live_bytes(caches) // self.max_slots


def make_state_store(cfg: ModelConfig, max_slots: int, n_max: int, device=None,
                     state_dtype: str = "dense", kv_page_size: Optional[int] = None,
                     kv_pages: Optional[int] = None, mesh=None, rules=None) -> SlotStateStore:
    """Build the slot-state store for an engine's representation choice.

    Validates the request against the backends' capability flags
    (``AttentionBackend.state_dtypes`` / ``supports_paged_kv``) at
    construction, with the JAX package's errors: an unsupported
    representation is a config error, not something to discover
    mid-decode.

    Args:
      cfg: model config (its attention backends gate what is allowed).
      max_slots: slot count.
      n_max: per-slot token capacity.
      device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".
      state_dtype: "dense" or a quantised moment dtype ("int8"/"fp8").
      kv_page_size: enable paged KV with this power-of-two page size
        (≤ ``n_max``); combined with quantisation only under a hybrid
        schedule.
      kv_pages: pool size in pages (default ``max_slots × ⌈n_max /
        page_size⌉``, which never runs out; smaller pools oversubscribe and
        may raise in ``ensure_tokens``).
      mesh, rules: hold this rank's blocks of the stored tree
        (``launch.mesh.make_serve_mesh``; ``rules`` default to
        ``rules_for_mesh(mesh)``).

    Returns:
      A ``SlotStateStore``.

    Raises:
      ValueError: a representation no applicable backend supports, both
        representations on a uniform config, a bad page size, or a pool
        too small for one slot.
    """
    names = cfg.attention_backend_names or (cfg.attention,)
    for name in names:
        resolve_backend(cfg.layer_cfg(name))
    backends = [get_backend(n) for n in names]
    q_capable = [b.name for b in backends if state_dtype in b.state_dtypes]
    p_capable = [b.name for b in backends if b.state_kind == "kv" and b.supports_paged_kv]
    if state_dtype != "dense" and kv_page_size is not None:
        # Legal only on a hybrid schedule where each compression has its own
        # disjoint layer set (quantisation acts on moment nodes, paging on
        # paged-capable KV nodes, never on the same node).
        if not cfg.attention_schedule or not q_capable or not p_capable:
            raise ValueError(
                "state_dtype quantisation and kv_page_size paging are "
                "mutually exclusive (they compress different state kinds) "
                "— combining them requires a hybrid attention_schedule "
                "with both a quantisable-moment backend and a paged-KV "
                "backend"
            )
    device = resolve_device(device)
    if mesh is not None and rules is None:
        rules = dist_api.rules_for_mesh(mesh)
    codec: Optional[StateCodec] = None
    allocator: Optional[PageAllocator] = None
    if state_dtype != "dense" and not q_capable:
        backend = resolve_backend(cfg)
        raise ValueError(
            f"state_dtype={state_dtype!r} is not supported by the "
            f"{backend.name!r} backend (supported: {backend.state_dtypes})"
        )
    if kv_page_size is not None:
        if not p_capable:
            backend = resolve_backend(cfg)
            raise ValueError(
                f"kv_page_size: the {backend.name!r} backend holds "
                f"{backend.state_kind!r} state and does not support paged "
                "KV (supports_paged_kv=False)"
            )
        if kv_page_size <= 0 or kv_page_size & (kv_page_size - 1) or kv_page_size > n_max:
            raise ValueError(f"kv_page_size={kv_page_size} must be a power of two <= n_max={n_max}")
        pages_per_slot = -(-n_max // kv_page_size)
        total = max_slots * pages_per_slot if kv_pages is None else int(kv_pages)
        if total < pages_per_slot:
            raise ValueError(
                f"kv_pages={total} cannot back even one full slot ({pages_per_slot} pages)")
        kw = dict(cfg=cfg, max_slots=max_slots, n_max=n_max, device=device, mesh=mesh,
                  rules=rules, page_size=int(kv_page_size), total_pages=total)
        codec = (HybridCodec(qdtype=state_dtype, **kw) if state_dtype != "dense"
                 else PagedKVCodec(**kw))
        allocator = PageAllocator(max_slots, pages_per_slot, total, int(kv_page_size), n_max)
    elif state_dtype != "dense":
        codec = QuantizedCodec(cfg=cfg, max_slots=max_slots, n_max=n_max, device=device,
                               mesh=mesh, rules=rules, qdtype=state_dtype)
    return SlotStateStore(cfg, max_slots, n_max, device, codec, allocator, mesh=mesh,
                          rules=rules)
