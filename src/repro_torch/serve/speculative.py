"""Speculative decoding on the O(1) Taylor moment state.

The order-2 Taylor attention keeps a constant-size recurrent state, which
makes draft-and-verify cheap: verifying k proposed tokens is ONE chunked
state roll-forward (``lm_verify_chunk``, the ``prefill_chunk`` maths)
instead of k sequential full-model decode steps.  Decode is
dispatch-bound, so accepted drafts cut dispatches per token below one.

The round, per speculating slot at position ``p`` with pending token ``t``:

  1. A ``DraftProposer`` guesses ``d_1..d_k`` (the tokens for positions
     ``p+1..p+k``).
  2. The slot's pre-round state is snapshotted with ``read_slot``.
  3. ONE verify dispatch feeds the window ``[t, d_1..d_k]`` at positions
     ``p..p+k`` through ``lm_verify_chunk`` over the whole slotted batch
     (co-batched slots that do not speculate are kept bit-identical by
     ``select_slots``), returning every window position's greedy argmax
     ``g_0..g_k``.
  4. The longest prefix with ``d_j == g_{j-1}`` (length ``m``) is accepted;
     the slot emits ``g_0..g_m``: the m matched drafts plus one
     correction/bonus token.  Every emitted token is what plain greedy
     decode would have produced, up to the summation order of the chunk
     pass against token-by-token decode.
  5. ``m == k``: the verify's rolled-forward state is the state
     token-by-token decode would have built.  ``m < k``: the state absorbed
     rejected drafts, so the accepted window prefix is re-absorbed from the
     snapshot (one chunk dispatch) and spliced back with ``write_slot`` —
     a rollback with no re-prefill.

Two proposers ship (a registry, extensible with ``register_proposer``):

  * ``"ngram"`` — weight-free prompt/history n-gram lookup on the host,
    with no extra dispatch: the continuation of the most recent previous
    occurrence of the current suffix n-gram.
  * ``"order1"`` — the paper's order hierarchy as a same-weights
    self-draft: the backend's ``draft_config`` drops the second-moment
    terms, and a light order-1 moment state per slot drafts k tokens in
    one fused catch-up + decode dispatch.

The JAX package compiles the verify and the draft round with ``jax.jit``;
here they are plain functions with the same maths and the same
``select_slots`` mask.  On an engine's mesh both run in its slotted
``spmd.region`` (each rank's slots; the argmaxes gathered whole), the
order-1 draft's slot cache lies on the mesh as the engine's does, and a
rollback or a draft's priming runs on every "data" rank, whose slot
owner keeps the state.  Policy surface: ``SchedulerPolicy.speculative_k``
/ ``speculative_draft`` engine-wide, ``Request.speculative_k`` /
``Request.draft`` per request (greedy requests only: sampled slots decode
plainly, as in the JAX package).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Set, Tuple, Type

import numpy as np
import torch

from repro_torch.backends import resolve_backend
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import Placements, slot_cache_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_decode_step, lm_prefill, lm_prefill_chunk, lm_verify_chunk
from repro_torch.serve import slots as slots_mod
from repro_torch.serve.state_repr import wrap_cache_fn

Tensor = torch.Tensor

__all__ = [
    "DraftProposer",
    "NgramProposer",
    "Order1SelfDraft",
    "Speculator",
    "draft_available",
    "has_proposer",
    "proposer_names",
    "register_proposer",
]


# -- the speculative dispatches ----------------------------------------------


@torch.no_grad()
def verify(params, caches, window: Tensor, pos0: Tensor, mask: Tensor, cfg: ModelConfig):
    """The verify dispatch over the whole slotted batch.

    The chunk pass absorbs every window token into the masked slots' state
    (``select_slots`` keeps the others bit-identical) and returns each
    position's argmax for the accept-prefix comparison.

    Args:
      params: model params.
      caches: dense slotted cache; not modified.
      window: ``[s, width]`` tokens (the pending token, then the drafts).
      pos0: ``[s]`` int32 position of ``window[:, 0]`` per slot.
      mask: ``[s]`` bool — the slots that speculate this round.
      cfg: model config.

    Returns:
      ``(new caches, greedy [s, width] int64)``.
    """
    logits, new = lm_verify_chunk(params, spmd.rows(window), caches, spmd.rows(pos0), cfg)
    return (slots_mod.select_slots(spmd.rows(mask), new, caches),
            spmd.all_rows(logits.argmax(dim=-1)))


@torch.no_grad()
def draft_propose(params, caches, window: Tensor, pos0: Tensor, mask: Tensor,
                  cfg: ModelConfig, k: int):
    """The fused draft round of the order-1 self-draft.

    Chunk-absorbs the ``width`` tokens the draft state is behind (its last
    logits give ``d_1``), then ``k - 1`` order-1 decode steps give
    ``d_2..d_k``.  Only the POST CATCH-UP state is kept (the drafted
    tokens' churn is dropped), so the draft never needs a rollback: the
    next round's catch-up absorbs exactly the accepted tokens.

    Args:
      params: model params (the target's).
      caches: the draft's slotted cache; not modified.
      window: ``[s, width]`` catch-up tokens.
      pos0: ``[s]`` int32 position of ``window[:, 0]``.
      mask: ``[s]`` bool — the slots drafting in this dispatch.
      cfg: the draft config.
      k: tokens to draft.

    Returns:
      ``(new draft caches, drafts [s, k] int64)``.
    """
    window, pos0, mask = spmd.rows(window), spmd.rows(pos0), spmd.rows(mask)
    logits, absorbed = lm_prefill_chunk(params, window, caches, pos0, cfg)
    d = logits.argmax(dim=-1)
    drafts = [d]
    cur = absorbed
    posv = pos0 + window.shape[1]
    for _ in range(k - 1):
        lg, cur = lm_decode_step(params, d, cur, posv, cfg)
        d = lg.argmax(dim=-1)
        drafts.append(d)
        posv = posv + 1
    return slots_mod.select_slots(mask, absorbed, caches), spmd.all_rows(torch.stack(drafts, dim=1))


# -- proposer protocol + registry -------------------------------------------


class DraftProposer:
    """Protocol of speculative draft proposers.

    A proposer guesses the next k tokens of a speculating slot; the verify
    then accepts the longest greedy-matching prefix, so a proposer may be
    arbitrarily wrong without changing the output: only the acceptance
    rate (and so dispatches per token) suffers.  One instance per engine;
    lifecycle hooks keep any per-slot draft state in step with the
    scheduler's slot reuse, preemption and quarantine.

    Class attributes:
      name: registry key (``Request.draft`` / ``speculative_draft``).
      requires_backend_draft: True when the proposer needs the backend's
        ``draft_config`` hook (the order-1 self-draft); submit-time
        validation rejects it on backends that return None.
    """

    name: str = ""
    requires_backend_draft: bool = False

    def __init__(self, spec: "Speculator"):
        self.spec = spec

    def propose(self, slot_ids: List[int], k: int) -> np.ndarray:
        """``[len(slot_ids), k]`` int drafted tokens, row-aligned with
        ``slot_ids`` (every slot is due)."""
        raise NotImplementedError(self.name)

    def on_install(self, slot: int) -> None:
        """A speculating request was installed or resumed into ``slot`` (its
        host context ``spec.ctx(slot)`` is already current)."""

    def on_release(self, slot: int) -> None:
        """``slot`` was released (retire, preemption, quarantine): drop any
        per-slot draft state."""

    def on_rebuild(self) -> None:
        """The engine rebuilt its caches after a dispatch loss: all per-slot
        draft state is stale."""


_PROPOSERS: Dict[str, Type[DraftProposer]] = {}


def register_proposer(cls: Type[DraftProposer]) -> Type[DraftProposer]:
    """Register a ``DraftProposer`` class under its ``name`` (usable as a
    class decorator).  The registry backs submit-time validation and
    per-engine lazy instantiation."""
    if not cls.name:
        raise ValueError("DraftProposer subclasses must set a name")
    _PROPOSERS[cls.name] = cls
    return cls


def proposer_names() -> Tuple[str, ...]:
    """Registered draft proposer names, sorted, e.g. ``("ngram", "order1")``."""
    return tuple(sorted(_PROPOSERS))


def has_proposer(name: str) -> bool:
    """Whether ``name`` is a registered draft proposer."""
    return name in _PROPOSERS


def draft_available(cfg: ModelConfig, name: str) -> bool:
    """Whether proposer ``name`` can run against this model config.

    Weight-free proposers always can; those with ``requires_backend_draft``
    also need the backend's ``draft_config`` to return a config (taylor
    does for order-2 targets; KV backends return None).
    """
    cls = _PROPOSERS.get(name)
    if cls is None:
        return False
    if cls.requires_backend_draft:
        return resolve_backend(cfg).draft_config(cfg) is not None
    return True


# -- proposers ---------------------------------------------------------------


def _ngram_continuation(ctx: List[int], k: int) -> List[int]:
    """Prompt-lookup draft: the continuation of the most recent previous
    occurrence of the current suffix n-gram (longest of 3/2/1-grams),
    padded with its last token; else the slot's last token repeated (which
    alone captures the period-1 attractors greedy decode falls into)."""
    n = len(ctx)
    for g in (3, 2, 1):
        if n <= g:
            continue
        key = ctx[n - g:]
        for s in range(n - g - 1, -1, -1):
            if ctx[s:s + g] == key:
                cont = list(ctx[s + g:s + g + k])
                while len(cont) < k:
                    cont.append(cont[-1])
                return cont
    return [ctx[-1]] * k


@register_proposer
class NgramProposer(DraftProposer):
    """Weight-free prompt/history n-gram proposer (the baseline).

    Drafts by copying the continuation of the most recent previous
    occurrence of the slot's suffix n-gram from its host-side context
    (prompt + emitted tokens).  Runs on the host with no device dispatch;
    strong where generation repeats its input or itself.
    """

    name = "ngram"
    requires_backend_draft = False

    def propose(self, slot_ids: List[int], k: int) -> np.ndarray:
        out = np.zeros((len(slot_ids), k), np.int64)
        for r, i in enumerate(slot_ids):
            out[r] = _ngram_continuation(self.spec.ctx(i), k)
        return out


@register_proposer
class Order1SelfDraft(DraftProposer):
    """Same-weights order-1 self-draft (the paper's order hierarchy).

    The backend's ``draft_config`` drops the order-2 moment terms; the
    draft reuses the target's weights over a light order-1 moment state
    per slot (its own slotted cache).  Each round is ONE fused dispatch
    (``draft_propose``): catch-up of the tokens accepted since the last
    round, then k - 1 order-1 decode steps.  Only the catch-up state is
    kept, so the draft needs no rollback.
    """

    name = "order1"
    requires_backend_draft = True

    def __init__(self, spec: "Speculator"):
        super().__init__(spec)
        eng = spec.eng
        dcfg = resolve_backend(eng.cfg).draft_config(eng.cfg)
        if dcfg is None:
            raise ValueError(f"backend {eng.cfg.backend_desc!r} has no self-draft config")
        self.cfg = dcfg
        self._caches = slots_mod.init_slot_caches(dcfg, eng.max_slots, eng.n_max, eng.device,
                                                  eng.mesh, eng.rules)
        self._placements = None if eng.mesh is None else Placements(
            eng.mesh, slot_cache_specs(dcfg, eng.max_slots, eng.n_max, eng.mesh, eng.rules))
        # Positions the draft state has absorbed, per slot; -1 = unprimed.
        self._pos = np.full((eng.max_slots,), -1, np.int64)

    def _prime(self, slot: int) -> None:
        """(Re)build the slot's draft state from its whole context: one
        batch-1 order-1 prefill dispatch (admission, resume, recovery)."""
        eng = self.spec.eng
        p = int(eng._pos[slot])
        toks = torch.as_tensor(np.asarray(self.spec.ctx(slot)[:p], np.int64)[None],
                               device=eng.device)
        t0 = time.perf_counter()
        with eng._on_mesh(slotted=False):
            _lg, c = lm_prefill(eng.params, {"tokens": toks}, self.cfg, eng.n_max)
        self._caches = slots_mod.write_slot(self._caches, c, slot, self._placements)
        eng._sync()
        eng._stats["draft_seconds"] += time.perf_counter() - t0
        eng._stats["dispatches"] += 1
        eng._stats["draft_dispatches"] += 1
        eng._stats["draft_tokens"] += p
        self._pos[slot] = p

    def on_install(self, slot: int) -> None:
        """Prime the slot's order-1 state from its context."""
        self._prime(slot)

    def on_release(self, slot: int) -> None:
        """Mark the slot's draft state stale (primed again on reuse; the dead
        rows are overwritten by the next ``write_slot``)."""
        self._pos[slot] = -1

    def on_rebuild(self) -> None:
        self._pos[:] = -1

    def propose(self, slot_ids: List[int], k: int) -> np.ndarray:
        """Draft k tokens per slot with the order-1 state.

        Slots are grouped by catch-up width (how many accepted tokens the
        draft state is behind: at most k+1 by construction), one fused
        dispatch per width; after a full-accept round every slot needs the
        same k+1 catch-up, so the common case is one dispatch.
        """
        eng = self.spec.eng
        out = np.zeros((eng.max_slots, k), np.int64)
        by_w: Dict[int, List[int]] = {}
        for i in slot_ids:
            w = int(eng._pos[i]) - int(self._pos[i]) + 1
            if self._pos[i] < 0 or w < 1 or w > k + 1:
                self._prime(i)
                w = 1
            by_w.setdefault(w, []).append(i)
        for w, group in sorted(by_w.items()):
            window = np.zeros((eng.max_slots, w), np.int64)
            pos0 = np.zeros((eng.max_slots,), np.int32)
            mask = np.zeros((eng.max_slots,), bool)
            for i in group:
                d0 = int(self._pos[i])
                window[i] = self.spec.ctx(i)[d0:d0 + w]
                pos0[i] = d0
                mask[i] = True
            dev = lambda x: torch.as_tensor(x, device=eng.device)  # noqa: E731
            t0 = time.perf_counter()
            with eng._on_mesh(slotted=True):
                self._caches, drafts = draft_propose(eng.params, self._caches, dev(window),
                                                     dev(pos0), dev(mask), self.cfg, k)
            drafts = drafts.cpu().numpy()
            eng._stats["draft_seconds"] += time.perf_counter() - t0
            eng._stats["dispatches"] += 1
            eng._stats["draft_dispatches"] += 1
            eng._stats["draft_tokens"] += len(group) * (w + k - 1)
            for i in group:
                out[i] = drafts[i]
                self._pos[i] = int(eng._pos[i]) + 1
        return out[np.asarray(slot_ids, np.intp)]


# -- per-engine speculative driver ------------------------------------------


class Speculator:
    """Per-engine speculative-decoding driver.

    Owned by ``ServeEngine``: the scheduler calls the lifecycle hooks on
    slot install, resume, release and rebuild, and ``run_rounds`` once per
    engine step BEFORE the decode block; slots a verify advanced this step
    are left out of the block's active mask (the decode block keeps
    inactive slots' state bit-identical), so speculating and plain slots
    share a batch.  Host bookkeeping is per slot: the effective k and
    draft, and the full token context ``ctx`` (prompt + emitted, including
    the pending token) that both proposers read.
    """

    def __init__(self, eng):
        self.eng = eng
        self._proposers: Dict[str, DraftProposer] = {}
        self._ctx: List[Optional[List[int]]] = [None] * eng.max_slots
        self._slot_k = np.zeros((eng.max_slots,), np.int64)
        self._slot_draft = [""] * eng.max_slots

    # -- host bookkeeping ---------------------------------------------------

    def ctx(self, slot: int) -> List[int]:
        """The slot's host-side token context: prompt + every emitted token,
        INCLUDING the pending one at ``engine._pos[slot]`` (so ``len(ctx)
        == pos + 1`` between rounds)."""
        return self._ctx[slot]

    def spec_params(self, tr) -> Tuple[int, str]:
        """Effective ``(k, draft_name)`` of one tracked request: request
        knobs override the ``SchedulerPolicy`` defaults; sampled requests
        (temperature > 0) decode plainly (``k = 0``)."""
        req = tr.req
        k = req.speculative_k if req.speculative_k is not None else self.eng.sched.speculative_k
        if k is None or k <= 0 or req.temperature > 0:
            return 0, ""
        draft = req.draft if req.draft is not None else self.eng.sched.speculative_draft
        return int(k), draft

    def _proposer(self, name: str) -> DraftProposer:
        p = self._proposers.get(name)
        if p is None:
            p = _PROPOSERS[name](self)
            self._proposers[name] = p
        return p

    def _arm(self, slot: int, tr, ctx: List[int]) -> None:
        k, draft = self.spec_params(tr)
        self._slot_k[slot] = k
        self._slot_draft[slot] = draft
        if k <= 0:
            self._ctx[slot] = None
            return
        self._ctx[slot] = ctx
        self._proposer(draft).on_install(slot)

    # -- slot lifecycle hooks (called by the scheduler) ---------------------

    def on_install(self, slot: int, tr, out: List[int]) -> None:
        """A request was installed into ``slot`` after (re-)prefill; ``out``
        is its output so far (accepted prefix + first token)."""
        prompt = [int(t) for t in np.asarray(tr.req.tokens).reshape(-1)]
        self._arm(slot, tr, prompt + [int(t) for t in out])

    def on_resume(self, slot: int, tr) -> None:
        """A preempted request resumed into ``slot`` from its snapshot (its
        accepted tokens include the pending one)."""
        self._arm(slot, tr, [int(t) for t in tr.effective_tokens()])

    def on_release(self, slot: int) -> None:
        """``slot`` was released: drop its speculative bookkeeping."""
        if self._slot_k[slot] > 0:
            self._proposer(self._slot_draft[slot]).on_release(slot)
        self._slot_k[slot] = 0
        self._slot_draft[slot] = ""
        self._ctx[slot] = None

    def on_rebuild(self) -> None:
        """The engine rebuilt its caches after a dispatch loss: every slot's
        speculative state went with them."""
        for p in self._proposers.values():
            p.on_rebuild()
        self._slot_k[:] = 0
        self._slot_draft = [""] * self.eng.max_slots
        self._ctx = [None] * self.eng.max_slots

    def on_decode_tokens(self, slot: int, tokens: List[int]) -> None:
        """Tokens the PLAIN decode block emitted for a speculating slot (its
        last ≤ k tokens decode plainly): keeps the host context in step."""
        ctx = self._ctx[slot]
        if ctx is not None:
            ctx.extend(int(t) for t in tokens)

    # -- the verify round ---------------------------------------------------

    def run_rounds(self) -> Set[int]:
        """One draft/verify round for every due speculating slot.

        Due = active, greedy, ``remaining > k`` (the last ≤ k tokens go
        through the plain decode block).  Slots sharing k share ONE verify
        dispatch; proposals come from each slot's own proposer.

        Returns:
          The slots a verify advanced this step (the scheduler masks them
          out of this step's decode block).
        """
        eng = self.eng
        by_k: Dict[int, List[int]] = {}
        for i, st in enumerate(eng._slots):
            if st.rid is None or st.done or st.prefilling or st.remaining <= 0:
                continue
            k = int(self._slot_k[i])
            if k <= 0 or st.remaining <= k:
                continue
            by_k.setdefault(k, []).append(i)
        handled: Set[int] = set()
        for k in sorted(by_k):
            if not self._round(k, by_k[k], handled):
                break  # dispatch loss: the engine rebuilt, the round is over
        return handled

    def _round(self, k: int, slot_ids: List[int], handled: Set[int]) -> bool:
        """One verify round of the slots speculating at depth ``k``.  Returns
        False when a dispatch loss rebuilt the engine."""
        eng = self.eng
        store = eng.state_store
        width = k + 1
        props = np.zeros((eng.max_slots, k), np.int64)
        by_draft: Dict[str, List[int]] = {}
        for i in slot_ids:
            by_draft.setdefault(self._slot_draft[i], []).append(i)
        for name in sorted(by_draft):
            group = by_draft[name]
            arr = self._proposer(name).propose(group, k)
            for r, i in enumerate(group):
                props[i] = arr[r]
        # Pre-verify snapshots: the rollback source (copies, dense).
        snaps = {i: store.read_slot(eng.caches, i) for i in slot_ids}
        window = np.repeat(eng._token[:, None], width, axis=1).astype(np.int64)
        for i in slot_ids:
            window[i, 1:] = props[i]
        mask = np.zeros((eng.max_slots,), bool)
        mask[slot_ids] = True
        if store.paged:
            # the verify absorbs ``width`` window tokens per slot: grow each
            # slot's page prefix before the dispatch writes them
            for i in slot_ids:
                eng.caches = store.ensure_tokens(eng.caches, i, int(eng._pos[i]) + width)
        dev = lambda x: torch.as_tensor(x, device=eng.device)  # noqa: E731
        fn = wrap_cache_fn(verify, store.codec)
        t0 = time.perf_counter()
        try:
            with eng._on_mesh(slotted=True):
                eng.caches, greedy = eng._dispatch(lambda: fn(
                    eng.params, eng.caches, dev(window), dev(eng._pos), dev(mask), eng.cfg))
            greedy = greedy.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — the resilience boundary
            eng._rebuild_after_loss(f"verify dispatch failed: {e!r}")
            return False
        eng._stats["dispatches"] += 1
        eng._stats["verify_dispatches"] += 1
        eng._stats["verify_tokens"] += len(slot_ids) * width
        eng._stats["spec_rounds"] += 1
        for i in slot_ids:
            st = eng._slots[i]
            p = int(eng._pos[i])
            g = greedy[i]
            m = 0
            while m < k and int(props[i, m]) == int(g[m]):
                m += 1
            emitted = [int(g[j]) for j in range(m + 1)]
            eos = int(eng._eos[i])
            if eos >= 0 and eos in emitted:
                emitted = emitted[:emitted.index(eos) + 1]
                st.done = True
            st.out.extend(emitted)
            st.remaining -= len(emitted)
            ctx = self._ctx[i]
            if ctx is not None:
                ctx.extend(emitted)
            eng._stats["spec_tokens"] += len(emitted)
            eng._stats["spec_drafted"] += k
            eng._stats["spec_accepted"] += m
            if st.done or m == k:
                # full accept (or retiring on eos): the verify's state IS the
                # state plain decode would have built
                if m == k:
                    eng._stats["spec_full_accepts"] += 1
            else:
                # rollback: re-absorb the accepted window prefix from the
                # snapshot (one chunk dispatch) and splice it back
                eng._stats["spec_rollbacks"] += 1
                prefix, snap = dev(window[i:i + 1, :m + 1]), snaps.pop(i)
                try:
                    with eng._on_mesh(slotted=False):
                        _lg, c1 = eng._dispatch(lambda: lm_prefill_chunk(
                            eng.params, prefix, snap, p, eng.cfg))
                    eng.caches = store.write_slot(eng.caches, c1, i)
                except Exception as e:  # noqa: BLE001
                    eng._rebuild_after_loss(f"rollback dispatch failed: {e!r}")
                    return False
                eng._stats["dispatches"] += 1
                eng._stats["verify_tokens"] += m + 1
            eng._token[i] = int(g[m])
            eng._pos[i] = p + m + 1
            handled.add(i)
        eng._sync()
        eng._stats["verify_seconds"] += time.perf_counter() - t0
        return True
