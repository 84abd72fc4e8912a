"""Continuous-batching scheduler: request queue, slot lifecycle, admission.

``ServeEngine`` packs up to ``max_slots`` concurrent requests into one
slot-indexed decode cache (``slots.py``) and advances all of them together
with ``engine.decode_scan`` (a block of ``decode_block`` tokens per step).
Queued requests are admitted into free slots between blocks, in arrival
order: consecutive requests of equal prompt length share one batched
prefill, whose per-request decode states are spliced into slots with
``write_slot`` while the other slots keep their in-flight context.

Slot lifecycle::

  FREE --admit (prefill + write_slot)--> ACTIVE --eos / budget--> RETIRED
   ^                                                               |
   +-------------------------- clear_slot -------------------------+

Not yet ported from the JAX package's engine: resilience (deadlines,
shedding, retries, quarantine, fault injection), preemption, chunked
prefill, speculative decoding, state codecs and meshes.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections import Counter, deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import tree_to
from repro_torch.serve import slots as slots_mod
from repro_torch.serve.engine import decode_scan, prefill, sample_tokens


@dataclasses.dataclass
class Request:
    """One generation request.

    Attributes:
      tokens: prompt token ids, ``[n]`` int (list or ndarray).
      max_new_tokens: generation budget, counting the first token sampled
        from the prefill logits.
      temperature: 0 = greedy argmax; > 0 samples at this temperature.
      top_k: > 0 restricts sampling to the k highest-logit tokens.
      eos_id: stop token — generation ends once it is emitted (the eos token
        itself is included in the output).  None = never stop early.
    """

    tokens: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n (keeps block lengths to a few values)."""
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one cache slot."""

    rid: Optional[int] = None     # request id, None = free
    remaining: int = 0            # new-token budget left
    done: bool = False            # emitted eos
    out: List[int] = dataclasses.field(default_factory=list)


class ServeEngine:
    """Continuous-batching inference engine over a slotted decode cache.

    Typical use::

        eng = ServeEngine(params, cfg, max_slots=8, n_max=4096)
        rid = eng.submit(Request(tokens=prompt, max_new_tokens=64))
        outputs = eng.run()          # {rid: np.ndarray of new tokens}
    """

    def __init__(
        self,
        params,
        cfg: ModelConfig,
        max_slots: int,
        n_max: int,
        decode_block: int = 16,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        """Builds the engine and allocates the slotted cache.

        Args:
          params: model params (moved to ``device`` if elsewhere).
          cfg: model config.
          max_slots: concurrent requests held on the device.
          n_max: per-request context capacity (prompt + generated tokens);
            a KV backend's cache holds n_max entries per slot.
          decode_block: tokens advanced per step; admission happens at block
            boundaries.
          generator: generator for sampled decoding (default: seed 0 on the
            engine's device).
          device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".
        """
        if max_slots < 1 or decode_block < 1:
            raise ValueError("max_slots and decode_block must be >= 1")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.n_max = n_max
        self.decode_block = decode_block
        self.params = tree_to(params, self.device)
        self.caches = slots_mod.init_slot_caches(cfg, max_slots, n_max, self.device)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self._gen = generator
        self._rid = itertools.count()
        self._queue: deque = deque()
        self._requests: Dict[int, Request] = {}
        self._results: Dict[int, np.ndarray] = {}
        self._slots = [_Slot() for _ in range(max_slots)]
        self._stats: Counter = Counter()
        # Per-slot vectors (host copies are authoritative between blocks).
        self._token = np.zeros((max_slots,), np.int64)
        self._pos = np.zeros((max_slots,), np.int32)
        self._temp = np.zeros((max_slots,), np.float32)
        self._topk = np.zeros((max_slots,), np.int64)
        self._eos = np.full((max_slots,), -1, np.int64)

    # -- submission ---------------------------------------------------------

    def submit(self, request: Request) -> int:
        """Validate and enqueue a request; returns its id (key into ``run``'s
        result).  Invalid requests raise ``ValueError``."""
        prompt_len = int(np.asarray(request.tokens).reshape(-1).shape[0])
        if prompt_len < 1:
            raise ValueError("prompt is empty (need at least one token)")
        if request.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {request.max_new_tokens}")
        # For a KV backend n_max is also the cache's capacity: this check is
        # what keeps every token the request writes inside it.
        if prompt_len + request.max_new_tokens > self.n_max:
            raise ValueError(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds n_max ({self.n_max})"
            )
        rid = next(self._rid)
        self._stats["submitted"] += 1
        self._requests[rid] = request
        self._queue.append(rid)
        return rid

    # -- slot lifecycle -----------------------------------------------------

    def _prompt(self, rid: int) -> np.ndarray:
        return np.asarray(self._requests[rid].tokens).reshape(-1).astype(np.int64)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.rid is None]

    def _active_mask(self) -> np.ndarray:
        return np.array(
            [s.rid is not None and not s.done and s.remaining > 0
             for s in self._slots], bool,
        )

    def _install(self, slot: int, rid: int, req_caches, first: int, prompt_len: int):
        """Splice a prefilled request into ``slot`` and arm it."""
        req = self._requests[rid]
        self.caches = slots_mod.write_slot(self.caches, req_caches, slot)
        st = self._slots[slot]
        st.rid, st.done, st.out = rid, False, [first]
        st.remaining = req.max_new_tokens - 1
        self._token[slot] = first
        self._pos[slot] = prompt_len
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        if req.eos_id is not None and first == req.eos_id:
            st.done = True

    def _admit(self) -> None:
        """Prefill queued requests into free slots, in arrival order.

        Consecutive queued requests of equal prompt length share ONE batched
        prefill (FIFO: grouping stops at the first length mismatch)."""
        free = self._free_slots()
        while free and self._queue:
            group = [self._queue.popleft()]
            glen = self._prompt(group[0]).shape[0]
            while (self._queue and len(group) < len(free)
                   and self._prompt(self._queue[0]).shape[0] == glen):
                group.append(self._queue.popleft())
            reqs = [self._requests[r] for r in group]
            tokens = torch.as_tensor(
                np.stack([self._prompt(r) for r in group]), device=self.device
            )
            t0 = time.perf_counter()
            logits, pref_caches = prefill(self.params, {"tokens": tokens},
                                          self.cfg, self.n_max)
            temps = torch.tensor([r.temperature for r in reqs], device=self.device)
            topks = torch.tensor([r.top_k for r in reqs], device=self.device)
            if any(r.temperature > 0 for r in reqs):
                firsts = sample_tokens(logits, self._gen, temps, topks,
                                       max_top_k=max(r.top_k for r in reqs))
            else:
                firsts = logits.argmax(dim=-1)
            firsts = firsts.cpu().numpy()
            self._stats["prefill_seconds"] += time.perf_counter() - t0
            self._stats["prefill_dispatches"] += 1
            self._stats["prefill_tokens"] += int(glen) * len(group)
            for j, rid in enumerate(group):
                req_caches = (pref_caches if len(group) == 1
                              else slots_mod.read_slot(pref_caches, j))
                self._install(free.pop(0), rid, req_caches, int(firsts[j]), int(glen))

    def _retire_finished(self) -> None:
        for i, st in enumerate(self._slots):
            if st.rid is not None and (st.done or st.remaining <= 0):
                self._results[st.rid] = np.asarray(st.out, np.int64)
                self._requests.pop(st.rid)
                self._stats["finished"] += 1
                self.caches = slots_mod.clear_slot(self.caches, i)
                self._slots[i] = _Slot()

    def _has_work(self) -> bool:
        return bool(self._queue) or any(s.rid is not None for s in self._slots)

    # -- decoding -----------------------------------------------------------

    def step(self) -> bool:
        """Retire, admit and advance one decode block.  Returns True while
        work remains."""
        self._retire_finished()
        self._admit()
        active = self._active_mask()
        if not active.any():
            self._retire_finished()
            return self._has_work()
        steps = min(self.decode_block,
                    max(s.remaining for s in self._slots if s.rid is not None
                        and not s.done))
        # Block lengths are bucketed to powers of two; decoding a few tokens
        # past the smallest budget is harmless (the host trims).
        steps = min(self.decode_block, _next_pow2(max(steps, 1)))
        occupied = [i for i, s in enumerate(self._slots) if s.rid is not None]
        sampling = any(self._temp[i] > 0 for i in occupied)
        max_top_k = int(max((self._topk[i] for i in occupied), default=0))
        max_top_k = _next_pow2(max_top_k) if max_top_k > 0 else 0
        dev = lambda x: torch.as_tensor(x, device=self.device)
        t0 = time.perf_counter()
        self.caches, token, pos, _, toks, mask = decode_scan(
            self.params, self.caches, dev(self._token), dev(self._pos),
            dev(active), dev(self._temp), dev(self._topk), dev(self._eos),
            self._gen, self.cfg, steps, sampling=sampling, max_top_k=max_top_k,
        )
        toks, mask = toks.cpu().numpy(), mask.cpu().numpy()
        self._stats["decode_seconds"] += time.perf_counter() - t0
        self._stats["decode_dispatches"] += 1
        self._token = token.cpu().numpy().astype(np.int64)
        self._pos = pos.cpu().numpy().astype(np.int32)
        for i, st in enumerate(self._slots):
            if not active[i]:
                continue
            for t in range(toks.shape[0]):
                if not mask[t, i] or st.remaining <= 0:
                    break
                st.out.append(int(toks[t, i]))
                st.remaining -= 1
                self._stats["decode_tokens"] += 1
                if self._eos[i] >= 0 and toks[t, i] == self._eos[i]:
                    st.done = True
                    break
        self._retire_finished()
        return self._has_work()

    def run(self) -> Dict[int, np.ndarray]:
        """Drive admission + decoding until every submitted request is done.

        Returns ``{rid: np.ndarray[int64]}`` of new tokens for every request
        finished since the previous ``run``."""
        while self.step():
            pass
        out, self._results = self._results, {}
        return out

    def stats(self) -> Dict[str, float]:
        """Counters since construction: ``submitted``, ``finished``,
        ``prefill_dispatches``, ``prefill_tokens``, ``decode_dispatches``,
        ``decode_tokens``, and host-clock ``prefill_seconds`` /
        ``decode_seconds`` (each ends when the block's tokens reach the host,
        so it covers the device work)."""
        return dict(self._stats)
