"""Continuous-batching scheduler: slot lifecycle, admission and resilience.

``ServeEngine`` packs up to ``max_slots`` concurrent requests into one
slot-indexed decode cache (``slots.py``) and advances all of them together
with ``engine.decode_scan`` (a block of ``decode_block`` tokens per step).
Queued requests are admitted into free slots between blocks: requests of
equal prompt length share one batched prefill, whose per-request decode
states are spliced into slots with ``write_slot`` while the other slots
keep their in-flight context.  With ``prefill_chunk=`` a long prompt is
admitted chunk by chunk into a reserved PREFILLING slot, interleaved with
the decode blocks of the others.

Slot lifecycle::

  FREE --admit (prefill + write_slot)--> ACTIVE --eos / budget--> RETIRED
   ^                                       |                        |
   |                          quarantine / deadline / preempt       |
   +------------------------------ clear_slot ----------------------+

Failure semantics: every submitted request ends in exactly one terminal
``Status`` — OK, DEGRADED, TIMED_OUT, FAILED or REJECTED — retrievable as
a ``RequestResult`` via ``run(return_results=True)`` or ``poll``.
``ResiliencePolicy`` bounds the queue (shedding), degrades under
overload, enforces deadlines and queue TTLs at block boundaries, retries
with backoff after quarantine or dispatch loss, and runs the
``slot_health`` sweep that quarantines slots whose state went
non-finite without touching co-batched slots.  ``SchedulerPolicy`` turns
strict FIFO into priority admission with an interleave ratio, fat chunks
and preemption with state handoff.  A seeded ``serve.faults.FaultPlan``
exercises all of it deterministically.  The step order and every counter
are the JAX package's (``serve/load.py`` prices virtual time from them),
so a trace replays to the same ``LoadReport`` in both packages.

Speculative decoding (``serve/speculative.py``): with
``SchedulerPolicy(speculative_k=k)`` or ``Request(speculative_k=k)``
greedy slots draft k tokens per round (``"ngram"`` or the order-1
self-draft ``"order1"``) and verify them in one chunk pass before the
decode block.  State representations (``serve/state_repr.py``):
``state_dtype="int8"|"fp8"`` holds the Taylor moments quantised and
``kv_page_size=`` holds a softmax-family KV cache in pages; one
``SlotStateStore`` owns the slot cache whatever its representation.  The
vlm and encdec families take their source through ``Request.extras``
(``image_embeds`` / ``audio_frames``, validated against the config's source
shape at submit) and are always admitted by whole-prompt prefill.

On a mesh (``mesh=launch.mesh.make_serve_mesh(slots, model)``) the engine
is SPMD: every rank builds it, submits the same requests in the same order
and steps it, and every rank's ``run`` returns the same results.  The
weights lie as ``distributed.sharding.serve_param_specs`` says (heads and
``d_ff`` over "model"), the slot cache as ``slot_cache_specs`` (slots over
"data", heads over "model"), and every dispatch runs the model's one
forward in a ``distributed.spmd.region``: a decode block or a verify on
this rank's slots, a prefill (a request's batch does not divide over
"data") on every rank of "data", whose state the slot's owner keeps.  The
host scheduler decides alike on every rank: its clock reads rank 0's time
(one collective a reading), the health sweep's verdict is gathered, and
sampling draws from the gathered logits with one generator.  The
resilience boundary recovers failures that every rank sees alike (the
fault plan's); a rank that fails alone leaves the others waiting in a
collective.  A MoE block's experts lie over "model" along the expert dim
and run as the reference's ``ep_a2a`` (``models/moe.py``).  A request's
source extras run whole on every "data" rank with its prefill (the
encoder, the projector); the slot's owner keeps its ``kv_src`` row and its
block of each cross read state, which decode only reads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import enum
import itertools
import time
from collections import Counter, deque
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives as col
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import Placements, distribute_tree, serve_param_specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import lm_prefill_chunk, tree_to
from repro_torch.serve import slots as slots_mod
from repro_torch.serve import speculative as spec_mod
from repro_torch.serve.engine import decode_scan, prefill, sample_tokens
from repro_torch.serve.state_repr import make_state_store
from repro_torch.tree import tree_map


def _own_block(device):
    def own(x, spec):
        y = x.to(device)
        return y.clone() if y is x and any(spec) else y
    return own


class _MeshClock:
    """A clock that reads rank 0's time on every rank of a mesh (one
    all-gather a reading), so that deadlines, TTLs and backoffs decide
    alike everywhere."""

    def __init__(self, clock: Callable[[], float], mesh, device):
        self.clock, self.mesh, self.device = clock, mesh, device
        self.axes = tuple(mesh.mesh_dim_names)

    def __call__(self) -> float:
        t = torch.tensor([self.clock()], dtype=torch.float64, device=self.device)
        return float(col.gather_values(t, 0, self.mesh, self.axes)[0])


class Status(enum.Enum):
    """Terminal outcome of one request.

      * ``OK``        — full output produced (eos or budget).
      * ``DEGRADED``  — full output, produced under the overload degradation
        policy (budget clamped / chunked prefill forced).
      * ``TIMED_OUT`` — deadline or queue TTL expired; ``tokens`` holds the
        prefix accepted before expiry.
      * ``FAILED``    — retries exhausted after quarantine or dispatch loss;
        ``tokens`` holds the accepted prefix, ``error`` the last cause.
      * ``REJECTED``  — refused at submit (validation or shedding); no tokens.
    """

    OK = "ok"
    DEGRADED = "degraded"
    TIMED_OUT = "timed_out"
    FAILED = "failed"
    REJECTED = "rejected"


@dataclasses.dataclass(frozen=True)
class RequestResult:
    """Typed terminal outcome of one request.

    Attributes:
      status: terminal ``Status``.
      tokens: new tokens produced (``[n] int32``; the accepted prefix for
        TIMED_OUT/FAILED, empty for REJECTED).
      error: human-readable cause for unsuccessful statuses.
      retries: re-prefill retries the request consumed.
      preemptions: times the request was preempted back to the queue.
      submitted_at: engine-clock time of ``submit``.
      first_token_at: engine-clock time the first output token existed
        (end of prefill); None if the request never reached a slot.
      finished_at: engine-clock time the terminal status was recorded.
    """

    status: Status
    tokens: np.ndarray
    error: Optional[str] = None
    retries: int = 0
    preemptions: int = 0
    submitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None


class RequestRejected(ValueError):
    """Typed submit-time rejection (validation or shedding).

    Subclasses ``ValueError``, so callers that caught the untyped
    validation errors keep working.

    Attributes:
      reason: machine-readable code (``empty_prompt``, ``bad_budget``,
        ``prompt_too_long``, ``over_capacity``, ``queue_full``,
        ``bad_extras``, ``bad_speculative_k``, ``unknown_draft``,
        ``draft_unavailable``).
      rid: request id under which the engine recorded the ``REJECTED``
        ``RequestResult``.
    """

    def __init__(self, message: str, reason: str, rid: Optional[int] = None):
        super().__init__(message)
        self.reason = reason
        self.rid = rid


class QueueOverflow(RequestRejected):
    """Raised by ``submit`` when the bounded queue sheds the request
    (``ResiliencePolicy.max_queue`` reached)."""

    def __init__(self, message: str, rid: Optional[int] = None):
        super().__init__(message, reason="queue_full", rid=rid)


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Admission, deadline and recovery knobs of the serve engine.

    The defaults reproduce the plain engine on a healthy run (unbounded
    queue, no degradation) with the health sweep and bounded retries armed.

    Attributes:
      max_queue: bounded queue depth (queued + awaiting retry); a submit
        beyond it is shed with ``QueueOverflow``.  None = unbounded.
      degrade_queue_depth: queue depth at or above which new submissions
        are admitted DEGRADED.  None = never degrade.
      degraded_max_new_tokens: budget clamp of degraded submissions.
      degrade_prefill_chunk: chunked-prefill size forced on degraded
        submissions (None = the engine's).
      max_retries: re-prefill attempts per request after quarantine or
        dispatch loss before it ends FAILED.
      retry_backoff_blocks: retry ``r`` waits ``retry_backoff_blocks *
        2**(r-1)`` decode blocks before re-entering the queue (at its front).
      max_dispatch_retries: in-place re-dispatch attempts of one decode
        block; past them the engine rebuilds the cache and requeues live
        requests.
      health_check_every: run the ``slot_health`` sweep every N decode
        blocks (0 disables it).
    """

    max_queue: Optional[int] = None
    degrade_queue_depth: Optional[int] = None
    degraded_max_new_tokens: Optional[int] = None
    degrade_prefill_chunk: Optional[int] = None
    max_retries: int = 2
    retry_backoff_blocks: int = 1
    max_dispatch_retries: int = 2
    health_check_every: int = 1


@dataclasses.dataclass(frozen=True)
class SchedulerPolicy:
    """SLO-driven scheduling knobs.

    The defaults are the FIFO head-of-line scheduler: strict arrival-order
    admission, one prefill chunk per engine step, fixed chunk size, no
    preemption.

    Attributes:
      priority_admission: admit by ``(Request.priority, arrival)`` instead
        of strict FIFO, and keep admitting into remaining free slots while
        a long chunked prefill is in flight.
      decode_per_prefill: decode blocks per prefill chunk of an in-flight
        chunked admission while some slot decodes (1 = strict alternation).
      fat_chunk_depth: queue depth at which chunks FATTEN by a power-of-two
        factor (``1 + depth // fat_chunk_depth``, capped at
        ``fat_chunk_max``), so a backlog drains with fewer calls.
        None = fixed chunk size.
      fat_chunk_max: cap on the fattening factor (power of two).
      preemption: preempt a low-priority ACTIVE slot back to the queue when
        a strictly higher-priority request waits and no slot is free; its
        decode state is saved with ``read_slot`` and spliced back with
        ``write_slot`` on re-admission (no re-prefill).
      preempt_min_tokens: tokens a slot must have produced before it can be
        preempted.
      max_preemptions: per-request bound on preemptions.
      speculative_k: engine-wide speculative decoding depth: greedy slots
        draft k tokens per round and verify them in ONE chunk pass
        (``serve/speculative.py``).  0 disables speculation;
        ``Request.speculative_k`` overrides it per request.  Sampled
        requests always decode plainly.
      speculative_draft: default draft proposer: ``"ngram"`` (host-side
        prompt lookup) or ``"order1"`` (the same-weights order-1
        self-draft, on backends whose ``draft_config`` gives one).
        ``Request.draft`` overrides it; unknown names are rejected at
        submit.
    """

    priority_admission: bool = False
    decode_per_prefill: int = 1
    fat_chunk_depth: Optional[int] = None
    fat_chunk_max: int = 4
    preemption: bool = False
    preempt_min_tokens: int = 1
    max_preemptions: int = 2
    speculative_k: int = 0
    speculative_draft: str = "ngram"


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
      extras: extra model inputs with a leading batch-1 axis:
        ``image_embeds`` [1, n_image_tokens, vision_dim] for a vlm,
        ``audio_frames`` [1, n_audio_ctx, d_model] for an encdec model
        (required, at exactly the config's source shape: the slot cache is
        preallocated from it).
      deadline: seconds (engine ``clock`` units) from submit to completion,
        enforced at decode-block boundaries; None = no deadline.
      queue_ttl: seconds the request may wait queued (or awaiting retry)
        before it expires; None = waits forever.
      priority: admission class — SMALLER is more urgent; used under
        ``SchedulerPolicy.priority_admission`` and ``preemption``.
      speculative_k: per-request speculative depth (None =
        ``SchedulerPolicy.speculative_k``); an explicit value must lie in
        ``[1, max_new_tokens]``.  Only greedy requests speculate.
      draft: per-request draft proposer name (None = the policy's
        ``speculative_draft``); must name a registered proposer usable on
        the engine's backend.
    """

    tokens: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: int = 0
    eos_id: Optional[int] = None
    extras: Dict[str, np.ndarray] = dataclasses.field(default_factory=dict)
    deadline: Optional[float] = None
    queue_ttl: Optional[float] = None
    priority: int = 0
    speculative_k: Optional[int] = None
    draft: Optional[str] = None


def _next_pow2(n: int) -> int:
    """Smallest power of two >= n (keeps block lengths and chunk widths to a
    few values)."""
    return 1 << max(n - 1, 0).bit_length()


@dataclasses.dataclass
class _Slot:
    """Host-side bookkeeping for one cache slot."""

    rid: Optional[int] = None     # request id, None = free
    remaining: int = 0            # new-token budget left
    done: bool = False            # emitted eos
    prefilling: bool = False      # reserved for an in-progress chunked prefill
    out: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class _Tracked:
    """Engine-side record of one admitted request: the effective (possibly
    degraded) budget, deadline/TTL timestamps and the retry continuation —
    ``accepted`` tokens survive a quarantine and are replayed as a prompt
    suffix on re-prefill, so a greedy retry continues token-identically."""

    req: Request
    budget: int                       # post-degradation token budget
    submitted_at: float
    deadline_at: Optional[float]      # absolute; None = no deadline
    ttl_at: Optional[float]           # absolute queue TTL; None = none
    degraded: bool = False
    chunk: Optional[int] = None       # per-request prefill-chunk override
    retries: int = 0
    accepted: List[int] = dataclasses.field(default_factory=list)
    not_before_block: int = 0         # retry backoff gate
    first_token_at: Optional[float] = None
    preemptions: int = 0
    # Preemption state handoff: the slot's state saved by ``read_slot`` and
    # its token/pos entries; cleared when the request re-prefills instead.
    saved_state: Any = None
    saved_token: int = 0
    saved_pos: int = 0

    def effective_tokens(self) -> np.ndarray:
        toks = np.asarray(self.req.tokens).reshape(-1).astype(np.int64)
        if self.accepted:
            return np.concatenate([toks, np.asarray(self.accepted, np.int64)])
        return toks


@dataclasses.dataclass
class _PartialPrefill:
    """An in-progress chunked admission: the prompt is fed into a reserved
    slot's batch-1 cache one chunk per due engine step."""

    rid: int
    slot: int
    caches: Any                       # batch-1 cache being accumulated
    consumed: int = 0                 # prompt tokens absorbed so far
    logits: Optional[torch.Tensor] = None  # last chunk's final-position logits
    last_chunk_block: int = 0         # interleave-ratio gate


class ServeEngine:
    """Continuous-batching inference engine over a slotted decode cache.

    Typical use::

        eng = ServeEngine(params, cfg, max_slots=8, n_max=4096)
        rid = eng.submit(Request(tokens=prompt, max_new_tokens=64))
        outputs = eng.run()                      # {rid: np.ndarray}
        results = eng.run(return_results=True)   # {rid: RequestResult}
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
        prefill_chunk: Optional[int] = None,
        policy: Optional[ResiliencePolicy] = None,
        sched: Optional[SchedulerPolicy] = None,
        fault_plan=None,
        clock: Optional[Callable[[], float]] = None,
        mesh=None,
        rules=None,
        state_dtype: str = "dense",
        kv_page_size: Optional[int] = None,
        kv_pages: Optional[int] = None,
    ):
        """Builds the engine and allocates the slotted cache.

        Args:
          params: model params (moved to ``device`` if elsewhere; on a
            mesh each leaf is cut to this rank's block first, so whole
            weights may stay on the host).
          cfg: model config.
          max_slots: concurrent requests held on the device.
          n_max: per-request context capacity (prompt + generated tokens);
            a KV backend's cache holds n_max entries per slot.
          decode_block: tokens advanced per step; admission happens at block
            boundaries.
          generator: generator for sampled decoding (default: seed 0 on the
            engine's device).
          device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".
          prefill_chunk: admit prompts longer than this chunk by chunk
            (decoder-only), interleaved with decode blocks; None =
            whole-prompt admission.
          policy: ``ResiliencePolicy`` (None = defaults).
          sched: ``SchedulerPolicy`` (None = FIFO defaults).
          fault_plan: optional ``serve.faults.FaultPlan`` consulted at block
            boundaries.
          clock: monotonic-seconds source for deadlines and TTLs (default
            ``time.monotonic``; the load harness passes a virtual clock).
            On a mesh rank 0's reading holds on every rank.
          mesh: a ``make_serve_mesh`` mesh over the process group: the engine
            runs sharded (see the module docstring); every rank passes the
            same whole ``params``.  None = one device.
          rules: logical-to-physical axis rules on ``mesh`` (default
            ``rules_for_mesh(mesh)``); read only with a mesh.
          state_dtype: slot-state storage: "dense", or the Taylor moments
            quantised "int8"/"fp8" (backends listing it in
            ``state_dtypes``).  Compute always runs dense in float32; only
            what the engine HOLDS between dispatches changes.
          kv_page_size: hold the KV slot cache in pages of this power-of-two
            size (backends with ``supports_paged_kv``): live bytes follow
            the tokens held, not ``max_slots × n_max``.  Combined with
            ``state_dtype`` only under a hybrid schedule.
          kv_pages: the page pool's size (default ``max_slots × ⌈n_max /
            kv_page_size⌉``, which never runs out).
        """
        if max_slots < 1 or decode_block < 1:
            raise ValueError("max_slots and decode_block must be >= 1")
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 (or None)")
        self.policy = policy if policy is not None else ResiliencePolicy()
        self.sched = sched if sched is not None else SchedulerPolicy()
        if self.sched.decode_per_prefill < 1:
            raise ValueError("decode_per_prefill must be >= 1")
        if self.sched.speculative_k < 0:
            raise ValueError("speculative_k must be >= 0 (0 = off)")
        if self.sched.speculative_k > 0:
            if not spec_mod.has_proposer(self.sched.speculative_draft):
                raise ValueError(
                    f"unknown speculative_draft {self.sched.speculative_draft!r}; "
                    f"registered: {spec_mod.proposer_names()}")
            if not spec_mod.draft_available(cfg, self.sched.speculative_draft):
                raise ValueError(
                    f"draft {self.sched.speculative_draft!r} is not available on the "
                    f"{cfg.backend_desc!r} backend (no draft_config)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_slots = max_slots
        self.n_max = n_max
        self.decode_block = decode_block
        self.prefill_chunk = prefill_chunk
        self.fault_plan = fault_plan
        self._clock = clock if clock is not None else time.monotonic
        self.mesh = mesh
        self.rules = None
        self._param_specs = None
        if mesh is None:
            self.params = tree_to(params, self.device)
        else:
            self.rules = rules if rules is not None else dist_api.rules_for_mesh(mesh)
            self._param_specs = serve_param_specs(params, cfg, mesh, self.rules)
            blocks = distribute_tree(params, Placements(mesh, self._param_specs))
            # each leaf is cut before it moves, so whole weights on the host
            # never reach the card; a block already there that was cut along
            # dim 0 is a view: copy it, so the whole leaf can go
            self.params = tree_map(_own_block(self.device), blocks, self._param_specs)
            self._clock = _MeshClock(self._clock, mesh, self.device)
        # The store owns the slot cache's storage representation (dense,
        # quantised moments or paged KV) and validates it against the
        # backends' capability flags.
        self.state_store = make_state_store(
            cfg, max_slots, n_max, self.device, state_dtype=state_dtype,
            kv_page_size=kv_page_size, kv_pages=kv_pages, mesh=mesh, rules=self.rules)
        self.caches = self.state_store.init_caches()
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self._gen = generator
        self._partial: Optional[_PartialPrefill] = None
        self._rid = itertools.count()
        self._queue: deque = deque()
        self._retry: List[int] = []       # rids waiting out a backoff
        self._requests: Dict[int, _Tracked] = {}
        self._results: Dict[int, RequestResult] = {}
        self._slots = [_Slot() for _ in range(max_slots)]
        self._block = 0                   # decode-block counter (1-based)
        self._stats: Counter = Counter()
        # Per-slot vectors (host copies are authoritative between blocks).
        self._token = np.zeros((max_slots,), np.int64)
        self._pos = np.zeros((max_slots,), np.int32)
        self._temp = np.zeros((max_slots,), np.float32)
        self._topk = np.zeros((max_slots,), np.int64)
        self._eos = np.full((max_slots,), -1, np.int64)
        self._spec = spec_mod.Speculator(self)

    def _sync(self) -> None:
        """Wait for the device, so that a host-clock interval covers its work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on_mesh(self, slotted: bool):
        """The context of a dispatch: on a mesh the model's forward runs on
        this rank's blocks, of the slotted batch (``slotted``, its slots
        over "data") or of a request's batch (whole on every "data" rank)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        lay = spmd.serve_layout(self.mesh, self.rules, self.max_slots, slotted)
        return spmd.region(lay, self.params, self._param_specs)

    # -- submission ---------------------------------------------------------

    def _queue_depth(self) -> int:
        return len(self._queue) + len(self._retry)

    def submit(self, request: Request) -> int:
        """Validate, admission-control and enqueue a request.

        Returns the request id (key into ``run``'s result).  Invalid requests
        raise ``RequestRejected`` (a ``ValueError``) with a typed ``reason``;
        a full bounded queue sheds with ``QueueOverflow``.  Either way the
        engine records a terminal ``REJECTED`` result under ``exc.rid``.
        Under overload (``degrade_queue_depth``) the request is admitted
        DEGRADED: budget clamped and chunked prefill forced.
        """
        rid = next(self._rid)
        self._stats["submitted"] += 1
        try:
            self._validate(request)
            if (self.policy.max_queue is not None
                    and self._queue_depth() >= self.policy.max_queue):
                self._stats["shed"] += 1
                raise QueueOverflow(
                    f"queue full ({self._queue_depth()} >= max_queue="
                    f"{self.policy.max_queue}); request shed", rid=rid,
                )
        except RequestRejected as e:
            self._stats["rejected"] += 1
            now = self._clock()
            self._results[rid] = RequestResult(
                status=Status.REJECTED, tokens=np.zeros((0,), np.int32), error=str(e),
                submitted_at=now, finished_at=now,
            )
            if e.rid is None:
                e.rid = rid
            raise
        budget = request.max_new_tokens
        degraded = False
        chunk = None
        if (self.policy.degrade_queue_depth is not None
                and self._queue_depth() >= self.policy.degrade_queue_depth):
            degraded = True
            self._stats["degraded_admissions"] += 1
            if self.policy.degraded_max_new_tokens is not None:
                budget = min(budget, self.policy.degraded_max_new_tokens)
            chunk = self.policy.degrade_prefill_chunk
        now = self._clock()
        self._requests[rid] = _Tracked(
            req=request,
            budget=budget,
            submitted_at=now,
            deadline_at=None if request.deadline is None else now + request.deadline,
            ttl_at=None if request.queue_ttl is None else now + request.queue_ttl,
            degraded=degraded,
            chunk=chunk,
        )
        self._queue.append(rid)
        return rid

    def _validate(self, request: Request) -> None:
        """Typed submit-time validation (raises ``RequestRejected``)."""
        prompt_len = int(np.asarray(request.tokens).reshape(-1).shape[0])
        if prompt_len < 1:
            raise RequestRejected("prompt is empty (need at least one token)",
                                  reason="empty_prompt")
        if request.max_new_tokens < 1:
            raise RequestRejected(
                f"max_new_tokens must be >= 1, got {request.max_new_tokens}",
                reason="bad_budget",
            )
        if prompt_len > self.n_max:
            raise RequestRejected(
                f"prompt ({prompt_len} tokens) exceeds the engine's n_max "
                f"({self.n_max}); it can never be admitted",
                reason="prompt_too_long",
            )
        # For a KV backend n_max is also the cache's capacity: this check is
        # what keeps every token the request writes inside it.
        if prompt_len + request.max_new_tokens > self.n_max:
            raise RequestRejected(
                f"prompt ({prompt_len}) + max_new_tokens "
                f"({request.max_new_tokens}) exceeds n_max ({self.n_max})",
                reason="over_capacity",
            )
        # The slot cache preallocates the kv_src and cross-state leaves at the
        # config's source length, so every request's extras must match it.
        expected = {}
        if self.cfg.family == "vlm":
            expected["image_embeds"] = (1, self.cfg.n_image_tokens, self.cfg.vision_dim)
        elif self.cfg.family == "encdec":
            expected["audio_frames"] = (1, self.cfg.n_audio_ctx, self.cfg.d_model)
        for name, shape in expected.items():
            got = tuple(np.asarray(request.extras.get(name, ())).shape)
            if got != shape:
                raise RequestRejected(
                    f"request extra {name!r} must have shape {shape} (the slot cache "
                    f"is preallocated from the config), got {got or 'missing'} — "
                    f"pad/resize the input to the configured source length",
                    reason="bad_extras",
                )
        # An explicit per-request depth must be usable, and a draft name
        # must resolve in the proposer registry for THIS engine's backend.
        if request.speculative_k is not None:
            if request.speculative_k <= 0:
                raise RequestRejected(
                    f"speculative_k must be >= 1 when set, got {request.speculative_k} "
                    f"(omit it to disable speculation)",
                    reason="bad_speculative_k",
                )
            if request.speculative_k > request.max_new_tokens:
                raise RequestRejected(
                    f"speculative_k ({request.speculative_k}) exceeds max_new_tokens "
                    f"({request.max_new_tokens}) — the draft window can never fit the "
                    f"budget",
                    reason="bad_speculative_k",
                )
        if request.draft is not None:
            if not spec_mod.has_proposer(request.draft):
                raise RequestRejected(
                    f"unknown draft proposer {request.draft!r}; registered: "
                    f"{spec_mod.proposer_names()}",
                    reason="unknown_draft",
                )
            if not spec_mod.draft_available(self.cfg, request.draft):
                raise RequestRejected(
                    f"draft {request.draft!r} is not available on the "
                    f"{self.cfg.backend_desc!r} backend (no draft_config)",
                    reason="draft_unavailable",
                )

    # -- terminal outcomes --------------------------------------------------

    def _finalize(self, rid: int, status: Status, tokens, error: Optional[str] = None):
        """Record a request's terminal ``RequestResult`` and drop its
        tracking state."""
        tr = self._requests.pop(rid, None)
        self._results[rid] = RequestResult(
            status=status,
            tokens=np.asarray(list(tokens), np.int32),
            error=error,
            retries=tr.retries if tr is not None else 0,
            preemptions=tr.preemptions if tr is not None else 0,
            submitted_at=tr.submitted_at if tr is not None else None,
            first_token_at=tr.first_token_at if tr is not None else None,
            finished_at=self._clock(),
        )
        self._stats[status.value] += 1

    def _success_status(self, tr: Optional[_Tracked]) -> Status:
        return Status.DEGRADED if (tr is not None and tr.degraded) else Status.OK

    def _release_slot(self, idx: int) -> None:
        """Clear one slot's device state (and pages) and free its host
        record."""
        self.caches = self.state_store.clear_slot(self.caches, idx)
        self._slots[idx] = _Slot()
        self._spec.on_release(idx)

    def _requeue_for_retry(self, rid: int, accepted: List[int], error: str) -> None:
        """Bounded retry with backoff after quarantine or dispatch loss; the
        accepted tokens are kept and replayed on re-prefill.  Retries
        exhausted: FAILED with the accepted prefix."""
        tr = self._requests.get(rid)
        if tr is None:
            return
        if len(accepted) >= tr.budget:
            self._finalize(rid, self._success_status(tr), accepted)
            return
        if tr.retries >= self.policy.max_retries:
            self._finalize(rid, Status.FAILED, accepted, error=error)
            return
        tr.retries += 1
        self._stats["retries"] += 1
        tr.accepted = list(accepted)
        tr.saved_state = None  # older than ``accepted``: never resume from it
        tr.not_before_block = self._block + (
            self.policy.retry_backoff_blocks * (1 << (tr.retries - 1))
        )
        self._retry.append(rid)

    def _release_retries(self) -> None:
        """Move backoff-expired retries to the FRONT of the queue."""
        due = [rid for rid in self._retry
               if self._requests[rid].not_before_block <= self._block]
        if not due:
            return
        self._retry = [r for r in self._retry if r not in due]
        for rid in reversed(due):
            self._queue.appendleft(rid)

    def _expired(self, tr: _Tracked, now: float) -> bool:
        return ((tr.ttl_at is not None and now >= tr.ttl_at)
                or (tr.deadline_at is not None and now >= tr.deadline_at))

    def _expire(self, now: float) -> None:
        """Deadline / queue-TTL enforcement at a block boundary."""
        for rid in list(self._queue):
            tr = self._requests.get(rid)
            if tr is not None and self._expired(tr, now):
                self._queue.remove(rid)
                self._finalize(rid, Status.TIMED_OUT, tr.accepted, error="expired while queued")
        for rid in list(self._retry):
            tr = self._requests.get(rid)
            if tr is not None and self._expired(tr, now):
                self._retry.remove(rid)
                self._finalize(rid, Status.TIMED_OUT, tr.accepted,
                               error="expired awaiting retry")
        for i, st in enumerate(self._slots):
            if st.rid is None:
                continue
            tr = self._requests.get(st.rid)
            if tr is None or tr.deadline_at is None or now < tr.deadline_at:
                continue
            if st.prefilling and self._partial is not None and self._partial.rid == st.rid:
                self._partial = None
            self._finalize(st.rid, Status.TIMED_OUT, st.out, error="deadline exceeded mid-decode")
            self._release_slot(i)

    # -- slot lifecycle -----------------------------------------------------

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slots) if s.rid is None]

    def _active_mask(self) -> np.ndarray:
        return np.array(
            [s.rid is not None and not s.done and not s.prefilling and s.remaining > 0
             for s in self._slots], bool,
        )

    def _first_tokens(self, logits: torch.Tensor, trs: List[_Tracked]) -> np.ndarray:
        """The first new token of each request, from its prefill logits."""
        if any(t.req.temperature > 0 for t in trs):
            temps = torch.tensor([t.req.temperature for t in trs], device=self.device)
            topks = torch.tensor([t.req.top_k for t in trs], device=self.device)
            firsts = sample_tokens(logits, self._gen, temps, topks,
                                   max_top_k=max(t.req.top_k for t in trs))
        else:
            firsts = logits.argmax(dim=-1)
        return firsts.cpu().numpy()

    def _install(self, slot: int, rid: int, tr: _Tracked, req_caches, first: int,
                 prompt_len: int) -> None:
        """Splice a fully prefilled request into ``slot`` and arm it (for a
        retry, ``prompt_len`` covers prompt + accepted tokens and the
        accepted prefix is replayed into the output)."""
        req = tr.req
        self.caches = self.state_store.ensure_tokens(self.caches, slot, prompt_len)
        self.caches = self.state_store.write_slot(self.caches, req_caches, slot)
        st = self._slots[slot]
        st.rid, st.done, st.prefilling = rid, False, False
        st.out = list(tr.accepted) + [first]
        st.remaining = tr.budget - len(st.out)
        if tr.first_token_at is None:
            tr.first_token_at = self._clock()
        tr.saved_state = None
        self._token[slot] = first
        self._pos[slot] = prompt_len
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        if req.eos_id is not None and first == req.eos_id:
            st.done = True
        if not st.done and st.remaining > 0:
            self._spec.on_install(slot, tr, st.out)

    def _chunk_for(self, tr: _Tracked) -> Optional[int]:
        """Prefill-chunk size for one request, fattened by a power-of-two
        factor when the queue is deep (``fat_chunk_depth``)."""
        chunk = tr.chunk if tr.chunk is not None else self.prefill_chunk
        depth_at = self.sched.fat_chunk_depth
        if chunk is None or not depth_at:
            return chunk
        depth = self._queue_depth()
        if depth < depth_at:
            return chunk
        return chunk * min(self.sched.fat_chunk_max, _next_pow2(1 + depth // depth_at))

    def _needs_chunked_prefill(self, tr: _Tracked) -> bool:
        """Chunked admission is for decoder-only prompts: a request with a
        source (extras) is prefilled whole, which builds its cross state."""
        chunk = self._chunk_for(tr)
        return (chunk is not None and self.cfg.family == "lm" and not tr.req.extras
                and tr.effective_tokens().shape[-1] > chunk)

    def _advance_partial(self) -> None:
        """Feed ONE more prompt chunk of the in-progress chunked admission;
        install the request when its prompt is fully absorbed."""
        p = self._partial
        tr = self._requests[p.rid]
        toks = tr.effective_tokens()
        n = int(toks.shape[-1])
        take = min(self._chunk_for(tr), n - p.consumed)
        chunk = torch.as_tensor(toks[None, p.consumed:p.consumed + take], device=self.device)
        t0 = time.perf_counter()
        with self._on_mesh(slotted=False):
            p.logits, p.caches = lm_prefill_chunk(self.params, chunk, p.caches, p.consumed,
                                                  self.cfg)
        self._sync()
        self._stats["prefill_seconds"] += time.perf_counter() - t0
        self._stats["dispatches"] += 1
        self._stats["prefill_dispatches"] += 1
        self._stats["prefill_tokens"] += take
        p.consumed += take
        p.last_chunk_block = self._block
        if p.consumed < n:
            return
        first = int(self._first_tokens(p.logits, [tr])[0])
        self._install(p.slot, p.rid, tr, p.caches, first, n)
        self._partial = None

    def _partial_due(self) -> bool:
        """Interleave-ratio gate: with ``decode_per_prefill = N`` a chunk
        feeds every N-th step while some slot decodes; an otherwise idle
        engine always feeds."""
        n = self.sched.decode_per_prefill
        if n <= 1 or not self._active_mask().any():
            return True
        return self._block - self._partial.last_chunk_block >= n

    def _admission_order(self) -> List[int]:
        """Queued rids in admission order: arrival order (retries already at
        the front), or stable ``(priority, position)`` under
        ``priority_admission``."""
        if not self.sched.priority_admission:
            return list(self._queue)
        return [rid for _, _, rid in sorted(
            (self._requests[rid].req.priority, i, rid) for i, rid in enumerate(self._queue)
        )]

    def _resume(self, slot: int, rid: int, tr: _Tracked) -> None:
        """Re-admit a preempted request from its saved decode state: the
        state handoff, with no prefill."""
        req = tr.req
        self.caches = self.state_store.ensure_tokens(self.caches, slot, int(tr.saved_pos))
        self.caches = self.state_store.write_slot(self.caches, tr.saved_state, slot)
        st = self._slots[slot]
        st.rid, st.done, st.prefilling = rid, False, False
        st.out = list(tr.accepted)
        st.remaining = tr.budget - len(st.out)
        self._token[slot] = tr.saved_token
        self._pos[slot] = tr.saved_pos
        self._temp[slot] = req.temperature
        self._topk[slot] = req.top_k
        self._eos[slot] = -1 if req.eos_id is None else req.eos_id
        tr.saved_state = None
        self._stats["resumes"] += 1
        self._spec.on_resume(slot, tr)

    def _preempt(self) -> None:
        """Evict at most one low-priority slot per block, when preemption is
        on, no slot is free and a STRICTLY higher-priority request waits.
        The victim (worst class first, most remaining budget as tie-break)
        has its state saved with ``read_slot`` and re-enters the queue."""
        if not (self.sched.preemption and self._queue):
            return
        if any(s.rid is None for s in self._slots):
            return
        best_wait = min(self._requests[rid].req.priority
                        for rid in self._queue if rid in self._requests)
        victim = None
        for i, st in enumerate(self._slots):
            if st.rid is None or st.prefilling or st.done or st.remaining <= 0:
                continue
            tr = self._requests.get(st.rid)
            if (tr is None or tr.req.priority <= best_wait
                    or tr.preemptions >= self.sched.max_preemptions
                    or len(st.out) < self.sched.preempt_min_tokens):
                continue
            key = (tr.req.priority, st.remaining, st.rid)
            if victim is None or key > victim[0]:
                victim = (key, i)
        if victim is None:
            return
        i = victim[1]
        st = self._slots[i]
        rid, tr = st.rid, self._requests[st.rid]
        tr.saved_state = self.state_store.read_slot(self.caches, i)
        tr.saved_token = int(self._token[i])
        tr.saved_pos = int(self._pos[i])
        tr.accepted = list(st.out)
        tr.preemptions += 1
        self._stats["preemptions"] += 1
        self._release_slot(i)
        self._queue.append(rid)

    def _admit(self) -> None:
        """Prefill queued requests into free slots, between decode blocks.

        Requests of equal effective length share ONE batched prefill (under
        FIFO only consecutive ones; under ``priority_admission`` from
        anywhere in the order).  Preempted requests resume from their saved
        state with no prefill.  With ``prefill_chunk`` a long prompt is
        admitted chunk by chunk into a reserved slot; under FIFO later
        requests wait behind it (head of line), under ``priority_admission``
        they keep admitting into the remaining free slots."""
        if self._partial is not None:
            if self.fault_plan is not None and self.fault_plan.prefill_stalled(self._block):
                self._stats["prefill_stalls"] += 1
            elif self._partial_due():
                self._advance_partial()
        if self._partial is not None and not self.sched.priority_admission:
            return
        free = self._free_slots()
        order = self._admission_order()
        while free and order:
            rid = order[0]
            tr = self._requests[rid]
            if tr.saved_state is not None:
                order.pop(0)
                self._queue.remove(rid)
                self._resume(free.pop(0), rid, tr)
                continue
            if self._needs_chunked_prefill(tr):
                order.pop(0)
                if self._partial is not None:
                    continue  # one partial at a time
                self._queue.remove(rid)
                slot = free.pop(0)
                st = self._slots[slot]
                st.rid, st.prefilling, st.done = rid, True, False
                st.remaining, st.out = 0, []
                self._partial = _PartialPrefill(
                    rid=rid, slot=slot,
                    caches=slots_mod.init_slot_caches(self.cfg, 1, self.n_max, self.device,
                                                      self.mesh, self.rules),
                    last_chunk_block=self._block,
                )
                self._advance_partial()  # first chunk this step
                if not self.sched.priority_admission:
                    return
                continue
            group = [rid]
            glen = tr.effective_tokens().shape[-1]
            for cand in order[1:]:
                if len(group) >= len(free):
                    break
                ctr = self._requests[cand]
                if (ctr.saved_state is None and not self._needs_chunked_prefill(ctr)
                        and ctr.effective_tokens().shape[-1] == glen):
                    group.append(cand)
                elif not self.sched.priority_admission:
                    break
            order = [r for r in order if r not in group]
            for g in group:
                self._queue.remove(g)
            trs = [self._requests[g] for g in group]
            batch = {"tokens": torch.as_tensor(np.stack([t.effective_tokens() for t in trs]),
                                               device=self.device)}
            # extras shapes are uniform per config (checked at submit)
            for k in trs[0].req.extras:
                batch[k] = torch.as_tensor(
                    np.concatenate([np.asarray(t.req.extras[k]) for t in trs]),
                    device=self.device)
            t0 = time.perf_counter()
            with self._on_mesh(slotted=False):
                logits, pref_caches = prefill(self.params, batch, self.cfg, self.n_max)
            firsts = self._first_tokens(logits, trs)
            self._stats["prefill_seconds"] += time.perf_counter() - t0
            self._stats["dispatches"] += 1
            self._stats["prefill_dispatches"] += 1
            self._stats["prefill_tokens"] += int(glen) * len(group)
            for j, (g, t) in enumerate(zip(group, trs)):
                # the batched prefill output is DENSE: slice it with the dense
                # read, not the store's (representation-decoding) one
                req_caches = (pref_caches if len(group) == 1
                              else self.state_store.read_dense(pref_caches, j))
                self._install(free.pop(0), g, t, req_caches, int(firsts[j]), int(glen))

    def _retire_finished(self) -> None:
        for i, st in enumerate(self._slots):
            if st.prefilling:
                continue
            if st.rid is not None and (st.done or st.remaining <= 0):
                self._finalize(st.rid, self._success_status(self._requests.get(st.rid)), st.out)
                self._release_slot(i)

    # -- fault handling -----------------------------------------------------

    def _dispatch(self, run: Callable[[], Any]):
        """One device dispatch (a decode block, a verify, a rollback) with
        bounded in-place retries.

        The fault plan's injected failure fires BEFORE the real dispatch.
        The JAX package retries only while the donated cache is alive; the
        port donates no buffer (``decode_scan`` and the verify leave their
        input caches untouched, and a codec re-encodes into new tensors),
        so that test always holds here and every failure up to
        ``max_dispatch_retries`` is retried in place.  Past them the
        exception propagates to the caller's rebuild path."""
        attempts = 0
        while True:
            try:
                if self.fault_plan is not None:
                    self.fault_plan.check_dispatch(self._block)
                return run()
            except Exception:
                self._stats["dispatch_failures"] += 1
                attempts += 1
                if attempts <= self.policy.max_dispatch_retries:
                    self._stats["dispatch_retries"] += 1
                    continue
                raise

    def _rebuild_after_loss(self, error: str) -> None:
        """Recover from an unretryable dispatch failure: finalize slots whose
        output was complete, requeue live ones (bounded retries) and rebuild
        the slotted cache from zeros."""
        self._stats["cache_rebuilds"] += 1
        if self._partial is not None:
            p, self._partial = self._partial, None
            self._requeue_for_retry(p.rid, [], error)
        for i, st in enumerate(self._slots):
            if st.rid is None:
                continue
            if st.done or (st.remaining <= 0 and not st.prefilling):
                self._finalize(st.rid, self._success_status(self._requests.get(st.rid)),
                               st.out)
            elif not st.prefilling:
                self._requeue_for_retry(st.rid, list(st.out), error)
            self._slots[i] = _Slot()
        self.caches = self.state_store.init_caches()  # also resets the page allocator
        self._token[:] = 0
        self._pos[:] = 0
        self._temp[:] = 0.0
        self._topk[:] = 0
        self._eos[:] = -1
        self._spec.on_rebuild()

    def _inject_corruptions(self) -> None:
        """Apply due ``SlotCorruption`` events to the live cache, AFTER this
        block's tokens were consumed."""
        if self.fault_plan is None:
            return
        for e in self.fault_plan.take_corruptions(self._block):
            if not 0 <= e.slot < self.max_slots:
                continue
            fill = float("nan") if e.mode == "nan" else float("inf")
            self.caches = self.state_store.corrupt_slot(self.caches, e.slot, fill)
            self._stats["corruptions_injected"] += 1

    def _health_sweep(self) -> None:
        """Quarantine slots whose decode state went non-finite.

        Runs every ``health_check_every`` blocks, straight after the decode
        block (and any injected corruption), so a poisoned slot is caught
        before any of its garbage tokens is accepted.  Live slots are
        cleared and requeued with their accepted prefix; finished ones are
        finalized; every unhealthy slot is scrubbed.  Co-batched slots are
        untouched."""
        every = self.policy.health_check_every
        if not every or self._block % every:
            return
        if not any(s.rid is not None for s in self._slots):
            return
        health = self.state_store.health(self.caches).cpu().numpy()
        self._stats["health_checks"] += 1
        if health.all():
            return
        for i in np.flatnonzero(~health):
            i = int(i)
            st = self._slots[i]
            live = (st.rid is not None and not st.prefilling
                    and not st.done and st.remaining > 0)
            finished = (st.rid is not None and not st.prefilling
                        and (st.done or st.remaining <= 0))
            if live:
                self._stats["quarantined"] += 1
                rid, out = st.rid, list(st.out)
                self._slots[i] = _Slot()
                self._spec.on_release(i)
                self._requeue_for_retry(rid, out, "slot state corrupted (quarantined)")
            elif finished:
                self._finalize(st.rid, self._success_status(self._requests.get(st.rid)),
                               st.out)
                self._slots[i] = _Slot()
                self._spec.on_release(i)
            # a prefilling slot keeps its reservation: the partial's batch-1
            # cache lives outside the slot cache
            self.caches = self.state_store.clear_slot(self.caches, i)

    def _has_work(self) -> bool:
        return (bool(self._queue) or bool(self._retry)
                or any(s.rid is not None for s in self._slots))

    # -- decoding -----------------------------------------------------------

    def step(self) -> bool:
        """Admit and advance one decode block.  Returns True while work
        remains.

        One call = at most one ``decode_scan``, preceded by the block-boundary
        bookkeeping in a fixed order (the JAX package's): fault-plan floods
        → deadline/TTL expiry → retire → release backoff retries → preempt →
        admit → speculative rounds → dispatch (with bounded retry / cache
        rebuild) → corruption injection → health sweep → retire.
        """
        self._block += 1
        now = self._clock()
        if self.fault_plan is not None:
            for req in self.fault_plan.flood_requests(self._block, self.cfg.vocab):
                try:
                    self.submit(req)
                except RequestRejected:
                    pass  # recorded as a terminal REJECTED result
        self._expire(now)
        self._retire_finished()
        self._release_retries()
        self._preempt()
        self._admit()
        # Speculative rounds run BEFORE the decode block: due greedy slots
        # draft and verify, and are left out of this block's active mask.
        spec_handled = self._spec.run_rounds()
        active = self._active_mask()
        for i in spec_handled:
            active[i] = False
        if not active.any():
            if spec_handled:
                # all live work advanced by verify: the corruption and health
                # machinery still runs at the block boundary
                self._inject_corruptions()
                self._health_sweep()
            self._retire_finished()
            return self._has_work()
        steps = min(self.decode_block, max(
            s.remaining for s in self._slots
            if s.rid is not None and not s.done and not s.prefilling))
        # Block lengths are bucketed to powers of two; decoding a few tokens
        # past the smallest budget is harmless (the host trims).
        steps = min(self.decode_block, _next_pow2(max(steps, 1)))
        occupied = [i for i, s in enumerate(self._slots)
                    if s.rid is not None and not s.prefilling]
        sampling = any(self._temp[i] > 0 for i in occupied)
        max_top_k = int(max((self._topk[i] for i in occupied), default=0))
        max_top_k = _next_pow2(max_top_k) if max_top_k > 0 else 0
        if self.state_store.paged:
            # every active slot writes up to ``steps`` new KV rows: grow its
            # page prefix first (the table is pushed once if it changed)
            for i in np.flatnonzero(active):
                self.caches = self.state_store.ensure_tokens(
                    self.caches, int(i), int(self._pos[i]) + int(steps))
        dev = lambda x: torch.as_tensor(x, device=self.device)  # noqa: E731
        t0, c0 = time.perf_counter(), sum(col.calls.values())
        try:
            with self._on_mesh(slotted=True):
                self.caches, token, pos, dev_active, toks, mask = self._dispatch(
                    lambda: decode_scan(
                        self.params, self.caches, dev(self._token), dev(self._pos),
                        dev(active), dev(self._temp), dev(self._topk), dev(self._eos),
                        self._gen, self.cfg, steps, sampling=sampling, max_top_k=max_top_k,
                        codec=self.state_store.codec,
                    ))
            toks, mask = toks.cpu().numpy(), mask.cpu().numpy()
        except Exception as e:  # noqa: BLE001 — the resilience boundary
            self._rebuild_after_loss(f"decode dispatch failed: {e!r}")
            return self._has_work()
        self._stats["decode_seconds"] += time.perf_counter() - t0
        if self.mesh is not None:
            self._stats["decode_collectives"] += sum(col.calls.values()) - c0
        self._stats["dispatches"] += 1
        self._stats["decode_dispatches"] += 1
        self._token = token.cpu().numpy().astype(np.int64)
        self._pos = pos.cpu().numpy().astype(np.int32)
        dev_active = dev_active.cpu().numpy()
        for i, st in enumerate(self._slots):
            if st.rid is None or st.done or st.prefilling or not active[i]:
                continue
            emitted_from = len(st.out)
            for t in range(toks.shape[0]):
                if not mask[t, i] or st.remaining <= 0:
                    break
                st.out.append(int(toks[t, i]))
                st.remaining -= 1
                self._stats["decode_tokens"] += 1
                if self._eos[i] >= 0 and toks[t, i] == self._eos[i]:
                    st.done = True
                    break
            # a speculating slot decodes its last <= k tokens plainly: keep
            # its host-side draft context in step
            self._spec.on_decode_tokens(i, st.out[emitted_from:])
            if not dev_active[i]:
                st.done = True
        self._inject_corruptions()
        self._health_sweep()
        self._retire_finished()
        return self._has_work()

    def run(self, return_results: bool = False):
        """Drive admission and decoding until every submitted request is done.

        Each request's outcome is returned by exactly one ``run`` or ``poll``
        call.

        Args:
          return_results: False returns ``{rid: np.ndarray}`` of new tokens
            (non-OK statuses with their accepted prefix); True returns
            ``{rid: RequestResult}``.

        Returns:
          The outcome of every request that reached a terminal status since
          the previous drain (REJECTED submissions included).
        """
        while self.step():
            pass
        results = self.poll()
        return results if return_results else {rid: r.tokens for rid, r in results.items()}

    def poll(self) -> Dict[int, RequestResult]:
        """Drain the terminal results accumulated so far, without stepping:
        ``{rid: RequestResult}`` (possibly empty)."""
        out, self._results = self._results, {}
        return out

    def stats(self) -> Dict[str, float]:
        """Counters and gauges since construction (an absent counter is 0).

        Counters (the JAX package's): ``submitted``, ``rejected``, ``shed``,
        ``degraded_admissions``, the terminal statuses (``ok``,
        ``degraded``, ``timed_out``, ``failed``), ``quarantined``,
        ``retries``, ``dispatch_failures``, ``dispatch_retries``,
        ``cache_rebuilds``, ``corruptions_injected``, ``health_checks``,
        ``prefill_stalls``, ``dispatches``, ``decode_dispatches``,
        ``decode_tokens``, ``prefill_dispatches``, ``prefill_tokens``,
        ``preemptions``, ``resumes``; speculative decoding:
        ``spec_rounds``/``verify_dispatches`` (verify chunk dispatches),
        ``verify_tokens`` (window tokens absorbed, rollback re-absorbs
        included), ``spec_tokens`` (tokens EMITTED by verify, counted
        beside ``decode_tokens``), ``spec_drafted``/``spec_accepted`` (the
        acceptance ratio), ``spec_full_accepts``, ``spec_rollbacks``, and
        ``draft_dispatches``/``draft_tokens`` (the order-1 self-draft's
        cost; the n-gram proposer runs on the host and adds none).  The
        port's own: host-clock ``prefill_seconds`` / ``decode_seconds`` /
        ``verify_seconds`` (verify and rollback) / ``draft_seconds`` (each
        ends when the work's results reach the host, so it covers the
        device work) and, on a mesh, ``decode_collectives`` (the c10d calls
        of the decode blocks, retries included).  Gauges: ``blocks``, ``queue_depth``,
        ``slots_occupied``.
        """
        out = dict(self._stats)
        out["blocks"] = self._block
        out["queue_depth"] = self._queue_depth()
        out["slots_occupied"] = sum(1 for s in self._slots if s.rid is not None)
        return out

    @property
    def slot_state_bytes(self) -> int:
        """Decode-state bytes one slot occupies, LIVE: a paged store counts
        the pages in use, a quantised one the payload and scales; dense
        state gives ``slots.slot_bytes`` of the cache."""
        return self.state_store.slot_bytes(self.caches)

    @property
    def live_state_bytes(self) -> int:
        """Decode-state bytes LIVE on the device (the sum
        ``slot_state_bytes`` averages)."""
        return self.state_store.live_bytes(self.caches)
