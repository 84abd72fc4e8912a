"""Traffic-realism load harness: seeded arrival traces + virtual-clock replay
(the JAX package's ``serve/load.py``, kept as the port's own copy).

This module generates DETERMINISTIC open-loop traffic and replays it
against a ``ServeEngine`` under a virtual clock, reporting the serving
metrics that matter under load — TTFT, per-token latency percentiles,
goodput under an SLO, shed/degrade rates, dispatches per token.

Three pieces:

* Trace generation — ``poisson_trace`` (memoryless arrivals) and
  ``bursty_trace`` (two-state Markov-modulated Poisson: calm/burst) build
  replayable ``Trace`` objects with mixed prompt/output length
  distributions, fully determined by their seed.
* Virtual time — ``VirtualClock`` is injected as the engine's ``clock=``;
  ``CostModel`` advances it per engine step from the engine's own dispatch
  and token counters (``stats()``), so deadlines, TTLs, and every latency
  metric are machine-independent and byte-replayable.
* Replay — ``run_trace`` drives submission + stepping and folds terminal
  ``RequestResult``s into a ``LoadReport`` whose ``to_json()`` is
  byte-identical across runs of the same (trace, policy) pair, and to the
  JAX package's report for the same pair (``tests/test_torch_sched.py``):
  virtual time is priced from the engine's counters, which the two
  engines share, never from the wall clock.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.scheduler import Request, RequestRejected, ServeEngine

__all__ = [
    "CostModel",
    "LoadReport",
    "SLO",
    "Trace",
    "TraceItem",
    "VirtualClock",
    "bursty_trace",
    "poisson_trace",
    "run_trace",
]


class VirtualClock:
    """Deterministic monotonic clock for trace replay.

    Callable like ``time.monotonic`` — pass an instance as the engine's
    ``clock=`` so deadlines/queue-TTLs tick in virtual seconds that
    ``run_trace`` advances from the ``CostModel``, never from wall time.
    """

    def __init__(self, start: float = 0.0):
        """Starts the clock at ``start`` virtual seconds."""
        self._t = float(start)

    def __call__(self) -> float:
        """Current virtual time in seconds (the ``clock=`` protocol)."""
        return self._t

    def now(self) -> float:
        """Current virtual time in seconds."""
        return self._t

    def advance(self, seconds: float) -> None:
        """Move the clock forward by ``seconds`` (must be >= 0)."""
        if seconds < 0:
            raise ValueError("virtual clock cannot go backwards")
        self._t += seconds

    def advance_to(self, t: float) -> None:
        """Jump forward to absolute time ``t`` (no-op if already past)."""
        self._t = max(self._t, float(t))


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Virtual-time cost of one engine step, priced from ``stats()`` deltas.

    Serving overheads are per-DISPATCH (a decode step on the card is
    host-bound: PERF.md §5), so virtual time is dominated by
    ``dispatch_us`` with small per-token terms.  Pricing from
    the engine's own counters keeps replay byte-deterministic and makes
    scheduler policies comparable by the thing they actually control:
    how many dispatches they spend per token served.

    Attributes:
      dispatch_us: cost per device round-trip (decode block, prefill,
        speculative verify/draft/rollback — every dispatch the engine
        counts in ``stats()["dispatches"]`` is priced identically, which
        is what makes speculative and plain rows comparable).
      decode_token_us: cost per accepted decode token.
      prefill_token_us: cost per prefilled prompt token.
      spec_token_us: cost per speculative window token absorbed — verify
        windows, rollback re-absorbs (``verify_tokens``) and order-1
        draft catch-up/scan tokens (``draft_tokens``).  Chunk-parallel
        like prefill but over the full slotted batch, so priced between
        the prefill and decode per-token rates.
      step_floor_us: minimum cost of any engine step (host bookkeeping) —
        guarantees the virtual clock always advances.
    """

    dispatch_us: float = 100.0
    decode_token_us: float = 1.0
    prefill_token_us: float = 0.25
    spec_token_us: float = 0.5
    step_floor_us: float = 1.0

    def step_cost_us(self, before: Dict[str, int],
                     after: Dict[str, int]) -> float:
        """Virtual microseconds one engine step took, from its stat deltas."""
        def d(key: str) -> int:
            return after.get(key, 0) - before.get(key, 0)

        return max(
            self.step_floor_us,
            self.dispatch_us * d("dispatches")
            + self.decode_token_us * d("decode_tokens")
            + self.prefill_token_us * d("prefill_tokens")
            + self.spec_token_us * (d("verify_tokens") + d("draft_tokens")),
        )


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request service-level objective evaluated in virtual time.

    A delivered (OK/DEGRADED) request MEETS the SLO when its TTFT and its
    mean per-token decode latency are both within budget; goodput counts
    only tokens of SLO-meeting requests.

    Attributes:
      ttft_us: time-to-first-token budget (virtual microseconds).
      per_token_us: mean decode latency budget per token after the first.
    """

    ttft_us: float = 50_000.0
    per_token_us: float = 2_000.0


@dataclasses.dataclass(frozen=True)
class TraceItem:
    """One arrival in a trace.

    Attributes:
      t: arrival time, virtual seconds from trace start.
      tokens: prompt token ids (immutable tuple — the item is hashable).
      max_new_tokens: generation budget.
      priority: admission class (smaller = more urgent).
      deadline: per-request completion budget in virtual seconds.
      queue_ttl: max queued wait in virtual seconds.
    """

    t: float
    tokens: Tuple[int, ...]
    max_new_tokens: int
    priority: int = 0
    deadline: Optional[float] = None
    queue_ttl: Optional[float] = None

    def request(self) -> Request:
        """The ``Request`` this item submits (fresh object per call)."""
        return Request(
            tokens=np.asarray(self.tokens, np.int32),
            max_new_tokens=self.max_new_tokens,
            priority=self.priority,
            deadline=self.deadline,
            queue_ttl=self.queue_ttl,
        )


@dataclasses.dataclass(frozen=True)
class Trace:
    """A replayable arrival trace: seeded, immutable, self-describing.

    Traces are fully determined at construction (prompt tokens included),
    so replaying one against the same engine policy produces byte-identical
    ``LoadReport.to_json()`` output — the determinism contract of the load
    harness.

    Attributes:
      name: trace label (``poisson`` / ``bursty``).
      seed: generator seed the items were drawn from.
      items: arrivals in non-decreasing ``t`` order.
    """

    name: str
    seed: int
    items: Tuple[TraceItem, ...]

    def __len__(self) -> int:
        """Number of arrivals."""
        return len(self.items)


def _draw_items(
    rng: np.random.Generator,
    interarrivals: np.ndarray,
    vocab: int,
    prompt_len: Tuple[int, int],
    new_tokens: Tuple[int, int],
    priorities: Sequence[int],
    deadline: Optional[float],
    queue_ttl: Optional[float],
) -> Tuple[TraceItem, ...]:
    """Draw per-arrival prompt/budget/priority given the arrival process."""
    t = 0.0
    items: List[TraceItem] = []
    for gap in interarrivals:
        t += float(gap)
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        items.append(TraceItem(
            t=t,
            tokens=tuple(int(x) for x in rng.integers(0, vocab, size=plen)),
            max_new_tokens=int(
                rng.integers(new_tokens[0], new_tokens[1] + 1)
            ),
            priority=int(priorities[int(rng.integers(0, len(priorities)))]),
            deadline=deadline,
            queue_ttl=queue_ttl,
        ))
    return tuple(items)


def poisson_trace(
    seed: int,
    n: int,
    vocab: int,
    mean_interarrival_s: float = 0.002,
    prompt_len: Tuple[int, int] = (4, 24),
    new_tokens: Tuple[int, int] = (4, 16),
    priorities: Sequence[int] = (0,),
    deadline: Optional[float] = None,
    queue_ttl: Optional[float] = None,
) -> Trace:
    """Poisson (memoryless) arrival trace with mixed lengths.

    Interarrival gaps are exponential with the given mean; prompt lengths,
    output budgets, and priorities are drawn uniformly per arrival.  The
    same seed always yields the same trace, tokens included.

    Args:
      seed: RNG seed — the trace's identity.
      n: number of arrivals.
      vocab: prompt token ids are drawn from ``[0, vocab)``.
      mean_interarrival_s: mean gap between arrivals, virtual seconds.
      prompt_len: inclusive ``(lo, hi)`` prompt-length range.
      new_tokens: inclusive ``(lo, hi)`` generation-budget range.
      priorities: admission classes sampled uniformly per arrival.
      deadline: per-request completion budget (virtual s); None = none.
      queue_ttl: per-request max queued wait (virtual s); None = none.

    Returns:
      A ``Trace`` named ``poisson`` with ``n`` items in arrival order.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(mean_interarrival_s, size=n)
    return Trace(name="poisson", seed=seed, items=_draw_items(
        rng, gaps, vocab, prompt_len, new_tokens, priorities,
        deadline, queue_ttl,
    ))


def bursty_trace(
    seed: int,
    n: int,
    vocab: int,
    calm_interarrival_s: float = 0.004,
    burst_interarrival_s: float = 0.0005,
    p_enter_burst: float = 0.15,
    p_exit_burst: float = 0.3,
    prompt_len: Tuple[int, int] = (4, 24),
    new_tokens: Tuple[int, int] = (4, 16),
    priorities: Sequence[int] = (0,),
    deadline: Optional[float] = None,
    queue_ttl: Optional[float] = None,
) -> Trace:
    """Bursty arrival trace: two-state Markov-modulated Poisson process.

    A hidden calm/burst state flips per arrival with the given transition
    probabilities; each state draws exponential gaps with its own mean, so
    the trace alternates quiet stretches with dense request storms — the
    regime where admission policy, shedding, and preemption actually
    differ.  Deterministic per seed.

    Args:
      seed: RNG seed — the trace's identity.
      n: number of arrivals.
      vocab: prompt token ids are drawn from ``[0, vocab)``.
      calm_interarrival_s: mean gap in the calm state, virtual seconds.
      burst_interarrival_s: mean gap in the burst state, virtual seconds.
      p_enter_burst: per-arrival probability calm -> burst.
      p_exit_burst: per-arrival probability burst -> calm.
      prompt_len: inclusive ``(lo, hi)`` prompt-length range.
      new_tokens: inclusive ``(lo, hi)`` generation-budget range.
      priorities: admission classes sampled uniformly per arrival.
      deadline: per-request completion budget (virtual s); None = none.
      queue_ttl: per-request max queued wait (virtual s); None = none.

    Returns:
      A ``Trace`` named ``bursty`` with ``n`` items in arrival order.
    """
    rng = np.random.default_rng(seed)
    gaps = np.empty(n)
    burst = False
    for i in range(n):
        flip = float(rng.random())
        if burst and flip < p_exit_burst:
            burst = False
        elif not burst and flip < p_enter_burst:
            burst = True
        mean = burst_interarrival_s if burst else calm_interarrival_s
        gaps[i] = rng.exponential(mean)
    return Trace(name="bursty", seed=seed, items=_draw_items(
        rng, gaps, vocab, prompt_len, new_tokens, priorities,
        deadline, queue_ttl,
    ))


def _round(x: float) -> float:
    """3-decimal rounding — keeps report JSON byte-stable."""
    return round(float(x), 3)


@dataclasses.dataclass
class LoadReport:
    """Outcome of replaying one trace against one engine policy.

    ``metrics`` holds the aggregate numbers of the replay; ``outcomes`` is
    the per-request terminal log (rid order).  Both are plain
    JSON-serialisable values, and ``to_json()`` is byte-identical
    for identical (trace, policy, cost model) replays.

    Attributes:
      trace: trace name.
      policy: caller-supplied policy label (e.g. ``fifo`` / ``slo``).
      metrics: aggregate metric name -> value (floats rounded to 3dp).
      outcomes: per-request dicts: rid, status, n_tokens, ttft_us,
        finished_at_us, retries, preemptions.
    """

    trace: str
    policy: str
    metrics: Dict[str, float]
    outcomes: List[Dict[str, object]]

    def to_json(self) -> str:
        """Canonical JSON encoding (sorted keys, no whitespace drift)."""
        return json.dumps(
            {"trace": self.trace, "policy": self.policy,
             "metrics": self.metrics, "outcomes": self.outcomes},
            sort_keys=True, separators=(",", ":"),
        )


def run_trace(
    engine_factory: Callable[[VirtualClock], ServeEngine],
    trace: Trace,
    policy_label: str = "fifo",
    cost: Optional[CostModel] = None,
    slo: Optional[SLO] = None,
    max_steps: int = 100_000,
    step_hook: Optional[Callable[[ServeEngine], None]] = None,
) -> LoadReport:
    """Replay a trace against an engine under the virtual clock.

    Open-loop replay: arrivals are submitted when the virtual clock
    reaches their trace time (never earlier, regardless of engine
    backlog), the engine is stepped while it has work, and the clock
    advances per step by the ``CostModel`` price of that step's stat
    deltas.  With a deterministic engine policy the entire replay —
    metrics, outcome log, token streams — is a pure function of
    ``(trace, policy, cost)``.

    Args:
      engine_factory: builds the ``ServeEngine`` under test; MUST pass the
        provided ``VirtualClock`` as the engine's ``clock=`` or deadlines
        and TTLs will tick in wall time instead of virtual time.
      trace: the arrival trace to replay.
      policy_label: label recorded in the report (``fifo``, ``slo``, ...).
      cost: virtual-time cost model (default ``CostModel()``).
      slo: goodput objective (default ``SLO()``).
      max_steps: engine-step bound — exceeded means the replay livelocked,
        which raises rather than spins.
      step_hook: optional callback invoked with the engine after every
        engine step (tests use it to check invariants mid-flight).

    Returns:
      A ``LoadReport`` with TTFT/per-token percentiles (p50/p99),
      goodput-under-SLO, shed/degrade rates, dispatch accounting, and the
      per-request outcome log.
    """
    cost = cost if cost is not None else CostModel()
    slo = slo if slo is not None else SLO()
    clock = VirtualClock()
    eng = engine_factory(clock)
    pending = list(trace.items)
    results: Dict[int, object] = {}
    steps = 0
    while True:
        while pending and pending[0].t <= clock.now():
            item = pending.pop(0)
            try:
                eng.submit(item.request())
            except RequestRejected:
                pass  # terminal REJECTED result is recorded under its rid
        st = eng.stats()
        busy = st["queue_depth"] > 0 or st["slots_occupied"] > 0
        if busy:
            steps += 1
            if steps > max_steps:
                raise RuntimeError(
                    f"run_trace exceeded {max_steps} engine steps"
                )
            before = eng.stats()
            eng.step()
            clock.advance(cost.step_cost_us(before, eng.stats()) * 1e-6)
            if step_hook is not None:
                step_hook(eng)
        elif pending:
            clock.advance_to(pending[0].t)
        else:
            break
        results.update(eng.poll())
    results.update(eng.poll())
    return _report(trace, policy_label, results, eng.stats(), slo,
                   clock.now())


def _report(trace: Trace, policy_label: str, results, stats: Dict[str, int],
            slo: SLO, duration_s: float) -> LoadReport:
    """Fold terminal results + engine counters into a ``LoadReport``."""
    ttfts: List[float] = []
    per_tok: List[float] = []
    slo_ok_tokens = 0
    n_slo_ok = 0
    delivered = 0
    outcomes: List[Dict[str, object]] = []
    for rid in sorted(results):
        r = results[rid]
        n_tok = int(np.asarray(r.tokens).size)
        ttft_us = None
        if r.first_token_at is not None and r.submitted_at is not None:
            ttft_us = (r.first_token_at - r.submitted_at) * 1e6
        outcomes.append({
            "rid": int(rid),
            "status": r.status.value,
            "n_tokens": n_tok,
            "ttft_us": None if ttft_us is None else _round(ttft_us),
            "finished_at_us": None if r.finished_at is None
            else _round(r.finished_at * 1e6),
            "retries": int(r.retries),
            "preemptions": int(r.preemptions),
        })
        if r.status.value not in ("ok", "degraded") or ttft_us is None:
            continue
        delivered += 1
        decode_us = (r.finished_at - r.first_token_at) * 1e6
        tok_us = decode_us / max(n_tok - 1, 1)
        ttfts.append(ttft_us)
        per_tok.append(tok_us)
        if ttft_us <= slo.ttft_us and tok_us <= slo.per_token_us:
            n_slo_ok += 1
            slo_ok_tokens += n_tok
    n = len(results)
    dispatches = stats.get("dispatches", 0)
    # Every emitted token enters the denominator exactly once, whichever
    # path produced it: plain decode blocks (``decode_tokens``),
    # speculative verify rounds (``spec_tokens``), plus each delivered
    # request's first token (sampled from prefill logits).  The port has no
    # speculative decoding yet, so its spec counters are absent (0).
    tokens_out = (stats.get("decode_tokens", 0)
                  + stats.get("spec_tokens", 0) + delivered)
    metrics = {
        "n_requests": n,
        "n_delivered": delivered,
        "n_shed": stats.get("shed", 0),
        "n_rejected": stats.get("rejected", 0),
        "n_timed_out": stats.get("timed_out", 0),
        "n_failed": stats.get("failed", 0),
        "shed_rate": _round(stats.get("shed", 0) / max(n, 1)),
        "degrade_rate": _round(
            stats.get("degraded_admissions", 0) / max(n, 1)
        ),
        "ttft_us_p50": _round(np.percentile(ttfts, 50)) if ttfts else None,
        "ttft_us_p99": _round(np.percentile(ttfts, 99)) if ttfts else None,
        "tok_us_p50": _round(np.percentile(per_tok, 50)) if per_tok else None,
        "tok_us_p99": _round(np.percentile(per_tok, 99)) if per_tok else None,
        "slo_ok_rate": _round(n_slo_ok / max(n, 1)),
        "goodput_tok_per_s": _round(slo_ok_tokens / max(duration_s, 1e-9)),
        "duration_virtual_s": _round(duration_s),
        "dispatches": dispatches,
        "prefill_dispatches": stats.get("prefill_dispatches", 0),
        "preemptions": stats.get("preemptions", 0),
        "dispatches_per_token": _round(dispatches / max(tokens_out, 1)),
    }
    return LoadReport(trace=trace.name, policy=policy_label,
                      metrics=metrics, outcomes=outcomes)
