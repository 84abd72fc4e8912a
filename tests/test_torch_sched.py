"""The port's SLO scheduler, resilience boundary, fault injection and load
harness against the JAX package's, on the same weights.

The reduced smollm-135m (float32, greedy) on 2 slots, n_max 64, decode
blocks of 4.  Two kinds of checks:

* parity with the JAX engine: ``run_trace(...).to_json()`` is
  byte-identical for the FIFO and SLO policies on a Poisson and a bursty
  trace (virtual time is priced from the engine's counters, so this holds
  when the counters and the schedule agree), and seeded random fault plans
  give the JAX engine's terminal statuses, tokens and ``stats()`` counters;
* the single-device cases of tests/test_resilience.py and
  tests/test_load.py on the port alone: typed rejections, shedding,
  degradation, deadlines and TTLs, NaN/Inf isolation, dispatch retry and
  exhaustion, prefill stalls, the standard fault trace, the priority
  head-of-line fix, preemption with state handoff, ``max_preemptions``,
  the interleave ratio and fat chunks.  Every OK output is token-identical
  to a fault-free (or solo) run.
"""

import dataclasses
import itertools

import jax
import numpy as np
import pytest

import repro.serve as J
import repro_torch.serve as T
from repro.configs import get_reduced as j_get_reduced
from repro.models.lm import lm_init as j_lm_init
from repro_torch.configs import get_reduced
from repro_torch.core import TaylorConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (
    DispatchFailure,
    FaultPlan,
    PrefillStall,
    QueueOverflow,
    Request,
    RequestRejected,
    RequestResult,
    ResiliencePolicy,
    SchedulerPolicy,
    ServeEngine,
    SlotCorruption,
    Status,
    bursty_trace,
    corrupt_slot,
    init_slot_caches,
    poisson_trace,
    run_trace,
    slot_health,
    standard_trace,
)

SLO_KW = dict(priority_admission=True, decode_per_prefill=2, fat_chunk_depth=3,
              preemption=True)
POLICIES = {"fifo": {}, "slo": SLO_KW}
TRACE_KW = dict(prompt_len=(4, 20), new_tokens=(3, 10), priorities=(0, 5))
# Seeds and rates at which the SLO policy preempts on 2 slots (2 and 1 times).
TRACES = {
    "poisson": lambda m: m.poisson_trace(2, 10, 128, mean_interarrival_s=0.0004, **TRACE_KW),
    "bursty": lambda m: m.bursty_trace(0, 10, 128, calm_interarrival_s=0.0006,
                                       burst_interarrival_s=0.0001, **TRACE_KW),
}
ENGINE_KW = dict(max_slots=2, n_max=64, decode_block=4)
PORT_ONLY_STATS = {"prefill_seconds", "decode_seconds"}


@pytest.fixture(scope="module")
def served():
    """The JAX model, the port's on the same weights, 4 prompts and their
    fault-free port outputs (FIFO, whole-prompt admission)."""
    jcfg, cfg = j_get_reduced("smollm-135m"), get_reduced("smollm-135m")
    jp = j_lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=6).astype(np.int32) for _ in range(4)]
    eng = ServeEngine(tp, cfg, device="cpu", **ENGINE_KW)
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8)) for p in prompts]
    ref = eng.run()
    return jcfg, cfg, jp, tp, prompts, [ref[r] for r in rids]


def _make(pkg, served, **kw):
    """An engine of ``pkg`` (the JAX package ``J`` or the port ``T``) on the
    shared weights."""
    jcfg, cfg, jp, tp, _, _ = served
    if pkg is J:
        return J.ServeEngine(jp, jcfg, **{**ENGINE_KW, **kw})
    return T.ServeEngine(tp, cfg, device="cpu", **{**ENGINE_KW, **kw})


def _engine(served, **kw):
    return _make(T, served, **kw)


def _solo(served, tokens, budget, **kw):
    eng = _engine(served, **kw)
    rid = eng.submit(Request(tokens=np.asarray(tokens, np.int32), max_new_tokens=budget))
    return eng.run()[rid]


# ---------------------------------------------------------------------------
# Parity with the JAX engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", list(TRACES))
def test_traces_match_jax(kind):
    """Same seed: the JAX package's trace, item for item (tokens included),
    and well formed."""
    port, ref = TRACES[kind](T), TRACES[kind](J)
    assert (port.name, port.seed, len(port)) == (ref.name, ref.seed, len(ref))
    assert [dataclasses.astuple(a) for a in port.items] == \
        [dataclasses.astuple(b) for b in ref.items]
    times = [it.t for it in port.items]
    assert times == sorted(times) and times[0] >= 0.0
    for it in port.items:
        assert 4 <= len(it.tokens) <= 20 and 3 <= it.max_new_tokens <= 10
        assert it.priority in (0, 5)


@pytest.mark.parametrize("kind", list(TRACES))
@pytest.mark.parametrize("policy", list(POLICIES))
def test_run_trace_report_byte_identical_to_jax(served, policy, kind):
    """``LoadReport.to_json()`` of the port equals the JAX package's byte for
    byte; after every engine step no slot holds two requests and in-flight
    outputs only grow (accepted prefixes survive preemption)."""
    prefixes = {}

    def invariants(eng):
        rids = [s.rid for s in eng._slots if s.rid is not None]
        assert len(rids) == len(set(rids)), "slot double-assignment"
        for s in eng._slots:
            if s.rid is None or s.prefilling:
                continue
            prev = prefixes.get(s.rid, [])
            assert s.out[:len(prev)] == prev, "accepted prefix mutated"
            prefixes[s.rid] = list(s.out)

    reports = [
        pkg.run_trace(
            lambda clock, pkg=pkg: _make(pkg, served, prefill_chunk=8, clock=clock,
                                         sched=pkg.SchedulerPolicy(**POLICIES[policy])),
            TRACES[kind](pkg), policy, step_hook=invariants if pkg is T else None,
        )
        for pkg in (J, T)
    ]
    ref, port = reports
    assert port.to_json() == ref.to_json()
    assert len(port.outcomes) == 10
    if policy == "slo":
        assert port.metrics["preemptions"] >= 1


@pytest.mark.parametrize("seed", range(3))
def test_random_fault_plans_match_jax(served, seed):
    """Seeded random fault plans: every request terminal, OK outputs equal to
    the fault-free run, and the JAX engine's statuses, tokens, retries and
    counters."""
    _, _, _, _, prompts, ref = served
    runs = []
    for pkg in (J, T):
        plan = pkg.FaultPlan.random(seed, horizon=6, slots=2, flood_prompt_len=6,
                                    flood_max_new=3)
        eng = _make(pkg, served, policy=pkg.ResiliencePolicy(max_queue=6), fault_plan=plan)
        rids = [eng.submit(pkg.Request(tokens=p, max_new_tokens=8)) for p in prompts]
        runs.append((rids, eng.run(return_results=True), eng.stats()))
    (_, jres, jst), (rids, res, st) = runs
    assert st["queue_depth"] == 0 and st["slots_occupied"] == 0
    for r, full in zip(rids, ref):
        out = res[r]
        if out.status in (Status.OK, Status.DEGRADED):
            n = out.tokens.size if out.status is Status.DEGRADED else len(full)
            np.testing.assert_array_equal(out.tokens, full[:n])
    assert sorted(res) == sorted(jres)
    for r in res:
        assert res[r].status.value == jres[r].status.value, r
        np.testing.assert_array_equal(res[r].tokens, np.asarray(jres[r].tokens))
        assert (res[r].retries, res[r].preemptions) == (jres[r].retries, jres[r].preemptions)
    assert {k: v for k, v in st.items() if k not in PORT_ONLY_STATS} == jst


# ---------------------------------------------------------------------------
# Submit-time validation & admission control
# ---------------------------------------------------------------------------


def test_submit_typed_rejections(served):
    _, _, _, _, prompts, _ = served
    eng = _engine(served)
    cases = [
        (Request(tokens=[], max_new_tokens=4), "empty_prompt"),
        (Request(tokens=prompts[0], max_new_tokens=0), "bad_budget"),
        (Request(tokens=np.zeros(65, np.int32), max_new_tokens=1), "prompt_too_long"),
        (Request(tokens=prompts[0], max_new_tokens=64), "over_capacity"),
    ]
    rids = []
    for req, reason in cases:
        with pytest.raises(RequestRejected) as exc:
            eng.submit(req)
        assert exc.value.reason == reason and exc.value.rid is not None
        rids.append(exc.value.rid)
    assert eng.stats()["rejected"] == len(cases)
    results = eng.run(return_results=True)
    for rid in rids:
        assert results[rid].status is Status.REJECTED and results[rid].tokens.size == 0
    with pytest.raises(ValueError):  # RequestRejected is a ValueError
        eng.submit(Request(tokens=[], max_new_tokens=4))


@pytest.mark.parametrize("where,kw", [
    ("engine", dict(mesh=object())),
    ("engine", dict(rules=object())),
    ("engine", dict(state_dtype="int8")),
    ("engine", dict(kv_page_size=16)),
    ("engine", dict(sched=SchedulerPolicy(speculative_k=2))),
    ("request", dict(speculative_k=2)),
    ("request", dict(draft="ngram")),
    ("request", dict(extras={"image_embeds": np.zeros((1, 4, 8), np.float32)})),
], ids=["mesh", "rules", "state_dtype", "kv_page_size", "policy_speculative_k",
        "request_speculative_k", "draft", "extras"])
def test_unported_features_raise(served, where, kw):
    """Features of later slices raise, naming ROADMAP queue 1; none is
    silently ignored."""
    _, _, _, _, prompts, _ = served
    with pytest.raises(NotImplementedError, match="not yet ported.*ROADMAP queue 1"):
        if where == "engine":
            _engine(served, **kw)
        else:
            _engine(served).submit(Request(tokens=prompts[0], max_new_tokens=4, **kw))


def test_bounded_queue_sheds_with_queue_overflow(served):
    _, _, _, _, prompts, _ = served
    eng = _engine(served, policy=ResiliencePolicy(max_queue=3))
    kept = [eng.submit(Request(tokens=prompts[0], max_new_tokens=4)) for _ in range(3)]
    with pytest.raises(QueueOverflow) as exc:
        eng.submit(Request(tokens=prompts[0], max_new_tokens=4))
    assert exc.value.reason == "queue_full"
    st = eng.stats()
    assert st["shed"] == 1 and st["rejected"] == 1
    results = eng.run(return_results=True)
    assert all(results[r].status is Status.OK for r in kept)


def test_overload_degradation_clamps_budget(served):
    """DEGRADED outputs are the exact prefix of the unconstrained run."""
    _, _, _, _, prompts, ref = served
    eng = _engine(served, policy=ResiliencePolicy(degrade_queue_depth=2,
                                                  degraded_max_new_tokens=3))
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8)) for p in prompts]
    results = eng.run(return_results=True)
    for r, full in zip(rids[:2], ref[:2]):
        assert results[r].status is Status.OK
        np.testing.assert_array_equal(results[r].tokens, full)
    for r, full in zip(rids[2:], ref[2:]):
        assert results[r].status is Status.DEGRADED
        np.testing.assert_array_equal(results[r].tokens, full[:3])
    assert eng.stats()["degraded_admissions"] == 2


# ---------------------------------------------------------------------------
# Deadlines & queue TTL (a counting clock; enforced at block boundaries)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["deadline", "queue_ttl"])
def test_expiry(served, kind):
    """A deadline expiring mid-decode ends TIMED_OUT with the accepted prefix
    of the fault-free output; a request that waits out its queue TTL behind
    a busy slot expires without decoding, the running one untouched."""
    _, _, _, _, prompts, ref = served
    clock = itertools.count()  # one tick per engine clock read
    tick = lambda: float(next(clock))  # noqa: E731
    if kind == "deadline":
        eng = _engine(served, decode_block=2, clock=tick)
        rid = eng.submit(Request(tokens=prompts[0], max_new_tokens=8, deadline=3.5))
        res = eng.run(return_results=True)[rid]
        assert res.status is Status.TIMED_OUT and "deadline" in res.error
        assert 0 < res.tokens.size < 8
        np.testing.assert_array_equal(res.tokens, ref[0][:res.tokens.size])
    else:
        eng = _engine(served, max_slots=1, decode_block=2, clock=tick)
        busy = eng.submit(Request(tokens=prompts[0], max_new_tokens=8))
        wait = eng.submit(Request(tokens=prompts[1], max_new_tokens=8, queue_ttl=2.0))
        results = eng.run(return_results=True)
        assert results[wait].status is Status.TIMED_OUT and results[wait].tokens.size == 0
        assert results[busy].status is Status.OK
        np.testing.assert_array_equal(results[busy].tokens, ref[0])


# ---------------------------------------------------------------------------
# Fault injection: corruption quarantine, dispatch retry, prefill stall
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("slot,mode", [(0, "nan"), (1, "inf")])
def test_corruption_isolated_and_recovered(served, slot, mode):
    """Poison in one slot's state: the co-batched slot is untouched, and the
    quarantined request recovers (re-prefill from prompt + accepted tokens)
    token-identically."""
    _, _, _, _, prompts, ref = served
    plan = FaultPlan(events=(SlotCorruption(at_block=1, slot=slot, mode=mode),))
    eng = _engine(served, fault_plan=plan)
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8)) for p in prompts[:2]]
    results = eng.run(return_results=True)
    for r, full in zip(rids, ref[:2]):
        assert results[r].status is Status.OK
        np.testing.assert_array_equal(results[r].tokens, full)
    st = eng.stats()
    assert st["corruptions_injected"] == 1 and st["quarantined"] == 1
    assert [results[r].retries for r in rids] == [int(i == slot) for i in range(2)]


def test_dispatch_failure_retried_in_place(served):
    _, _, _, _, prompts, ref = served
    eng = _engine(served, fault_plan=FaultPlan(events=(DispatchFailure(at_block=1),)))
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8)) for p in prompts[:2]]
    results = eng.run(return_results=True)
    for r, full in zip(rids, ref[:2]):
        assert results[r].status is Status.OK
        np.testing.assert_array_equal(results[r].tokens, full)
    st = eng.stats()
    assert st["dispatch_failures"] == 1 and st["dispatch_retries"] == 1
    assert st.get("cache_rebuilds", 0) == 0 and st.get("quarantined", 0) == 0


def test_dispatch_retries_exhausted_rebuilds_then_fails(served):
    _, _, _, _, prompts, _ = served
    eng = _engine(served, fault_plan=FaultPlan(events=(DispatchFailure(at_block=1, count=100),)),
                  policy=ResiliencePolicy(max_dispatch_retries=1, max_retries=1,
                                          retry_backoff_blocks=1))
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8)) for p in prompts[:2]]
    results = eng.run(return_results=True)
    for r in rids:
        assert results[r].status is Status.FAILED and "dispatch" in results[r].error
    st = eng.stats()
    assert st["cache_rebuilds"] >= 1 and st["failed"] == 2


def test_prefill_stall_delays_but_preserves_output(served):
    _, cfg, _, _, prompts, _ = served
    p_long = np.random.default_rng(3).integers(0, cfg.vocab, size=24).astype(np.int32)
    outs = []
    for plan in (None, FaultPlan(events=(PrefillStall(at_block=1, steps=2),))):
        eng = _engine(served, prefill_chunk=8, decode_block=2, fault_plan=plan)
        r0 = eng.submit(Request(tokens=prompts[0], max_new_tokens=8))
        eng.step()
        r1 = eng.submit(Request(tokens=p_long, max_new_tokens=6))
        res = eng.run()
        outs.append((res[r0], res[r1], eng.stats()))
    (a0, a1, _), (b0, b1, st) = outs
    np.testing.assert_array_equal(b0, a0)
    np.testing.assert_array_equal(b1, a1)
    assert st["prefill_stalls"] >= 1


def test_standard_trace_acceptance(served):
    """Flood + 1 dispatch failure + 1 NaN corruption: every request terminal,
    every OK output token-identical to the fault-free run."""
    _, _, _, _, prompts, ref = served
    eng = _engine(served, fault_plan=standard_trace(slot=0),
                  policy=ResiliencePolicy(max_queue=4))
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8)) for p in prompts]
    results = eng.run(return_results=True)
    assert all(isinstance(r, RequestResult) for r in results.values())
    for r, full in zip(rids, ref):
        assert results[r].status in (Status.OK, Status.DEGRADED)
        np.testing.assert_array_equal(results[r].tokens, full)
    st = eng.stats()
    assert st["corruptions_injected"] == 1 and st["dispatch_failures"] == 1
    assert st["quarantined"] == 1 and st["shed"] >= 1
    assert sum(st.get(k, 0) for k in ("ok", "rejected", "failed", "timed_out",
                                      "degraded")) == len(results)


@pytest.mark.parametrize("case", ["taylor", "softmax", "softmax_window", "sym_state", "hybrid"])
def test_slot_health_flags_only_corrupted_slot(case):
    """``corrupt_slot`` + ``slot_health``: exactly the poisoned slot is
    flagged, for full and packed moments, KV caches and rings, and a cache
    of two state types; int leaves and the input cache stay as they were."""
    kw = {"taylor": {}, "softmax": dict(attention="softmax"),
          "softmax_window": dict(attention="softmax_window", attn_window=8),
          "sym_state": dict(taylor=TaylorConfig(sym_state=True)),
          "hybrid": dict(pattern=("attn", "attn", "attn"), n_groups=2,
                         attention_schedule={1: "softmax_window"}, attn_window=8)}[case]
    cfg = get_reduced("smollm-135m", **kw)
    caches = init_slot_caches(cfg, 4, 32, device="cpu")
    assert slot_health(caches, cfg).tolist() == [True] * 4
    bad = corrupt_slot(caches, 2, float("nan"))
    assert slot_health(bad, cfg).tolist() == [True, True, False, True]
    assert slot_health(caches, cfg).tolist() == [True] * 4
    for state in bad["group"]:
        for leaf in state:
            if leaf is not None and not leaf.is_floating_point():
                assert not leaf.any()


# ---------------------------------------------------------------------------
# Scheduling behaviour under load (virtual clock)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("policy", list(POLICIES))
def test_ok_outputs_token_identical_to_solo(served, policy):
    """Continuous batching, priority admission, interleave throttling and
    preemption change WHEN tokens come, never WHICH."""
    _, cfg, _, _, _, _ = served
    trace = poisson_trace(11, 6, cfg.vocab, mean_interarrival_s=0.0004, **TRACE_KW)
    eng = _engine(served, prefill_chunk=8, sched=SchedulerPolicy(**POLICIES[policy]))
    rids = [eng.submit(it.request()) for it in trace.items]
    results = eng.run(return_results=True)
    for rid, item in zip(rids, trace.items):
        assert results[rid].status is Status.OK
        np.testing.assert_array_equal(results[rid].tokens,
                                      _solo(served, item.tokens, item.max_new_tokens))


def test_exactly_one_terminal_result_with_shedding(served):
    _, cfg, _, _, _, _ = served
    trace = bursty_trace(5, 14, cfg.vocab, queue_ttl=0.003, calm_interarrival_s=0.0001,
                         burst_interarrival_s=0.00002, prompt_len=(4, 20),
                         new_tokens=(3, 10))
    report = run_trace(
        lambda clock: _engine(served, prefill_chunk=8, clock=clock,
                              sched=SchedulerPolicy(**SLO_KW),
                              policy=ResiliencePolicy(max_queue=3)),
        trace, "slo")
    assert len(report.outcomes) == len(trace)
    statuses = [o["status"] for o in report.outcomes]
    assert report.metrics["n_shed"] > 0
    assert statuses.count("rejected") == report.metrics["n_shed"]
    assert report.metrics["shed_rate"] == pytest.approx(report.metrics["n_shed"] / len(trace),
                                                        abs=1e-3)


def test_poll_drains_each_result_once(served):
    eng = _engine(served)
    rid = eng.submit(Request(tokens=np.arange(1, 7, dtype=np.int32), max_new_tokens=4))
    seen = []
    while eng.step():
        seen += list(eng.poll())
    seen += list(eng.poll())
    assert seen == [rid] and eng.poll() == {}


def test_deadline_and_ttl_monotone_under_virtual_clock(served):
    """submitted <= first token <= finished; TIMED_OUT never before its
    budget."""
    _, cfg, _, _, _, _ = served
    trace = poisson_trace(2, 10, cfg.vocab, deadline=0.0015, queue_ttl=0.001,
                          mean_interarrival_s=0.0002, prompt_len=(4, 20), new_tokens=(3, 10))
    report = run_trace(lambda clock: _engine(served, prefill_chunk=8, clock=clock),
                       trace, "fifo")
    by_rid = {o["rid"]: o for o in report.outcomes}
    assert any(o["status"] == "timed_out" for o in by_rid.values())
    for rid, item in zip(sorted(by_rid), trace.items):
        o = by_rid[rid]
        sub_us = item.t * 1e6
        assert o["finished_at_us"] >= sub_us - 1e-6
        if o["ttft_us"] is not None:
            assert o["ttft_us"] >= 0.0
            assert o["finished_at_us"] >= sub_us + o["ttft_us"] - 1e-3
        if o["status"] == "timed_out":
            assert o["finished_at_us"] >= sub_us + 0.001 * 1e6 - 1e-3


def test_priority_admission_fixes_head_of_line_starvation(served):
    """A short urgent request behind a long chunked prefill waits for it
    under FIFO and is admitted first under ``priority_admission``; the
    tokens are the same under both."""
    _, cfg, _, _, _, _ = served
    rng = np.random.default_rng(0)
    long_p = rng.integers(0, cfg.vocab, size=40).astype(np.int32)
    short_p = rng.integers(0, cfg.vocab, size=6).astype(np.int32)
    runs = []
    for sched in (SchedulerPolicy(), SchedulerPolicy(priority_admission=True)):
        eng = _engine(served, prefill_chunk=8, sched=sched)
        a = eng.submit(Request(tokens=long_p, max_new_tokens=12, priority=5))
        b = eng.submit(Request(tokens=short_p, max_new_tokens=6, priority=0))
        res = eng.run(return_results=True)
        runs.append((res[a], res[b]))
    (f_long, f_short), (p_long, p_short) = runs
    np.testing.assert_array_equal(f_long.tokens, p_long.tokens)
    np.testing.assert_array_equal(f_short.tokens, p_short.tokens)
    assert f_short.first_token_at > f_long.first_token_at
    assert p_short.first_token_at < p_long.first_token_at


def test_preemption_state_handoff_token_identity(served):
    """The low-priority request is evicted mid-decode, resumes from its
    saved state without re-prefill, and both outputs equal solo runs."""
    _, cfg, _, _, _, _ = served
    rng = np.random.default_rng(1)
    lo_p = rng.integers(0, cfg.vocab, size=6).astype(np.int32)
    hi_p = rng.integers(0, cfg.vocab, size=8).astype(np.int32)
    eng = _engine(served, max_slots=1, sched=SchedulerPolicy(preemption=True))
    lo = eng.submit(Request(tokens=lo_p, max_new_tokens=10, priority=5))
    for _ in range(2):
        eng.step()
    prefix = list(eng._slots[0].out)
    assert prefix
    prefills = eng.stats()["prefill_dispatches"]
    hi = eng.submit(Request(tokens=hi_p, max_new_tokens=6, priority=0))
    res = eng.run(return_results=True)
    st = eng.stats()
    assert st["preemptions"] >= 1 and st["resumes"] == st["preemptions"]
    assert st["prefill_dispatches"] == prefills + 1  # hi's prefill; lo resumes without one
    assert res[lo].preemptions >= 1
    assert res[lo].status is Status.OK and res[hi].status is Status.OK
    assert list(res[lo].tokens[:len(prefix)]) == prefix
    for rid, toks, budget in ((lo, lo_p, 10), (hi, hi_p, 6)):
        np.testing.assert_array_equal(res[rid].tokens, _solo(served, toks, budget, max_slots=1))


def test_max_preemptions_bounds_thrash(served):
    _, cfg, _, _, _, _ = served
    rng = np.random.default_rng(2)
    lo_p = rng.integers(0, cfg.vocab, size=6).astype(np.int32)
    eng = _engine(served, max_slots=1,
                  sched=SchedulerPolicy(preemption=True, max_preemptions=1))
    lo = eng.submit(Request(tokens=lo_p, max_new_tokens=12, priority=9))
    for _ in range(2):
        eng.step()
    for _ in range(3):
        eng.submit(Request(tokens=rng.integers(0, cfg.vocab, size=4).astype(np.int32),
                           max_new_tokens=3, priority=0))
        eng.step()
    res = eng.run(return_results=True)
    assert res[lo].status is Status.OK and res[lo].preemptions <= 1
    assert eng.stats()["preemptions"] <= 1


def test_decode_per_prefill_throttles_chunk_feed(served):
    """With ``decode_per_prefill=3`` and a decoding slot, the chunks of an
    in-flight long prefill come >= 3 blocks apart (1 under the default)."""
    _, cfg, _, _, _, _ = served
    rng = np.random.default_rng(3)
    busy_p = rng.integers(0, cfg.vocab, size=4).astype(np.int32)
    long_p = rng.integers(0, cfg.vocab, size=24).astype(np.int32)

    def chunk_blocks(sched):
        eng = _engine(served, prefill_chunk=8, sched=sched)
        eng.submit(Request(tokens=busy_p, max_new_tokens=30))
        eng.step()
        eng.submit(Request(tokens=long_p, max_new_tokens=4))
        blocks, last = [], eng.stats()["prefill_dispatches"]
        while eng.step():
            n = eng.stats()["prefill_dispatches"]
            if n > last:
                blocks.append(eng.stats()["blocks"])
            last = n
        return blocks

    strict = chunk_blocks(SchedulerPolicy())
    spaced = chunk_blocks(SchedulerPolicy(decode_per_prefill=3))
    assert strict and spaced
    assert min(np.diff(strict), default=1) == 1
    assert all(g >= 3 for g in np.diff(spaced))


def test_fat_chunks_cut_prefill_dispatches(served):
    """A deep queue fattens chunks: fewer prefill calls, identical tokens."""
    _, cfg, _, _, _, _ = served
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, size=33).astype(np.int32) for _ in range(4)]
    runs = []
    for sched in (SchedulerPolicy(), SchedulerPolicy(fat_chunk_depth=2)):
        eng = _engine(served, prefill_chunk=8, sched=sched)
        rids = [eng.submit(Request(tokens=p, max_new_tokens=3)) for p in prompts]
        res = eng.run()
        runs.append((eng.stats()["prefill_dispatches"], [res[r] for r in rids]))
    (n_fixed, fixed), (n_fat, fat) = runs
    assert n_fat < n_fixed
    for a, b in zip(fixed, fat):
        np.testing.assert_array_equal(a, b)
