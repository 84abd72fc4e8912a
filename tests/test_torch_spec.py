"""The port's speculative decoding against the JAX package's.

``lm_verify_chunk``, the proposers and their registry, and
``SchedulerPolicy(speculative_k=...)`` / ``Request(speculative_k=...,
draft=...)`` on the reduced smollm-135m (float32, greedy), with the JAX
package's weights (``params_from_jax``):

* ``lm_verify_chunk`` logits and caches equal JAX's to a relative 1e-5,
  with a scalar and a ``[b]`` ``pos0``, and its state and last logits equal
  the port's own ``lm_prefill_chunk``;
* the single-device cases of tests/test_speculative.py on the port:
  ``_ngram_continuation``, the registry, typed rejections and construction
  errors (JAX's reasons and messages), and tokens identical to plain decode
  for both drafts (seeds 0 and 1), co-batched with plain slots, with
  mid-flight admission, with preemption inside a draft window and with
  quarantine of a speculating slot;
* parity with the JAX engine: every ``spec_*``/``verify_*``/``draft_*``
  counter on ``benchmarks/bench_speculative.py``'s workload, and
  ``run_trace(...).to_json()`` byte for byte, with ``speculative_k=4``;
* speculation over an int8 store: the JAX engine's tokens; against int8
  plain decode (whose state is re-quantised at other points) a request may
  only diverge where the float32 top-2 margin is below the int8 flip
  margin of tests/test_state_quant.py.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J
import repro_torch.serve as T
from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.serve import slots as jslots
from repro_torch.backends import resolve_backend
from repro_torch.configs import get_reduced
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (
    CostModel,
    FaultPlan,
    Request,
    RequestRejected,
    SchedulerPolicy,
    ServeEngine,
    SlotCorruption,
    Status,
    draft_available,
    has_proposer,
    poisson_trace,
    proposer_names,
    run_trace,
)
from repro_torch.serve import slots as tslots
from repro_torch.serve.speculative import _ngram_continuation
from repro_torch.tree import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_TOL = 1e-5
DRAFTS = ("ngram", "order1")
ENGINE_KW = dict(max_slots=2, n_max=64, decode_block=4)
INT8_MARGIN = 0.2  # tests/test_state_quant.py: no int8 flip above this fp32 margin
PORT_ONLY_STATS = ("prefill_seconds", "decode_seconds", "verify_seconds", "draft_seconds")


@functools.lru_cache(maxsize=None)
def _model(order=2):
    """(JAX cfg, port cfg, JAX params, port params) of the reduced
    smollm-135m at Taylor ``order``."""
    jcfg, cfg = j_get_reduced("smollm-135m"), get_reduced("smollm-135m")
    if order != 2:
        jcfg = jcfg.replace(taylor=dataclasses.replace(jcfg.taylor, order=order))
        cfg = cfg.replace(taylor=dataclasses.replace(cfg.taylor, order=order))
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _engine(**kw):
    _, cfg, _, tp = _model()
    return ServeEngine(tp, cfg, device="cpu", **{**ENGINE_KW, **kw})


def _requests(seed, n=6, prompt=(3, 12), new=(8, 24), pkg=T):
    """tests/test_speculative.py's seeded greedy requests."""
    rng = np.random.default_rng(seed)
    vocab = _model()[1].vocab
    return [pkg.Request(tokens=rng.integers(1, vocab, size=int(rng.integers(*prompt))).tolist(),
                        max_new_tokens=int(rng.integers(*new)))
            for _ in range(n)]


def _run_all(eng, reqs):
    rids = [eng.submit(r) for r in reqs]
    res = eng.run(return_results=True)
    return [res[r] for r in rids]


@functools.lru_cache(maxsize=None)
def _solo_cached(tokens, budget):
    eng = _engine()
    rid = eng.submit(Request(tokens=list(tokens), max_new_tokens=budget))
    return eng.run()[rid]


def _solo(req):
    """The request decoded alone on a fresh plain engine."""
    return _solo_cached(tuple(req.tokens), req.max_new_tokens)


def rel(port, ref) -> float:
    port, ref = port.numpy(), np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def _state_pairs(tc, jc):
    for ts, js in zip(tc["group"] + tc["tail"], jc["group"] + jc["tail"]):
        for name, a, b in zip(ts._fields, ts, js):
            if b is not None:
                yield name, a, b


# ---------------------------------------------------------------------------
# lm_verify_chunk
# ---------------------------------------------------------------------------


def _two_slot_caches(lens, seed=0):
    """Each package's 2-slot cache after prefilling prompts of ``lens``
    tokens alone into slots 0 and 1, and the prompts."""
    jcfg, cfg, jp, tp = _model()
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (1, n)).astype(np.int32) for n in lens]
    jc = jslots.init_slot_caches(jcfg, 2, 32, jnp.float32)
    tc = tslots.init_slot_caches(cfg, 2, 32, "cpu")
    for j, p in enumerate(prompts):
        _, c = jlm.lm_prefill(jp, {"tokens": jnp.asarray(p)}, jcfg, 32)
        jc = jslots.write_slot(jc, c, jnp.asarray(j, jnp.int32))
        _, c = tlm.lm_prefill(tp, {"tokens": torch.from_numpy(p.astype(np.int64))}, cfg, 32)
        tc = tslots.write_slot(tc, c, j)
    return jc, tc


@pytest.mark.parametrize("pos0", [(9, 9), (5, 11)])
def test_verify_chunk_matches_jax(pos0):
    """Every window position's logits and every cache leaf within a relative
    1e-5 of JAX's (float32, sums in another order), with a scalar ``pos0``
    when both slots sit at the same position and a ``[b]`` one when they do
    not; the state equals the port's ``lm_prefill_chunk`` bit for bit (the
    same chunk maths) and so do the last logits to a relative 1e-6 (the
    head's matmul over one position or five blocks its sums otherwise)."""
    jcfg, cfg, jp, tp = _model()
    jc, tc = _two_slot_caches(pos0)
    window = np.random.default_rng(1).integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    p = pos0[0] if pos0[0] == pos0[1] else np.asarray(pos0, np.int32)
    jl, jn = jlm.lm_verify_chunk(jp, jnp.asarray(window), jc, jnp.asarray(p), jcfg)
    tw = torch.from_numpy(window.astype(np.int64))
    tpos = p if np.isscalar(p) else torch.from_numpy(p)
    tl, tn = tlm.lm_verify_chunk(tp, tw, tc, tpos, cfg)
    assert tuple(tl.shape) == (2, 5, cfg.vocab)
    assert rel(tl, jl) <= JAX_TOL
    for name, a, b in _state_pairs(tn, jn):
        assert rel(a, b) <= JAX_TOL, name
    pl, pn = tlm.lm_prefill_chunk(tp, tw, tc, tpos, cfg)
    assert rel(pl, tl[:, -1].numpy()) <= 1e-6
    for x, y in zip(tree_leaves(pn), tree_leaves(tn)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Proposers, registry, validation
# ---------------------------------------------------------------------------


def test_ngram_continuation_lookup():
    """The longest recurring suffix gram's continuation, padded with its
    last token; else the last token repeated."""
    assert _ngram_continuation([1, 4, 5, 6, 7, 8, 9, 4, 5, 6], 3) == [7, 8, 9]
    assert _ngram_continuation([5, 1, 2, 1, 2], 3) == [1, 2, 2]
    assert _ngram_continuation([1, 2, 3], 4) == [3, 3, 3, 3]
    assert _ngram_continuation([9, 1, 2, 9], 2) == [1, 2]
    rng = np.random.default_rng(0)
    from repro.serve.speculative import _ngram_continuation as j_ngram

    for _ in range(200):
        ctx = rng.integers(0, 5, int(rng.integers(1, 30))).tolist()
        k = int(rng.integers(1, 6))
        assert _ngram_continuation(ctx, k) == j_ngram(ctx, k)


def test_registry_surface():
    """Both proposers are registered; availability follows the backend's
    draft hierarchy (an order-1 target has no cheaper draft, a KV backend
    none at all, a hybrid schedule none)."""
    _, cfg, _, _ = _model()
    assert proposer_names() == J.proposer_names() == ("ngram", "order1")
    assert has_proposer("ngram") and not has_proposer("nope")
    assert draft_available(cfg, "ngram") and draft_available(cfg, "order1")
    o1 = _model(1)[1]
    assert draft_available(o1, "ngram") and not draft_available(o1, "order1")
    assert not draft_available(cfg, "nope")
    assert not draft_available(cfg.replace(attention="softmax"), "order1")
    hybrid = cfg.replace(pattern=("attn", "attn"), n_groups=1,
                         attention_schedule={1: "softmax"})
    assert not draft_available(hybrid, "order1")
    dcfg = resolve_backend(cfg).draft_config(cfg)
    assert dcfg.taylor.order == 1 and dcfg.attn_impl == "torch"


REJECTIONS = [
    (dict(max_new_tokens=8, speculative_k=0), "bad_speculative_k"),
    (dict(max_new_tokens=8, speculative_k=-3), "bad_speculative_k"),
    (dict(max_new_tokens=4, speculative_k=5), "bad_speculative_k"),
    (dict(max_new_tokens=8, draft="nope"), "unknown_draft"),
]


@pytest.mark.parametrize("kw,reason", REJECTIONS)
def test_submit_rejects_bad_speculative_knobs(kw, reason):
    """Typed rejections with JAX's reasons and messages, recorded as
    terminal REJECTED results."""
    jcfg, _, jp, _ = _model()
    eng, jeng = _engine(), J.ServeEngine(jp, jcfg, **ENGINE_KW)
    with pytest.raises(RequestRejected) as got:
        eng.submit(Request(tokens=[1, 2, 3], **kw))
    with pytest.raises(J.RequestRejected) as want:
        jeng.submit(J.Request(tokens=[1, 2, 3], **kw))
    assert got.value.reason == want.value.reason == reason
    assert str(got.value) == str(want.value)
    assert eng.poll()[got.value.rid].status is Status.REJECTED


def test_submit_rejects_unavailable_draft():
    jcfg, cfg, jp, tp = _model(1)
    eng = ServeEngine(tp, cfg, device="cpu", **ENGINE_KW)
    jeng = J.ServeEngine(jp, jcfg, **ENGINE_KW)
    kw = dict(tokens=[1, 2, 3], max_new_tokens=8, speculative_k=2, draft="order1")
    with pytest.raises(RequestRejected) as got:
        eng.submit(Request(**kw))
    with pytest.raises(J.RequestRejected) as want:
        jeng.submit(J.Request(**kw))
    assert got.value.reason == "draft_unavailable" and str(got.value) == str(want.value)


@pytest.mark.parametrize("order,kw", [
    (2, dict(speculative_k=-1)),
    (2, dict(speculative_k=4, speculative_draft="nope")),
    (1, dict(speculative_k=4, speculative_draft="order1")),
])
def test_bad_policy_rejected_at_construction(order, kw):
    """Engine-wide knobs are validated when the engine is built, with the
    JAX engine's messages."""
    jcfg, cfg, jp, tp = _model(order)
    with pytest.raises(ValueError) as got:
        ServeEngine(tp, cfg, device="cpu", sched=SchedulerPolicy(**kw), **ENGINE_KW)
    with pytest.raises(ValueError) as want:
        J.ServeEngine(jp, jcfg, sched=J.SchedulerPolicy(**kw), **ENGINE_KW)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Token identity
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_speculative_token_identical_to_plain(draft, seed):
    """Greedy output under draft/verify equals plain decode for every
    request, speculation ran, and every emitted token is counted once."""
    reqs = _requests(seed)
    eng = _engine(sched=SchedulerPolicy(speculative_k=4, speculative_draft=draft))
    results = _run_all(eng, reqs)
    for req, r in zip(reqs, results):
        assert r.status is Status.OK
        np.testing.assert_array_equal(r.tokens, _solo(req))
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["spec_accepted"] > 0 and st["spec_tokens"] > 0
    total = sum(len(r.tokens) for r in results)
    assert st["decode_tokens"] + st["spec_tokens"] + len(reqs) == total
    assert st["verify_dispatches"] == st["spec_rounds"]
    assert 0 < st["spec_accepted"] <= st["spec_drafted"]
    assert st["spec_full_accepts"] * 4 <= st["spec_accepted"]
    assert (st.get("draft_dispatches", 0) > 0) == (draft == "order1")


@pytest.mark.parametrize("draft", DRAFTS)
def test_mixed_spec_and_plain_slots_cobatch(draft):
    """Per-request overrides co-batch speculating and plain slots: every
    output equals its solo run, and both kinds ran."""
    reqs = _requests(2)
    for j, r in enumerate(reqs):
        if j % 2 == 1:
            reqs[j] = dataclasses.replace(r, speculative_k=3, draft=draft)
    eng = _engine()
    for req, r in zip(reqs, _run_all(eng, reqs)):
        assert r.status is Status.OK
        np.testing.assert_array_equal(r.tokens, _solo(req))
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["decode_dispatches"] > 0


@pytest.mark.parametrize("draft", DRAFTS)
def test_mid_flight_admission_token_identity(draft):
    """Requests admitted while other slots are mid-speculation match solo
    decode (admission primes the draft state)."""
    reqs = _requests(3, n=4, new=(12, 20))
    eng = _engine(sched=SchedulerPolicy(speculative_k=4, speculative_draft=draft))
    rids = [eng.submit(reqs[0]), eng.submit(reqs[1])]
    for _ in range(3):
        eng.step()
    rids += [eng.submit(reqs[2]), eng.submit(reqs[3])]
    while eng.step():
        pass
    res = eng.poll()
    for req, rid in zip(reqs, rids):
        assert res[rid].status is Status.OK
        np.testing.assert_array_equal(res[rid].tokens, _solo(req))


@pytest.mark.parametrize("draft", DRAFTS)
def test_preemption_during_draft_window_token_identity(draft):
    """A speculating slot evicted between verify rounds resumes from its
    snapshot (draft state primed again, no re-prefill) token-identically."""
    rng = np.random.default_rng(3)
    vocab = _model()[1].vocab
    lo_req = Request(tokens=rng.integers(1, vocab, size=6).tolist(), max_new_tokens=16,
                     priority=5)
    hi_req = Request(tokens=rng.integers(1, vocab, size=8).tolist(), max_new_tokens=6,
                     priority=0)
    eng = _engine(max_slots=1, sched=SchedulerPolicy(preemption=True, speculative_k=4,
                                                     speculative_draft=draft))
    lo = eng.submit(lo_req)
    for _ in range(2):
        eng.step()
    prefix = list(eng._slots[0].out)
    assert len(prefix) > 1, "the low-priority slot never speculated"
    hi = eng.submit(hi_req)
    res = eng.run(return_results=True)
    st = eng.stats()
    assert st["preemptions"] >= 1 and st["resumes"] >= 1 and st["spec_rounds"] > 0
    assert list(res[lo].tokens[:len(prefix)]) == prefix
    np.testing.assert_array_equal(res[lo].tokens, _solo(lo_req))
    np.testing.assert_array_equal(res[hi].tokens, _solo(hi_req))


@pytest.mark.parametrize("draft", DRAFTS)
def test_quarantine_of_speculating_slot_recovers(draft):
    """NaN injected into a speculating slot: quarantined, re-prefilled, its
    draft state primed again, and the output still equals the solo run."""
    reqs = _requests(4, n=2, new=(10, 16))
    plan = FaultPlan(events=(SlotCorruption(at_block=1, slot=0, mode="nan"),))
    eng = _engine(fault_plan=plan, sched=SchedulerPolicy(speculative_k=4,
                                                         speculative_draft=draft))
    for req, r in zip(reqs, _run_all(eng, reqs)):
        assert r.status is Status.OK
        np.testing.assert_array_equal(r.tokens, _solo(req))
    st = eng.stats()
    assert st["quarantined"] == 1 and st["retries"] >= 1 and st["spec_rounds"] > 0


# ---------------------------------------------------------------------------
# Parity with the JAX engine
# ---------------------------------------------------------------------------


def _bench_workload(pkg, seed=7, n=4):
    """benchmarks/bench_speculative.py's ``_workload``."""
    rng = np.random.default_rng(seed)
    vocab = _model()[1].vocab
    return [pkg.Request(tokens=rng.integers(1, vocab, size=int(rng.integers(3, 12))).tolist(),
                        max_new_tokens=int(rng.integers(24, 33)))
            for _ in range(n)]


def _bench_replay(pkg, sched):
    jcfg, cfg, jp, tp = _model()
    kw = dict(max_slots=2, n_max=64, decode_block=1, sched=sched)
    eng = (J.ServeEngine(jp, jcfg, **kw) if pkg is J
           else ServeEngine(tp, cfg, device="cpu", **kw))
    rids = [eng.submit(r) for r in _bench_workload(pkg)]
    res = eng.run()
    return [list(res[r]) for r in rids], eng.stats()


@pytest.mark.parametrize("draft", DRAFTS)
def test_counters_match_jax_on_bench_workload(draft):
    """On bench_speculative.py's workload (decode_block=1) the port emits the
    JAX engine's tokens (and the plain run's), every counter equals JAX's,
    and speculation takes fewer dispatches per token than plain decode."""
    plain_toks, plain_st = _bench_replay(T, SchedulerPolicy())
    toks, st = _bench_replay(T, SchedulerPolicy(speculative_k=4, speculative_draft=draft))
    jtoks, jst = _bench_replay(J, J.SchedulerPolicy(speculative_k=4, speculative_draft=draft))
    assert toks == jtoks == plain_toks
    ours = {k: v for k, v in st.items() if k not in PORT_ONLY_STATS}
    assert ours == dict(jst)
    assert any(k.startswith("spec_") for k in ours) and "verify_tokens" in ours
    n_tok = sum(len(t) for t in toks)
    assert st["dispatches"] / n_tok < min(1.0, plain_st["dispatches"] / n_tok)
    assert CostModel().step_cost_us({}, st) == J.CostModel().step_cost_us({}, jst)


@pytest.mark.parametrize("draft", DRAFTS)
def test_run_trace_report_byte_identical_to_jax(draft):
    """``LoadReport.to_json()`` with ``speculative_k=4`` equals the JAX
    package's byte for byte (its virtual time is priced from the verify and
    draft counters)."""
    jcfg, cfg, jp, tp = _model()
    kw = dict(priorities=(0, 5), prompt_len=(4, 20), new_tokens=(8, 16))
    trace, jtrace = (m.poisson_trace(2, 8, cfg.vocab, mean_interarrival_s=0.0004, **kw)
                     for m in (T, J))

    def ours(clock):
        return ServeEngine(tp, cfg, device="cpu", clock=clock, sched=SchedulerPolicy(
            speculative_k=4, speculative_draft=draft), **ENGINE_KW)

    def theirs(clock):
        return J.ServeEngine(jp, jcfg, clock=clock, sched=J.SchedulerPolicy(
            speculative_k=4, speculative_draft=draft), **ENGINE_KW)

    report = run_trace(ours, trace, f"spec-{draft}")
    assert report.to_json() == J.run_trace(theirs, jtrace, f"spec-{draft}").to_json()
    assert report.metrics["n_delivered"] == len(trace)


# ---------------------------------------------------------------------------
# Speculation over a quantised store
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("seed", [0, 1])
def test_speculation_over_int8_store(draft, seed):
    """Speculation over int8 moments gives the JAX engine's tokens.  Against
    int8 plain decode, which re-quantises after each decode block rather
    than after each verify, a request may diverge only at a decision whose
    float32 top-2 margin (the dense model's, between the two tokens) is
    below the int8 flip margin; rollbacks restore snapshots exactly."""
    jcfg, cfg, jp, tp = _model()
    sched = dict(speculative_k=4, speculative_draft=draft)
    reqs, jreqs = _requests(seed), _requests(seed, pkg=J)
    plain = _run_all(_engine(state_dtype="int8"), reqs)
    eng = _engine(state_dtype="int8", sched=SchedulerPolicy(**sched))
    spec = _run_all(eng, reqs)
    jspec = _run_all(J.ServeEngine(jp, jcfg, state_dtype="int8",
                                   sched=J.SchedulerPolicy(**sched), **ENGINE_KW), jreqs)
    assert eng.stats()["spec_rounds"] > 0
    for req, p, s, j in zip(reqs, plain, spec, jspec):
        np.testing.assert_array_equal(s.tokens, np.asarray(j.tokens))
        diff = np.flatnonzero(p.tokens != s.tokens)
        if not len(diff):
            continue
        t = int(diff[0])
        seq = torch.as_tensor(list(req.tokens) + p.tokens[:t].tolist())[None]
        with torch.no_grad():
            lg = tlm.lm_apply(tp, {"tokens": seq}, cfg)[0][0, -1]
        assert abs(float(lg[int(p.tokens[t])] - lg[int(s.tokens[t])])) < INT8_MARGIN
