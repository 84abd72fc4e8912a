"""The port's slot-state representations against the JAX package's.

``backends/state.py``'s quantise/page primitives, ``serve/state_repr.py``'s
codecs, ``PageAllocator`` and ``SlotStateStore``, and the engine's
``state_dtype="int8"|"fp8"`` and ``kv_page_size=`` paths, on the reduced
smollm-135m (float32, greedy) and its hybrids, with the JAX package's
weights (``params_from_jax``):

* ``quantize_leaf`` payloads are bit-identical to JAX's for int8 and
  fp8, zero and non-finite leaves included, and so are the scales wherever
  XLA's ``exp2`` is exact; ``gather_pages`` /
  ``scatter_pages`` equal JAX's on random tables holding ``-1``;
  ``PageAllocator`` gives JAX's tables for one operation sequence;
* the slot-cache contract on every (backend, representation) the port
  advertises (the single-device cases of tests/test_state_conformance.py):
  write/read round trips, clear isolation, snapshot-restore token
  identity, health flags corruption; for the same dense caches the stored
  trees' leaves equal JAX's;
* engines: quantised and paged tokens equal the JAX engine's, paged tokens
  equal dense ones, no page leaks under load or quarantine (the cases of
  tests/test_paged_kv.py), ``slot_state_bytes``/``live_state_bytes``
  equal JAX's, and ``make_state_store`` raises JAX's errors.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as J
import repro_torch.serve as T
from repro.backends import state as jstate
from repro.configs import get_reduced as j_get_reduced
from repro.core import TaylorState as JTaylorState
from repro.models import lm as jlm
from repro.models.ssm import MambaCache as JMambaCache
from repro.serve import state_repr as jrepr
from repro_torch.backends import available_backends
from repro_torch.backends import state as tstate
from repro_torch.configs import get_reduced
from repro_torch.core import TaylorState
from repro_torch.launch.mesh import make_serve_mesh
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import (
    FaultPlan,
    PageAllocator,
    Request,
    SchedulerPolicy,
    ServeEngine,
    SlotCorruption,
    Status,
    bursty_trace,
    make_state_store,
    poisson_trace,
    run_trace,
    slot_bytes,
)
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


N_MAX = 32
SLOTS = 3
PAGE = 8
LENS = (7, 12, 9)  # per-slot prompt lengths, not multiples of the page
# read-after-write tolerance against the written state, as a fraction of
# each leaf's amax (tests/test_state_conformance.py's): int8 rounds to
# 1/128 steps of a power of two >= amax, fp8 e4m3 keeps a 3-bit mantissa
QTOL = {"int8": 0.02, "fp8": 0.1}
MIXED = dict(pattern=("attn", "attn"), n_groups=1, attention="taylor",
             attention_schedule={1: "softmax"})
ENGINE_KW = dict(max_slots=2, n_max=64, decode_block=4)


def _representations(backend):
    reps = list(backend.state_dtypes)
    if backend.supports_paged_kv:
        reps.append("paged")
    return reps


GRID = [(name, rep) for name, backend in sorted(available_backends().items())
        for rep in _representations(backend)]


def _store_kw(rep):
    if rep in ("int8", "fp8"):
        return dict(state_dtype=rep)
    if rep == "paged":
        return dict(kv_page_size=PAGE)
    if rep == "int8+paged":
        return dict(state_dtype="int8", kv_page_size=PAGE)
    return {}


@functools.lru_cache(maxsize=None)
def _model(key):
    """(JAX cfg, port cfg, JAX params, port params) of the reduced
    smollm-135m on one backend (or the taylor/softmax hybrid, ``"mixed"``);
    a block-level backend ("ssm") fuses the whole layer, so its model is
    the reduced mamba2-780m (the JAX package's conformance grid's choice)."""
    if key != "mixed" and available_backends()[key].level == "block":
        jcfg, cfg = j_get_reduced("mamba2-780m"), get_reduced("mamba2-780m")
    else:
        kw = MIXED if key == "mixed" else dict(attention=key)
        jcfg = j_get_reduced("smollm-135m").replace(**kw)
        cfg = get_reduced("smollm-135m", **kw)
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def _np(x):
    """A leaf as numpy; float8 payloads as their bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint8) if x.dtype == jnp.float8_e4m3fn else x


def _to_jax(tree):
    """A port cache tree as the JAX package's (same layout, same leaves)."""
    kinds = {"TaylorState": JTaylorState, "KVCache": jstate.KVCache,
             "MambaCache": JMambaCache}
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return kinds[type(tree).__name__](*(_to_jax(x) for x in tree))
    if isinstance(tree, tuple):
        return tuple(_to_jax(x) for x in tree)
    return jnp.asarray(tree.numpy())


def _assert_trees_equal(a, b, err=""):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb), err
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype, err
        np.testing.assert_array_equal(_np(x), _np(y), err_msg=err)


def _assert_trees_close(a, b, frac):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        x, y = x.float().numpy(), y.float().numpy()
        np.testing.assert_allclose(x, y, atol=frac * max(float(np.abs(y).max()), 1e-6))


def _slot_states(cfg, params):
    """Healthy batch-1 prefill caches, one per slot, distinct prompts."""
    states = []
    for j, n in enumerate(LENS):
        rng = np.random.default_rng(100 + j)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, n)))
        states.append(tlm.lm_prefill(params, {"tokens": toks}, cfg, N_MAX)[1])
    return states


def _fill_store(store, states):
    caches = store.init_caches()
    for j, st in enumerate(states):
        caches = store.ensure_tokens(caches, j, LENS[j])
        caches = store.write_slot(caches, st, j)
    return caches


# ---------------------------------------------------------------------------
# Primitives against JAX
# ---------------------------------------------------------------------------


def _leaves_to_quantise(rng):
    """Leaves with and without lead axes, a zero leaf, non-finite ones."""
    big = rng.standard_normal((2, 3, 4, 2, 16, 16)).astype(np.float32)
    big[0, 1] *= 1e-3
    big[1, 2, 0] *= 300.0
    nonfinite = rng.standard_normal((4, 2, 16)).astype(np.float32)
    nonfinite[1, 0, 3] = np.nan
    nonfinite[2, 1, 5] = np.inf
    nonfinite[3, 0, 0] = -np.inf
    return [(big, 4), (rng.standard_normal((3, 2, 16)).astype(np.float32), 2),
            (np.zeros((3, 2, 16, 16), np.float32), 2), (nonfinite, 2),
            (rng.standard_normal((5, 7)).astype(np.float32) * 1e-30, 1)]


@pytest.mark.parametrize("qdtype", ["int8", "fp8"])
def test_quantize_leaf_bit_identical_to_jax(rng, qdtype):
    """Payload bits equal JAX's on every leaf, zero and non-finite leaves
    included, and so do the dequantised values.  The port's finite scales
    are exact powers of two, so decode→encode→decode is bit-exact (the
    snapshot-handoff property).  JAX's scales equal them bit for bit where
    XLA's ``exp2`` is exact; on the CPU (jax 0.9) it is not for exponents
    below -14 or above 12, where JAX's scale is off the power of two its
    docstring promises by 1 ulp (19 at 2**-106; ROADMAP queue 3): there
    the two answer to a relative 1e-5."""
    for x, n_lead in _leaves_to_quantise(rng):
        got = tstate.quantize_leaf(torch.from_numpy(x), n_lead, qdtype)
        want = jstate.quantize_leaf(jnp.asarray(x), n_lead, qdtype)
        assert got.q.dtype == {"int8": torch.int8, "fp8": torch.float8_e4m3fn}[qdtype]
        np.testing.assert_array_equal(_np(got.q), _np(want.q))
        ours, theirs = got.scale.numpy(), np.asarray(want.scale)
        finite = np.isfinite(ours)
        np.testing.assert_array_equal(ours[~finite], theirs[~finite])
        m, e = np.frexp(ours[finite])
        assert (m == 0.5).all(), "a scale is not a power of two"
        exact = np.frexp(theirs[finite])[0] == 0.5
        np.testing.assert_array_equal(ours[finite][exact], theirs[finite][exact])
        np.testing.assert_allclose(ours[finite], theirs[finite], rtol=1e-5, atol=0)
        assert not (~exact & (e - 1 >= -14) & (e - 1 <= 12)).any()
        deq = tstate.dequantize_leaf(got)
        np.testing.assert_allclose(deq.numpy(), np.asarray(jstate.dequantize_leaf(want)),
                                   rtol=1e-5, atol=0)
        if finite.all():
            again = tstate.quantize_leaf(deq, n_lead, qdtype)
            np.testing.assert_array_equal(_np(again.q), _np(got.q))
            np.testing.assert_array_equal(tstate.dequantize_leaf(again).numpy(), deq.numpy())


def _random_table(rng, slots, pp, total):
    ids = rng.permutation(total)[:slots * pp].reshape(slots, pp).astype(np.int32)
    for s in range(slots):  # allocated entries form a prefix of each row
        ids[s, int(rng.integers(0, pp + 1)):] = -1
    return ids


@pytest.mark.parametrize("lead", [(), (2, 3)])
def test_gather_scatter_pages_match_jax(rng, lead):
    """Random tables holding -1 (free entries read as zeros, their rows are
    dropped on scatter), with and without the group stacking axes, and an
    ``n_max`` that is not a page multiple."""
    slots, hk, ps, hd, pp, total, n_max = 3, 2, 4, 5, 4, 14, 13
    for _ in range(4):
        table = _random_table(rng, slots, pp, total)
        pages = rng.standard_normal(lead + (total, hk, ps, hd)).astype(np.float32)
        dense = rng.standard_normal(lead + (slots, hk, n_max, hd)).astype(np.float32)
        tp, tt, td = (torch.from_numpy(a) for a in (pages, table, dense))
        got = tstate.gather_pages(tp, tt, n_max)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jstate.gather_pages(jnp.asarray(pages), jnp.asarray(table),
                                                        n_max)))
        free = table.reshape(-1) < 0
        if free.any():
            s, j = np.argwhere(table < 0)[0]
            tok = slice(j * ps, min((j + 1) * ps, n_max))
            assert not got.numpy()[..., s, :, tok, :].any(), "a free entry read non-zero"
        out = tstate.scatter_pages(td, tp, tt)
        np.testing.assert_array_equal(
            out.numpy(), np.asarray(jstate.scatter_pages(jnp.asarray(dense), jnp.asarray(pages),
                                                         jnp.asarray(table))))
        np.testing.assert_array_equal(tp.numpy(), pages)  # the input pool is not modified


def test_page_allocator_matches_jax():
    """One seeded ensure/release storm gives JAX's tables and free lists
    after every operation, and the free-list invariant holds throughout."""
    rng = np.random.default_rng(0)
    args = dict(max_slots=6, pages_per_slot=4, total_pages=24, page_size=PAGE, n_max=32)
    ours, theirs = PageAllocator(**args), jrepr.PageAllocator(**args)
    for _ in range(300):
        slot = int(rng.integers(0, 6))
        if rng.random() < 0.6:
            n = int(rng.integers(1, 40))
            assert ours.ensure(slot, n) == theirs.ensure(slot, n)
        else:
            assert ours.release(slot) == theirs.release(slot)
        np.testing.assert_array_equal(ours.table, theirs.table)
        assert ours.free == theirs.free and ours.used_pages == theirs.used_pages
        assigned = ours.table[ours.table >= 0].tolist()
        assert sorted(ours.free + assigned) == list(range(24))


def test_page_allocator_exhaustion_and_reset():
    """An oversubscribed pool fails loudly naming the fix, without leaking
    a partial allocation; reset returns every page."""
    alloc = PageAllocator(max_slots=2, pages_per_slot=4, total_pages=5, page_size=PAGE, n_max=32)
    alloc.ensure(0, 32)
    with pytest.raises(RuntimeError, match="kv_pages"):
        alloc.ensure(1, 32)
    assert len(alloc.free) + int((alloc.table >= 0).sum()) == 5
    assert not alloc.ensure(0, 10_000)  # clamped to n_max: still 4 pages
    alloc.reset()
    assert alloc.used_pages == 0 and (alloc.table == -1).all()
    assert sorted(alloc.free) == list(range(5))


# ---------------------------------------------------------------------------
# The slot-cache conformance grid
# ---------------------------------------------------------------------------


def test_grid_covers_the_advertised_representations():
    assert GRID == [("linear_elu", "dense"), ("linear_elu", "paged"), ("softmax", "dense"),
                    ("softmax", "paged"), ("softmax_window", "dense"), ("ssm", "dense"),
                    ("taylor", "dense"), ("taylor", "int8"), ("taylor", "fp8")]


@pytest.mark.parametrize("backend,rep", GRID)
def test_write_read_round_trip(backend, rep):
    """read_slot(write_slot(s)) == s: bit-exact for dense/paged; for
    quantised state within the dtype's step and idempotent (a snapshot of
    a quantised slot re-encodes bit-exactly)."""
    _, cfg, _, tp = _model(backend)
    store = make_state_store(cfg, SLOTS, N_MAX, "cpu", **_store_kw(rep))
    states = _slot_states(cfg, tp)
    caches = _fill_store(store, states)
    reads = [store.read_slot(caches, j) for j in range(SLOTS)]
    if rep in ("int8", "fp8"):
        for st, r in zip(states, reads):
            _assert_trees_close(r, st, QTOL[rep])
        for j, r in enumerate(reads):
            caches = store.write_slot(caches, r, j)
        for j, r in enumerate(reads):
            _assert_trees_equal(store.read_slot(caches, j), r, f"slot {j} not idempotent")
    else:
        for j, (st, r) in enumerate(zip(states, reads)):
            _assert_trees_equal(r, st, f"slot {j} round trip")


@pytest.mark.parametrize("backend,rep", GRID)
def test_clear_slot_isolation(backend, rep):
    """clear_slot(1) leaves slots 0 and 2 bit-identical and slot 1 reading
    as a fresh slot, healthy, with its pages returned."""
    _, cfg, _, tp = _model(backend)
    store = make_state_store(cfg, SLOTS, N_MAX, "cpu", **_store_kw(rep))
    caches = _fill_store(store, _slot_states(cfg, tp))
    before = [store.read_slot(caches, j) for j in range(SLOTS)]
    caches = store.clear_slot(caches, 1)
    for j in (0, 2):
        _assert_trees_equal(store.read_slot(caches, j), before[j],
                            f"clear_slot(1) disturbed slot {j}")
    fresh = make_state_store(cfg, SLOTS, N_MAX, "cpu", **_store_kw(rep))
    _assert_trees_equal(store.read_slot(caches, 1), fresh.read_slot(fresh.init_caches(), 1),
                        "cleared slot != fresh slot")
    assert bool(store.health(caches)[1]), "cleared slot unhealthy"
    if store.paged:
        assert store.allocator.table[1].max() < 0, "pages leaked on clear"


def _victim(cfg, params):
    """A batch-1 state after a 10-token prefill and 4 greedy decode steps."""
    toks = torch.as_tensor(np.random.default_rng(7).integers(0, cfg.vocab, (1, 10)))
    logits, run = tlm.lm_prefill(params, {"tokens": toks}, cfg, N_MAX)
    tok = logits.argmax(-1)
    for i in range(4):
        logits, run = tlm.lm_decode_step(params, tok, run, 10 + i, cfg)
        tok = logits.argmax(-1)
    return run, tok, 14


def _continue_from(cfg, params, state, tok, pos):
    out = []
    for i in range(4):
        lg, state = tlm.lm_decode_step(params, tok, state, pos + i, cfg)
        tok = lg.argmax(-1)
        out.append(int(tok[0]))
    return out


@pytest.mark.parametrize("backend,rep", GRID + [("mixed", "int8+paged")])
def test_snapshot_restore_token_identity(backend, rep):
    """Preemption handoff: snapshot a mid-decode slot, recycle the slot for
    another request, restore the snapshot — bit-exact against the snapshot,
    and greedy decode continues with identical tokens (for lossless
    representations also those of the never-preempted run)."""
    _, cfg, _, tp = _model(backend)
    store = make_state_store(cfg, SLOTS, N_MAX, "cpu", **_store_kw(rep))
    states = _slot_states(cfg, tp)
    run, tok, pos = _victim(cfg, tp)
    caches = store.init_caches()
    caches = store.ensure_tokens(caches, 0, pos)
    caches = store.write_slot(caches, run, 0)
    snap = store.read_slot(caches, 0)  # preempt
    caches = store.clear_slot(caches, 0)
    caches = store.ensure_tokens(caches, 0, LENS[1])  # the slot is recycled
    caches = store.write_slot(caches, states[1], 0)
    caches = store.clear_slot(caches, 0)
    caches = store.ensure_tokens(caches, 0, pos)  # resume
    caches = store.write_slot(caches, snap, 0)
    restored = store.read_slot(caches, 0)
    _assert_trees_equal(restored, snap, "restore not bit-exact")
    assert _continue_from(cfg, tp, restored, tok, pos) == _continue_from(cfg, tp, snap, tok, pos)
    if rep in ("dense", "paged"):
        assert _continue_from(cfg, tp, snap, tok, pos) == _continue_from(cfg, tp, run, tok, pos)


@pytest.mark.parametrize("backend,rep", GRID + [("mixed", "int8+paged")])
def test_health_accepts_healthy_flags_corrupted(backend, rep):
    """Healthy prefilled slots pass; a NaN- or Inf-poisoned slot is flagged
    alone, whatever the representation."""
    _, cfg, _, tp = _model(backend)
    store = make_state_store(cfg, SLOTS, N_MAX, "cpu", **_store_kw(rep))
    caches = _fill_store(store, _slot_states(cfg, tp))
    assert store.health(caches).all(), "healthy state flagged"
    caches = store.corrupt_slot(caches, 2, float("nan"))
    assert store.health(caches).tolist() == [True, True, False]
    caches = store.corrupt_slot(caches, 0, float("inf"))
    assert store.health(caches).tolist() == [False, True, False]


@pytest.mark.parametrize("backend,rep", GRID + [("mixed", "int8+paged")])
def test_stored_tree_matches_jax(backend, rep):
    """For the same dense caches written through the same page operations,
    every leaf of the stored tree (payloads, scales, pools, table, lengths)
    equals the JAX store's, and so do ``slot_bytes``/``live_bytes``."""
    jcfg, cfg, _, tp = _model(backend)
    ours = make_state_store(cfg, SLOTS, N_MAX, "cpu", **_store_kw(rep))
    theirs = J.make_state_store(jcfg, SLOTS, N_MAX, jnp.float32, **_store_kw(rep))
    states = _slot_states(cfg, tp)
    oc, jc = ours.init_caches(), theirs.init_caches()
    for j in (0, 2, 1):
        oc = ours.ensure_tokens(oc, j, LENS[j])
        jc = theirs.ensure_tokens(jc, j, LENS[j])
        oc = ours.write_slot(oc, states[j], j)
        jc = theirs.write_slot(jc, _to_jax(states[j]), jnp.asarray(j, jnp.int32))
    oc = ours.clear_slot(oc, 2)
    jc = theirs.clear_slot(jc, jnp.asarray(2, jnp.int32))
    assert ours.name == theirs.name == rep
    la, lb = tree_leaves(oc), jax.tree_util.tree_leaves(jc)
    assert len(la) == len(lb)
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert ours.live_bytes(oc) == theirs.live_bytes(jc)
    assert ours.slot_bytes(oc) == theirs.slot_bytes(jc)


def test_mixed_schedule_store_is_hybrid():
    """int8 + paging on the taylor/softmax hybrid resolves to the chained
    codec: KV leaves round-trip bit-exact, moments within the int8 step,
    and a second round trip is idempotent."""
    _, cfg, _, tp = _model("mixed")
    store = make_state_store(cfg, SLOTS, N_MAX, "cpu", **_store_kw("int8+paged"))
    assert store.name == "int8+paged" and store.paged
    assert T.slots.slot_state_kinds(cfg) == {"attn": "moments+kv"}
    states = _slot_states(cfg, tp)
    caches = _fill_store(store, states)
    reads = [store.read_slot(caches, j) for j in range(SLOTS)]
    for st, r in zip(states, reads):
        assert isinstance(r["group"][0], TaylorState)
        _assert_trees_equal(r["group"][1], st["group"][1], "paged KV not lossless")
        _assert_trees_close(r["group"][0], st["group"][0], QTOL["int8"])
    for j, r in enumerate(reads):
        caches = store.write_slot(caches, r, j)
    for j, r in enumerate(reads):
        _assert_trees_equal(store.read_slot(caches, j), r, f"slot {j} not idempotent")


# ---------------------------------------------------------------------------
# Validation
# ---------------------------------------------------------------------------


VALIDATION = [
    ("softmax", dict(state_dtype="int8")),
    ("softmax_window", dict(state_dtype="fp8")),
    ("taylor", dict(state_dtype="bf16")),
    ("taylor", dict(kv_page_size=8)),
    ("softmax_window", dict(kv_page_size=8)),
    ("softmax", dict(kv_page_size=12)),
    ("softmax", dict(kv_page_size=0)),
    ("softmax", dict(kv_page_size=64)),
    ("softmax", dict(kv_page_size=8, kv_pages=3)),
    ("taylor", dict(state_dtype="int8", kv_page_size=8)),
    ("mixed", dict(state_dtype="fp8", kv_page_size=64)),
]


@pytest.mark.parametrize("backend,kw", VALIDATION)
def test_make_state_store_raises_jax_errors(backend, kw):
    """Every unsupported combination raises the JAX package's ValueError,
    word for word, at construction."""
    jcfg, cfg, _, _ = _model(backend)
    with pytest.raises(ValueError) as want:
        J.make_state_store(jcfg, 2, N_MAX, jnp.float32, **kw)
    with pytest.raises(ValueError) as got:
        make_state_store(cfg, 2, N_MAX, "cpu", **kw)
    assert str(got.value) == str(want.value)


def test_engine_rejects_what_the_store_rejects():
    """The engine builds its store at construction, so an unsupported
    representation is a config error there, on a mesh too."""
    _, cfg, _, tp = _model("softmax")
    with pytest.raises(ValueError, match="state_dtype='int8' is not supported"):
        ServeEngine(tp, cfg, device="cpu", state_dtype="int8", **ENGINE_KW)
    with pytest.raises(ValueError, match="state_dtype='int8' is not supported"):
        ServeEngine(tp, cfg, device="cpu", mesh=make_serve_mesh(1, 1, device="cpu"),
                    state_dtype="int8", **ENGINE_KW)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _outputs(key, pkg, trace, **kw):
    jcfg, cfg, jp, tp = _model(key)
    if pkg is J:
        eng = J.ServeEngine(jp, jcfg, **{**ENGINE_KW, **kw})
    else:
        eng = T.ServeEngine(tp, cfg, device="cpu", **{**ENGINE_KW, **kw})
    rids = [eng.submit(it.request()) for it in trace.items]
    results = eng.run(return_results=True)
    assert all(results[r].status.value == "ok" for r in rids)
    return [results[r].tokens for r in rids], eng


ENGINE_CASES = [("taylor", "int8"), ("taylor", "fp8"), ("softmax", "paged"),
                ("linear_elu", "paged"), ("mixed", "int8+paged")]


@pytest.mark.parametrize("key,rep", ENGINE_CASES)
def test_engine_tokens_and_bytes_match_jax(key, rep):
    """On a random trace the port's engine gives the JAX engine's tokens
    and the same live bytes; lossless representations also give the dense
    engine's tokens."""
    cfg = _model(key)[1]
    trace = poisson_trace(11, 6, cfg.vocab, prompt_len=(4, 20), new_tokens=(3, 10))
    ours, oe = _outputs(key, T, trace, **_store_kw(rep))
    theirs, je = _outputs(key, J, trace, **_store_kw(rep))
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    assert oe.slot_state_bytes == je.slot_state_bytes
    assert oe.live_state_bytes == je.live_state_bytes
    if rep in ("paged", "int8+paged") and key != "mixed":
        dense, _ = _outputs(key, T, trace)
        for a, b in zip(ours, dense):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,seed", [("poisson", 11), ("bursty", 5)])
def test_paged_token_identical_to_dense(kind, seed):
    cfg = _model("softmax")[1]
    make = poisson_trace if kind == "poisson" else bursty_trace
    trace = make(seed, 6, cfg.vocab, prompt_len=(4, 20), new_tokens=(3, 10))
    dense, _ = _outputs("softmax", T, trace)
    paged, eng = _outputs("softmax", T, trace, kv_page_size=PAGE)
    for d, p in zip(dense, paged):
        np.testing.assert_array_equal(d, p)
    assert eng.state_store.allocator.used_pages == 0


def _check_allocator(alloc):
    assigned = alloc.table[alloc.table >= 0].tolist()
    everywhere = list(alloc.free) + assigned
    assert len(everywhere) == alloc.total_pages, "pages leaked or double-freed"
    assert len(set(everywhere)) == len(everywhere), "a page has two owners"
    for row in alloc.table:
        backed = row >= 0
        assert backed.all() or not backed[np.argmin(backed):].any(), "page row not a prefix"


@pytest.mark.parametrize("kind,seed", [("poisson", 0), ("bursty", 3)])
def test_no_page_leaks_under_load(kind, seed):
    """run_trace with preemption churn: the allocator invariant holds after
    every engine step, and the pool is empty when the trace has drained."""
    _, cfg, _, tp = _model("softmax")
    make = poisson_trace if kind == "poisson" else bursty_trace
    trace = make(seed, 10, cfg.vocab, prompt_len=(4, 20), new_tokens=(3, 10), priorities=(0, 5))
    held = []

    def factory(clock):
        held.append(ServeEngine(tp, cfg, device="cpu", clock=clock, kv_page_size=PAGE,
                                sched=SchedulerPolicy(preemption=True, priority_admission=True),
                                **ENGINE_KW))
        return held[-1]

    report = run_trace(factory, trace, "paged",
                       step_hook=lambda eng: _check_allocator(eng.state_store.allocator))
    assert len(report.outcomes) == len(trace)
    assert held[-1].state_store.allocator.used_pages == 0


def test_no_page_leaks_across_quarantine():
    """Corruption → quarantine → re-prefill returns the quarantined slot's
    pages and never aliases the healthy slot's; outputs equal clean runs."""
    _, cfg, _, tp = _model("softmax")
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in (9, 14)]
    plan = FaultPlan(events=(SlotCorruption(at_block=1, slot=0, mode="nan"),))
    eng = ServeEngine(tp, cfg, device="cpu", kv_page_size=PAGE, fault_plan=plan, **ENGINE_KW)
    rids = [eng.submit(Request(tokens=p, max_new_tokens=8)) for p in prompts]
    while eng.step():
        _check_allocator(eng.state_store.allocator)
    results = eng.poll()
    assert eng.stats()["quarantined"] == 1
    for rid, p in zip(rids, prompts):
        ref = ServeEngine(tp, cfg, device="cpu", **ENGINE_KW)
        r = ref.submit(Request(tokens=p, max_new_tokens=8))
        np.testing.assert_array_equal(results[rid].tokens, ref.run()[r])
    assert eng.state_store.allocator.used_pages == 0


def test_slot_state_bytes_accounting():
    """Dense: ``slot_bytes`` of the cache, as before.  Paged: pages in use,
    never the pool's capacity; empty again once drained.  int8: about a
    quarter of the dense taylor state."""
    _, cfg, _, tp = _model("softmax")
    dense = ServeEngine(tp, cfg, device="cpu", **ENGINE_KW)
    assert dense.slot_state_bytes == slot_bytes(dense.caches, dense.max_slots)
    assert dense.live_state_bytes == dense.slot_state_bytes * dense.max_slots
    eng = ServeEngine(tp, cfg, device="cpu", kv_page_size=PAGE, **ENGINE_KW)
    store = eng.state_store
    empty = eng.live_state_bytes
    capacity = sum(x.numel() * x.element_size()
                   for x in tree_leaves({k: v for k, v in eng.caches.items() if k != "paged"}))
    per_page = capacity // store.allocator.total_pages
    assert empty < capacity // 4
    eng.submit(Request(tokens=np.arange(9, dtype=np.int32), max_new_tokens=16))
    eng.step()
    used = store.allocator.used_pages
    assert used >= -(-9 // PAGE)
    assert eng.live_state_bytes == empty + used * per_page
    eng.run()
    assert store.allocator.used_pages == 0 and eng.live_state_bytes == empty
    _, tcfg, _, ttp = _model("taylor")
    full = ServeEngine(ttp, tcfg, device="cpu", **ENGINE_KW).slot_state_bytes
    q8 = ServeEngine(ttp, tcfg, device="cpu", state_dtype="int8", **ENGINE_KW).slot_state_bytes
    assert 0.25 < q8 / full < 0.35
