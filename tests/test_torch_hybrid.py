"""Per-layer attention schedules (hybrid models) of the port against the JAX
package's, single device.

The model is the Based-style hybrid at the reduced smollm-135m's widths:
pattern ("attn", "attn", "attn") once, taylor at positions 0 and 2 and
``softmax_window`` (window 8, so that the ring wraps) at position 1 — three
runs of two state types, on the JAX ``lm_init(PRNGKey(0))`` weights,
float32.  Logits and caches answer to relative error 1e-4, engine tokens
must be identical, and ``lm_state_bytes`` equal.  (The rows mirror the
single-device rows of tests/test_hybrid_schedule.py.)
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import resolve_backend as j_resolve_backend
from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models.config import schedule_runs as j_schedule_runs
from repro.serve import generate_loop as j_generate_loop
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeEngine as JServeEngine
from repro.serve.slots import slot_bytes as j_slot_bytes
from repro.serve.slots import slot_state_kinds as j_slot_state_kinds
from repro_torch.backends import KVCache, resolve_backend
from repro_torch.configs import get_reduced
from repro_torch.core import TaylorState
from repro_torch.models import lm as tlm
from repro_torch.models.config import schedule_runs
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.serve import Request, ServeEngine, generate_loop, slots


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODEL_TOL = 1e-4
WINDOW = 8
SCHEDULE = {1: "softmax_window"}


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def cfgs(pattern=("attn", "attn", "attn"), n_groups=1, **kw):
    """(JAX, port) reduced smollm-135m hybrids of one geometry."""
    kw.setdefault("attention_schedule", SCHEDULE)
    kw = dict(pattern=pattern, n_groups=n_groups, attn_window=WINDOW, **kw)
    return j_get_reduced("smollm-135m").replace(**kw), get_reduced("smollm-135m", **kw)


@pytest.fixture(scope="module")
def hybrid():
    jcfg, cfg = cfgs()
    jparams = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, tp


def tokens(rng, b, n):
    t = rng.integers(0, 128, (b, n)).astype(np.int32)
    return t, torch.from_numpy(t.astype(np.int64))


def assert_caches_close(tc, jc, tol):
    assert len(tc["group"]) == len(jc["group"])
    for ts, js in zip(tc["group"] + tc["tail"], jc["group"] + jc["tail"]):
        assert type(ts).__name__ == type(js).__name__
        for name, a, b in zip(ts._fields, ts, js):
            if b is None:
                assert a is None, name
                continue
            assert tuple(a.shape) == tuple(b.shape), name
            if name == "length":
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                assert rel(a, b) <= tol, (name, rel(a, b))


# ---------------------------------------------------------------------------
# Config surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw,match", [
    (dict(attention_schedule={5: "softmax"}), "outside pattern"),
    (dict(attention_schedule={0: "flash3"}), "unknown attention backend"),
    (dict(attention_schedule=((0, "softmax"), (0, "taylor"))), "mapped twice"),
    (dict(pattern=("attn", "mamba"), attention_schedule={1: "softmax"}), "'mamba' block"),
    (dict(attn_window=0), "attn_window"),
])
def test_schedule_validation_errors(kw, match):
    jbase, base = cfgs(pattern=("attn", "attn"), attention_schedule=())
    with pytest.raises(ValueError, match=match):
        jbase.replace(**kw)
    with pytest.raises(ValueError, match=match):
        base.replace(**kw)


def test_schedule_normalisation_makes_spellings_equal():
    for base in cfgs(pattern=("attn", "attn"), attention_schedule=()):
        a = base.replace(attention_schedule={1: "softmax_window", 0: "taylor"})
        b = base.replace(attention_schedule=((1, "softmax_window"),))
        assert a == b and hash(a) == hash(b)
        assert a.attention_schedule == ((1, "softmax_window"),)
        assert base.replace(attention_schedule={0: "taylor"}) == base
        assert base.replace(attention_schedule={"1": "softmax"}).attention_schedule == (
            (1, "softmax"),)


@pytest.mark.parametrize("schedule", [SCHEDULE, {1: "softmax"}, {},
                                      {0: "linear_elu", 2: "softmax_window"}])
def test_capability_properties_match_jax(schedule):
    jcfg, cfg = cfgs(attention_schedule=schedule)
    for prop in ("pattern_backends", "attention_backend_names", "backend_desc",
                 "uses_kv_cache", "supports_long_context"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert schedule_runs(cfg) == j_schedule_runs(jcfg)
    assert slots.slot_state_kinds(cfg) == j_slot_state_kinds(jcfg)
    for name in cfg.attention_backend_names:
        lcfg, jlcfg = cfg.layer_cfg(name), jcfg.layer_cfg(name)
        assert lcfg.attention_schedule == jlcfg.attention_schedule == ()
        assert resolve_backend(lcfg).name == j_resolve_backend(jlcfg).name == name


def test_hybrid_capabilities():
    _, hyb = cfgs(pattern=("attn", "attn"))
    assert hyb.pattern_backends == ("taylor", "softmax_window")
    assert hyb.attention_backend_names == ("softmax_window", "taylor")
    assert hyb.backend_desc == "softmax_window+taylor"
    assert hyb.uses_kv_cache and hyb.supports_long_context
    assert slots.slot_state_kinds(hyb) == {"attn": "moments+kv"}
    full = hyb.replace(attention_schedule={1: "softmax"})
    assert full.uses_kv_cache and not full.supports_long_context
    pure = hyb.replace(attention_schedule=())
    assert not pure.uses_kv_cache and pure.supports_long_context
    assert slots.slot_state_kinds(pure) == {"attn": "moments"}
    assert hyb.layer_cfg("taylor") is not hyb and pure.layer_cfg("taylor") is pure


@pytest.mark.parametrize("pattern,schedule", [
    (("attn",), {}),
    (("attn", "attn"), {1: "softmax_window"}),
    (("attn", "attn", "attn"), {1: "softmax_window"}),
    (("attn", "attn", "attn", "attn"), {1: "softmax", 2: "softmax", 3: "linear_elu"}),
])
def test_schedule_runs_match_jax(pattern, schedule):
    jcfg, cfg = cfgs(pattern=pattern, attention_schedule=schedule)
    assert schedule_runs(cfg) == j_schedule_runs(jcfg)


# ---------------------------------------------------------------------------
# The weight bridge and the cache tree
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pattern,n_groups", [(("attn", "attn", "attn"), 1),
                                              (("attn", "attn"), 3)])
def test_params_round_trip_a_hybrid_jax_tree(pattern, n_groups):
    jcfg, cfg = cfgs(pattern=pattern, n_groups=n_groups)
    jparams = jax.tree_util.tree_map(np.asarray, jlm.lm_init(jax.random.PRNGKey(2), jcfg))
    runs = schedule_runs(cfg)
    assert sorted(jparams["blocks"]["group"]) == [f"r{j}" for j in range(len(runs))]
    for j, (_, _, rl) in enumerate(runs):
        wq = jparams["blocks"]["group"][f"r{j}"]["attn"]["wq"]["w"]
        assert wq.shape[:2] == (n_groups, rl)
    tp = params_from_jax(jparams, cfg, device="cpu")
    assert len(tp["blocks"]) == cfg.n_layers
    # the layer of group 1 at pattern position 1 is r1's entry [1, 0]
    if n_groups > 1:
        np.testing.assert_array_equal(
            tp["blocks"][len(pattern) + 1]["attn"]["wq"]["w"].numpy(),
            jparams["blocks"]["group"]["r1"]["attn"]["wq"]["w"][1, 0])
    back = params_to_numpy(tp, cfg)
    flat, tree = jax.tree_util.tree_flatten(back)
    jflat, jtree = jax.tree_util.tree_flatten(jparams)
    assert tree == jtree
    for a, b in zip(flat, jflat):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("pattern,n_groups", [(("attn", "attn", "attn"), 1),
                                              (("attn", "attn"), 3)])
def test_init_caches_match_the_jax_tree(pattern, n_groups):
    jcfg, cfg = cfgs(pattern=pattern, n_groups=n_groups)
    tc = tlm.lm_init_caches(cfg, 2, 24, device="cpu")
    jc = jlm.lm_init_caches(jcfg, 2, 24, jnp.dtype(jcfg.dtype))
    assert [type(s).__name__ for s in tc["group"]] == [type(s).__name__ for s in jc["group"]]
    assert_caches_close(tc, jc, 0.0)
    assert tc["tail"] == () and tc["kv_src"] is None
    # packing per-layer states and splitting them again is the identity
    layers = tlm._split_caches(tc, cfg)
    assert len(layers) == cfg.n_layers
    assert [type(s) for s in layers[:len(pattern)]] == [
        TaylorState if bk == "taylor" else KVCache for bk in cfg.pattern_backends]
    marked = [type(s)(*(None if x is None else x + i for x in s))
              for i, s in enumerate(layers)]
    again = tlm._split_caches(tlm._pack_caches(marked, cfg), cfg)
    for a, b in zip(again, marked):
        assert all(x is None or torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("schedule,n_max", [(SCHEDULE, 64), (SCHEDULE, 256),
                                            ({}, 64), ({1: "softmax"}, 64)])
def test_lm_state_bytes_equals_jax(schedule, n_max):
    jcfg, cfg = cfgs(attention_schedule=schedule)
    got = tlm.lm_state_bytes(cfg, 2, n_max)
    assert got == jlm.lm_state_bytes(jcfg, 2, n_max, jnp.dtype(jcfg.dtype))
    caches = tlm.lm_init_caches(cfg, 2, n_max, device="cpu")
    assert slots.slot_bytes(caches, 2) * 2 == got
    jcaches = jlm.lm_init_caches(jcfg, 2, n_max, jnp.dtype(jcfg.dtype))
    assert slots.slot_bytes(caches, 2) == j_slot_bytes(jcaches, 2)
    if schedule == SCHEDULE:
        # per-layer sum: two taylor layers and one window ring; bounded in n_max
        base = cfg.replace(pattern=("attn",), attention_schedule={})
        assert got == (2 * tlm.lm_state_bytes(base, 2, n_max)
                       + tlm.lm_state_bytes(base.replace(attention="softmax_window"),
                                            2, n_max))
        assert got == tlm.lm_state_bytes(cfg, 2, 16)
        assert got < tlm.lm_state_bytes(cfg.replace(attention_schedule={}), 2, n_max)


# ---------------------------------------------------------------------------
# The reduced hybrid model against the JAX package's
# ---------------------------------------------------------------------------


def test_hybrid_lm_apply_logits(hybrid, rng):
    jcfg, cfg, jparams, tp = hybrid
    jt, tt = tokens(rng, 2, 48)  # past the window and over several taylor chunks
    ref = jlm.lm_apply(jparams, {"tokens": jnp.asarray(jt)}, jcfg)[0]
    out, aux = tlm.lm_apply(tp, {"tokens": tt}, cfg)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 48, 128)
    assert rel(out, ref) < MODEL_TOL
    assert float(aux) == 0.0
    # each layer ran its own backend: the uniform configs give other logits
    for uniform in ("taylor", "softmax_window"):
        other = tlm.lm_apply(tp, {"tokens": tt}, cfg.replace(attention=uniform,
                                                              attention_schedule={}))[0]
        assert rel(other, ref) > 1e-2, uniform


def test_hybrid_prefill_matches_teacher_forcing(hybrid, rng):
    jcfg, cfg, jparams, tp = hybrid
    for n in (WINDOW + 8, 32):  # the parallel + state prefill; the chunked scan
        jt, tt = tokens(rng, 2, n)
        full, _ = tlm.lm_apply(tp, {"tokens": tt}, cfg)
        tl, tc = tlm.lm_prefill(tp, {"tokens": tt}, cfg, n + 8)
        assert rel(tl, full[:, -1].detach().numpy()) < MODEL_TOL
        jl, jc = jlm.lm_prefill(jparams, {"tokens": jnp.asarray(jt)}, jcfg, n + 8)
        assert rel(tl, jl) < MODEL_TOL
        assert_caches_close(tc, jc, MODEL_TOL)
        assert [type(s) for s in tc["group"]] == [TaylorState, KVCache, TaylorState]


def test_hybrid_decode_past_the_window_matches_jax(hybrid, rng):
    jcfg, cfg, jparams, tp = hybrid
    n, steps = 20, 2 * WINDOW + 3
    jt, tt = tokens(rng, 2, n + steps)
    jl, jc = jlm.lm_prefill(jparams, {"tokens": jnp.asarray(jt[:, :n])}, jcfg, n + steps)
    tl, tc = tlm.lm_prefill(tp, {"tokens": tt[:, :n]}, cfg, n + steps)
    for i in range(steps):
        pos = n + i
        jl, jc = jlm.lm_decode_step(jparams, jnp.asarray(jt[:, pos]), jc, pos, jcfg)
        tl, tc = tlm.lm_decode_step(tp, tt[:, pos], tc, pos, cfg)
        assert rel(tl, jl) < MODEL_TOL, i
    assert_caches_close(tc, jc, MODEL_TOL)
    full, _ = tlm.lm_apply(tp, {"tokens": tt}, cfg)
    assert rel(tl, full[:, -1].detach().numpy()) < MODEL_TOL
    # token by token from zero caches, with a per-row position vector
    caches = tlm.lm_init_caches(cfg, 2, n + steps, device="cpu")
    for i in range(n + steps):
        lg, caches = tlm.lm_decode_step(tp, tt[:, i], caches,
                                        torch.full((2,), i, dtype=torch.int32), cfg)
    assert rel(lg, full[:, -1].detach().numpy()) < MODEL_TOL


def test_hybrid_continuous_batching_matches_solo_and_jax(hybrid, rng):
    jcfg, cfg, jparams, tp = hybrid
    lens = (WINDOW + 3, WINDOW + 3, 2 * WINDOW + 1, 9, 40)  # the first two share a prefill
    budgets = (6, 9, 4, 5, 7)
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in lens]
    eng = ServeEngine(tp, cfg, max_slots=2, n_max=64, decode_block=3, device="cpu")
    rids = [eng.submit(Request(tokens=p, max_new_tokens=b)) for p, b in zip(prompts, budgets)]
    outs = eng.run()
    jeng = JServeEngine(jparams, jcfg, max_slots=2, n_max=64, decode_block=3)
    jrids = [jeng.submit(JRequest(tokens=p, max_new_tokens=b))
             for p, b in zip(prompts, budgets)]
    jouts = jeng.run()
    for p, b, rid, jrid in zip(prompts, budgets, rids, jrids):
        assert len(outs[rid]) == b
        solo = generate_loop(tp, {"tokens": torch.from_numpy(p.astype(np.int64))[None]},
                             cfg, steps=b, device="cpu")
        np.testing.assert_array_equal(outs[rid], np.asarray(solo)[0])
        np.testing.assert_array_equal(outs[rid], np.asarray(jouts[jrid]))
        jsolo = j_generate_loop(jparams, {"tokens": jnp.asarray(p)[None]}, jcfg, steps=b)
        np.testing.assert_array_equal(outs[rid], np.asarray(jsolo)[0])
    # three requests wait for a slot and are admitted mid-flight
    assert eng.stats()["prefill_dispatches"] == len(lens) - 1
    assert [type(s) for s in eng.caches["group"]] == [TaylorState, KVCache, TaylorState]
    assert slots.slot_bytes(eng.caches, 2) == tlm.lm_state_bytes(cfg, 1, 64)
