"""The port's baseline attention (exact softmax, sliding-window softmax,
elu+1 linear) against the JAX package's, on the same inputs.

Core functions and backends are fed the same seeded numpy q/k/v and held to
relative error max|Δ| / max|ref| ≤ 1e-5 (float32, one op's sums in another
order).  At model level the reduced smollm-135m (3 layers, d_model 64, head
dim 16, float32; ``attn_window`` 8 so that the ring wraps) runs under each
backend on the JAX ``lm_init(PRNGKey(0))`` weights: logits and caches at
1e-4 (three layers, as in test_torch_model), engine tokens identical, and 5
training steps as in test_torch_train.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as j_get_backend
from repro.backends.softmax_window import _ring_from_sequence as j_ring_from_sequence
from repro.backends.softmax_window import window_attention as j_window_attention
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.core.feature_map import elu_features as j_elu_features
from repro.core.linear import linear_attention as j_linear_attention
from repro.core.softmax import flash_softmax_attention as j_flash_softmax_attention
from repro.core.softmax import softmax_attention as j_softmax_attention
from repro.core.softmax import softmax_decode_step as j_softmax_decode_step
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeEngine as JServeEngine
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro_torch import compare_attention
from repro_torch.backends import KVCache, get_backend, resolve_backend
from repro_torch.backends.softmax_window import _ring_from_sequence, window_attention
from repro_torch.configs import get_config, get_reduced
from repro_torch.core import (
    elu_features,
    flash_softmax_attention,
    linear_attention,
    softmax_attention,
    softmax_decode_step,
)
from repro_torch.data import make_task
from repro_torch.models import attention as tattn
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.serve import Request, ServeEngine, slots
from repro_torch.train import TrainState, make_train_step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CORE_TOL = 1e-5
MODEL_TOL = 1e-4
BACKENDS = ("softmax", "softmax_window", "linear_elu")
WINDOW = 8


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def arrays(rng, *shapes):
    """Seeded float32 numpy arrays, one per shape."""
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def both(*xs):
    """(JAX arrays, torch tensors) of the same numpy arrays."""
    return [jnp.asarray(x) for x in xs], [torch.from_numpy(x) for x in xs]


def qkv(rng, b=2, h=4, hk=2, nq=48, nk=48, d=16, dv=16):
    return both(*arrays(rng, (b, h, nq, d), (b, hk, nk, d), (b, hk, nk, dv)))


def assert_states_close(ts, js, tol):
    assert type(ts).__name__ == type(js).__name__
    for name, a, b in zip(ts._fields, ts, js):
        assert tuple(a.shape) == tuple(b.shape), name
        if name == "length":
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        else:
            assert rel(a, b) <= tol, (name, rel(a, b))


# ---------------------------------------------------------------------------
# Core functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,kv_offset,nq", [(True, 0, 48), (False, 0, 48),
                                                 (True, 40, 8)])
def test_softmax_attention(rng, causal, kv_offset, nq):
    (jq, jk, jv), (tq, tk, tv) = qkv(rng, nq=nq)
    ref = j_softmax_attention(jq, jk, jv, causal=causal, kv_offset=kv_offset)
    out = softmax_attention(tq, tk, tv, causal=causal, kv_offset=kv_offset)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert rel(out, ref) < CORE_TOL


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("n", [64, 40])  # 40 % 16 != 0: the dense fallback
def test_flash_softmax_attention(rng, causal, n):
    (jq, jk, jv), (tq, tk, tv) = qkv(rng, nq=n, nk=n)
    ref = j_flash_softmax_attention(jq, jk, jv, causal=causal, chunk=16)
    out = flash_softmax_attention(tq, tk, tv, causal=causal, chunk=16)
    assert rel(out, ref) < CORE_TOL
    assert rel(out, softmax_attention(tq, tk, tv, causal=causal)) < CORE_TOL


def test_softmax_decode_step_ragged_lengths(rng):
    b, h, hk, n_max, d = 3, 4, 2, 24, 16
    q, kc, vc = arrays(rng, (b, h, d), (b, hk, n_max, d), (b, hk, n_max, d))
    length = np.array([3, 24, 17], np.int32)
    ref = j_softmax_decode_step(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                                jnp.asarray(length))
    out = softmax_decode_step(torch.from_numpy(q), torch.from_numpy(kc),
                              torch.from_numpy(vc), torch.from_numpy(length))
    assert rel(out, ref) < CORE_TOL
    # entries past a row's length do not matter
    kc[0, :, 3:] = 1e3
    again = softmax_decode_step(torch.from_numpy(q), torch.from_numpy(kc),
                                torch.from_numpy(vc), torch.from_numpy(length))
    assert torch.equal(again[0], out[0])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("normalize_qk", [False, True])
def test_linear_attention(rng, causal, normalize_qk):
    (jq, jk, jv), (tq, tk, tv) = qkv(rng)
    ref = j_linear_attention(jq, jk, jv, causal=causal, normalize_qk=normalize_qk)
    out = linear_attention(tq, tk, tv, causal=causal, normalize_qk=normalize_qk)
    assert rel(out, ref) < CORE_TOL


def test_elu_features(rng):
    (x,) = arrays(rng, (3, 5, 16))
    x[0, 0, :4] = [-5.0, -1e-3, 0.0, 1e-3]
    out = elu_features(torch.from_numpy(x).to(torch.bfloat16))
    ref = j_elu_features(jnp.asarray(x, jnp.bfloat16))
    assert out.dtype == torch.float32
    assert rel(out, ref) < CORE_TOL
    assert float(out.min()) > 0.0


# ---------------------------------------------------------------------------
# softmax_window units (mirroring tests/test_hybrid_schedule.py)
# ---------------------------------------------------------------------------


def test_window_attention_equals_full_softmax_when_window_covers(rng):
    (jq, jk, jv), (tq, tk, tv) = qkv(rng, nq=24, nk=24)
    got = window_attention(tq, tk, tv, window=24)
    assert rel(got, softmax_attention(tq, tk, tv, causal=True)) < CORE_TOL
    assert rel(got, j_window_attention(jq, jk, jv, window=24)) < CORE_TOL


def test_window_attention_masks_beyond_window(rng):
    b, h, n, d, w = 1, 2, 20, 8, 4
    (jq, jk, jv), (tq, tk, tv) = qkv(rng, b=b, h=h, hk=h, nq=n, nk=n, d=d, dv=d)
    out = window_attention(tq, tk, tv, window=w)
    assert rel(out, j_window_attention(jq, jk, jv, window=w)) < CORE_TOL
    k2, v2 = tk.clone(), tv.clone()
    k2[:, :, :n - w], v2[:, :, :n - w] = (torch.from_numpy(x) for x in arrays(
        rng, (b, h, n - w, d), (b, h, n - w, d)))
    out2 = window_attention(tq, k2, v2, window=w)
    torch.testing.assert_close(out[:, :, -1], out2[:, :, -1], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("n,w", [(5, 8), (8, 8), (13, 8)])  # filling, full, wrapped
def test_ring_from_sequence(rng, n, w):
    (_, jk, jv), (_, tk, tv) = qkv(rng, nq=n, nk=n)
    ring = _ring_from_sequence(tk, tv, w)
    assert_states_close(ring, j_ring_from_sequence(jk, jv, w), 0.0)


# ---------------------------------------------------------------------------
# Backends: prefill and decode_step against the JAX backends'
# ---------------------------------------------------------------------------


def cfgs(backend, **kw):
    """(JAX reduced config, port reduced config) on ``backend``."""
    kw = dict(attention=backend, attn_window=WINDOW, **kw)
    return j_get_reduced("smollm-135m").replace(**kw), get_reduced("smollm-135m").replace(**kw)


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_prefill_and_decode_match_jax(rng, backend):
    jcfg, cfg = cfgs(backend)
    jb, tb = j_get_backend(backend), get_backend(backend)
    n, n_max = 13, 20
    (jq, jk, jv), (tq, tk, tv) = qkv(rng, nq=n, nk=n)
    jo, jc = jb.prefill(jq, jk, jv, jcfg, n_max)
    to, tc = tb.prefill(tq, tk, tv, cfg, n_max)
    assert rel(to, jo) < CORE_TOL
    assert_states_close(tc, jc, CORE_TOL)
    pos = np.array([n, n], np.int32)
    for _ in range(4):
        (jq1, jk1, jv1), (tq1, tk1, tv1) = both(*arrays(rng, (2, 4, 16), (2, 2, 16),
                                                        (2, 2, 16)))
        jo, jc = jb.decode_step(jc, jq1, jk1, jv1, jcfg, jnp.asarray(pos))
        to, tc = tb.decode_step(tc, tq1, tk1, tv1, cfg, torch.from_numpy(pos))
        assert rel(to, jo) < CORE_TOL
        assert_states_close(tc, jc, CORE_TOL)
        pos = pos + np.array([1, 0], np.int32)  # row 1 frozen, as a retired slot


def test_decode_kv_length_clamped_for_retired_slots(rng):
    cfg = get_reduced("smollm-135m", attention="softmax")
    params = tattn.attention_init(torch.Generator().manual_seed(0), cfg)
    n_max = 8
    cache = tattn.init_cache(cfg, batch=2, n_max=n_max, device="cpu")
    x_t = torch.from_numpy(rng.normal(size=(2, cfg.d_model)).astype(np.float32))
    # row 0 decodes far past capacity (a frozen retired slot), row 1 in range
    pos = torch.tensor([n_max + 5, 3], dtype=torch.int32)
    y, cache = tattn.attention_decode(params, x_t, cache, cfg, pos)
    assert cache.length.tolist() == [n_max, 4]
    assert bool(torch.isfinite(y).all())


@pytest.mark.parametrize("backend,flags", [
    ("softmax", dict(inf=[True, True, False], over=[True, False, True])),
    ("linear_elu", dict(inf=[True, True, False], over=[True, True, True])),
    ("softmax_window", dict(inf=[True, True, False], over=[True, True, True])),
])
def test_kv_state_health(backend, flags):
    jcfg, cfg = cfgs(backend)
    jb, tb = j_get_backend(backend), get_backend(backend)
    cache = tb.init_cache(cfg, 3, 16, "cpu", torch.float32)
    jcache = jb.init_cache(jcfg, 3, 16, jnp.float32)
    assert tb.state_health(cache, cfg).tolist() == [True, True, True]
    bad = cache._replace(k=cache.k.clone())
    bad.k[2] = float("inf")
    over = cache._replace(length=torch.tensor([0, 99, 0], dtype=torch.int32))
    neg = cache._replace(length=torch.tensor([-1, 0, 0], dtype=torch.int32))
    for name, state, jstate in (
        ("inf", bad, jcache._replace(k=jcache.k.at[2].set(jnp.inf))),
        ("over", over, jcache._replace(length=jnp.asarray([0, 99, 0], jnp.int32))),
        ("neg", neg, jcache._replace(length=jnp.asarray([-1, 0, 0], jnp.int32))),
    ):
        got = tb.state_health(state, cfg).tolist()
        assert got == np.asarray(jb.state_health(jstate, jcfg)).tolist(), name
        if name in flags:
            assert got == flags[name], name


@pytest.mark.parametrize("backend", BACKENDS)
def test_registry_config_and_impls(backend):
    cfg = get_config("smollm-135m", backend=backend)
    jcfg = j_get_config("smollm-135m", backend=backend)
    assert cfg.attention == jcfg.attention == backend
    assert cfg.attn_window == jcfg.attn_window
    assert get_config("smollm-135m", backend=backend, n_groups=2).n_groups == 2
    assert resolve_backend(cfg).name == backend
    assert get_backend(backend).state_kind == j_get_backend(backend).state_kind == "kv"
    assert get_backend(backend).resolve_impl(cfg, torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="impls"):
        resolve_backend(cfg.replace(attn_impl="cuda"))
    with pytest.raises(ValueError, match="attn_window"):
        cfg.replace(attn_window=0)


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_ops_on_kv_caches(backend):
    _, cfg = cfgs(backend)
    caches = slots.init_slot_caches(cfg, 3, 16, device="cpu")
    assert caches["group"][0].length.dtype == torch.int32
    one = slots.read_slot(caches, 1)
    one["group"] = tuple(KVCache(st.k + 1.0, st.v - 1.0, st.length + 5) for st in one["group"])
    caches = slots.write_slot(caches, one, 1)
    back = slots.read_slot(caches, 1)["group"][0]
    for a, b in zip(back, one["group"][0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert caches["group"][0].length[:, :, 0].abs().max() == 0  # other slots untouched
    mask = torch.tensor([False, True, False])
    fresh = slots.init_slot_caches(cfg, 3, 16, device="cpu")
    sel = slots.select_slots(mask, caches, fresh)["group"][0]
    assert sel.length.dtype == torch.int32
    assert sel.length[..., 1].unique().tolist() == [5] and sel.length[..., 0].abs().max() == 0
    cleared = slots.read_slot(slots.clear_slot(caches, 1), 1)["group"][0]
    assert all(float(x.abs().max()) == 0 for x in cleared)


# ---------------------------------------------------------------------------
# The reduced model under each backend
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    return jlm.lm_init(jax.random.PRNGKey(0), j_get_reduced("smollm-135m"))


def model(jax_params, backend):
    jcfg, cfg = cfgs(backend)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jax_params), cfg, device="cpu")
    return jcfg, cfg, tp


def tokens(rng, b, n):
    t = rng.integers(0, 128, (b, n)).astype(np.int32)
    return t, torch.from_numpy(t.astype(np.int64))


@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_apply_logits(jax_params, rng, backend):
    jcfg, cfg, tp = model(jax_params, backend)
    jt, tt = tokens(rng, 2, 48)
    ref = jlm.lm_apply(jax_params, {"tokens": jnp.asarray(jt)}, jcfg)[0]
    out, aux = tlm.lm_apply(tp, {"tokens": tt}, cfg)
    assert out.dtype == torch.float32 and tuple(out.shape) == (2, 48, 128)
    assert rel(out, ref) < MODEL_TOL
    assert float(aux) == 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_then_decode(jax_params, rng, backend):
    jcfg, cfg, tp = model(jax_params, backend)
    n, steps = 20, 8
    jt, tt = tokens(rng, 2, n + steps)
    jl, jc = jlm.lm_prefill(jax_params, {"tokens": jnp.asarray(jt[:, :n])}, jcfg, n + steps)
    tl, tc = tlm.lm_prefill(tp, {"tokens": tt[:, :n]}, cfg, n + steps)
    assert rel(tl, jl) < MODEL_TOL
    for i in range(steps):
        pos = n + i
        jl, jc = jlm.lm_decode_step(jax_params, jnp.asarray(jt[:, pos]), jc, pos, jcfg)
        tl, tc = tlm.lm_decode_step(tp, tt[:, pos], tc, pos, cfg)
        assert rel(tl, jl) < MODEL_TOL, i
    (ts,), (js,) = tc["group"], jc["group"]
    assert_states_close(ts, js, MODEL_TOL)
    assert tc["tail"] == () and jc["tail"] == ()


def test_window_ring_prefill_matches_decode_loop(jax_params, rng):
    _, cfg, tp = model(jax_params, "softmax_window")
    n = WINDOW + 9  # wraps the ring
    _, tt = tokens(rng, 1, n)
    logits_pre, caches_pre = tlm.lm_prefill(tp, {"tokens": tt}, cfg, n_max=n + 8)
    caches = tlm.lm_init_caches(cfg, 1, n + 8, device="cpu")
    for i in range(n):
        logits_dec, caches = tlm.lm_decode_step(tp, tt[:, i], caches, i, cfg)
    assert rel(logits_dec, logits_pre) < MODEL_TOL
    assert_states_close(caches["group"][0], caches_pre["group"][0], MODEL_TOL)


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_token_identical_to_jax_engine(jax_params, rng, backend):
    jcfg, cfg, tp = model(jax_params, backend)
    lens = [12, 12, 20, 7, 30]
    budgets = [6, 9, 5, 8, 7]
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in lens]
    jeng = JServeEngine(jax_params, jcfg, max_slots=2, n_max=40, decode_block=4)
    jrids = [jeng.submit(JRequest(tokens=p, max_new_tokens=m))
             for p, m in zip(prompts, budgets)]
    jouts = jeng.run()
    teng = ServeEngine(tp, cfg, max_slots=2, n_max=40, decode_block=4, device="cpu")
    trids = [teng.submit(Request(tokens=p, max_new_tokens=m))
             for p, m in zip(prompts, budgets)]
    touts = teng.run()
    for jr, tr, m in zip(jrids, trids, budgets):
        assert len(touts[tr]) == m
        np.testing.assert_array_equal(touts[tr], np.asarray(jouts[jr]))
    # three requests wait for a slot and are admitted mid-flight
    assert teng.stats()["prefill_dispatches"] == len(lens) - 1
    assert isinstance(teng.caches["group"][0], KVCache)
    assert teng.caches["group"][0].length.dtype == torch.int32


@pytest.mark.parametrize("backend", BACKENDS)
def test_five_steps_match_the_jax_trainer(jax_params, backend):
    jcfg, cfg, _ = model(jax_params, backend)
    lr = 2e-3
    jopt = j_adamw(j_cosine_warmup(lr, 2, 5))
    jstate = j_train_state_init(jax.random.PRNGKey(0), jcfg, jopt)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), cfg,
                             device="cpu")
    task = make_task("bigram", cfg.vocab, 64, 4, seed=0)
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    opt = adamw(cosine_warmup(lr, 2, 5))
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    step = make_train_step(cfg, opt)
    for s in range(5):
        batch = task.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert rel(m["loss"], jm["loss"]) < 1e-3, s
    ours = jax.tree_util.tree_leaves(params_to_numpy(state.params, cfg))
    theirs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        # AdamW moves near-zero-gradient elements by up to ±lr per step
        # either way (test_torch_train): a tenth of the 5 steps' total lr.
        assert float(np.abs(a - b).max()) < 0.1 * 5 * lr


def test_compare_attention_runs_on_cpu(capsys, monkeypatch):
    losses = compare_attention.main(["--device", "cpu", "--steps", "3"])
    out = capsys.readouterr().out
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses.values())
    assert out.count("final loss = ") == 4
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):  # the card unless asked
        compare_attention.main(["--steps", "1"])
