"""The Taylor variants of the port — decayed moments, the symmetric-packed
second moment (``sym_state``) and the non-causal single-state form —
against the JAX package's, on the same inputs.

Core functions get the same seeded numpy q/k/v and answer to relative error
max|Δ| / max|ref| < 1e-5 (float32, sums in another order).  At model level
the reduced smollm-135m (3 layers, d_model 64, head dim 16, float32) with
``decay=0.95`` runs on the JAX ``lm_init`` weights: 3 training steps as in
test_torch_baselines, and prefill + decode logits at 1e-4.  (The rows mirror
tests/test_hybrid_schedule.py's decay tests and tests/test_core.py's
feature-map tests.)
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import get_backend as j_get_backend
from repro.backends import resolve_backend as j_resolve_backend
from repro.configs import get_reduced as j_get_reduced
from repro.core import feature_map as jfm
from repro.core import taylor as jt
from repro.core.linear import linear_attention as j_linear_attention
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro_torch.backends import get_backend, resolve_backend
from repro_torch.configs import get_reduced
from repro_torch.core import feature_map as tfm
from repro_torch.core import linear_attention
from repro_torch.core import taylor as tt
from repro_torch.data import make_task
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import adamw, cosine_warmup
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
DECAY = 0.9


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def qkv(rng, b=2, h=4, hk=2, nq=64, nk=None, d=8, dv=8):
    """(torch q, k, v), (JAX q, k, v) of the same seeded numpy arrays."""
    nk = nq if nk is None else nk
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((b, h, nq, d), (b, hk, nk, d), (b, hk, nk, dv))]
    return [torch.from_numpy(x) for x in xs], [jnp.asarray(x) for x in xs]


def cfgs(**kw):
    return tfm.TaylorConfig(**kw), jfm.TaylorConfig(**kw)


def unpack(packed: torch.Tensor, d: int) -> torch.Tensor:
    """A ``sym_state`` moment [b, k, D2(, v)] back in the full basis
    [b, k, d, d(, v)]: entry (m, l) is the symvec entry over its weight."""
    rows, cols = (torch.tensor(i) for i in tfm._triu_indices(d))
    w = torch.where(rows == cols, 1.0, 2.0 ** 0.5)
    x = packed.movedim(2, -1) / w  # [b, k, (v,) D2]
    full = torch.zeros(x.shape[:-1] + (d, d))
    full[..., rows, cols] = x
    full[..., cols, rows] = x
    return full.movedim((-2, -1), (2, 3))


def assert_unpacks_to(sym_state, full_state, d):
    for name, s, f in zip(tt.TaylorState._fields, sym_state, full_state):
        if name in ("z2", "s2"):
            s = unpack(s, d)
        assert tuple(s.shape) == tuple(f.shape), name
        assert rel(s, f.numpy()) < CORE_TOL, (name, rel(s, f.numpy()))


# ---------------------------------------------------------------------------
# Feature map
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [1, 4, 16])
def test_symvec_matches_jax(rng, d):
    x = rng.standard_normal((3, 5, d)).astype(np.float32)
    out = tfm.symvec(torch.from_numpy(x))
    assert tuple(out.shape) == (3, 5, d * (d + 1) // 2)
    assert rel(out, jfm.symvec(jnp.asarray(x))) < CORE_TOL
    assert tfm._triu_indices(d) == jfm._triu_indices(d)
    y = rng.standard_normal((3, 5, d)).astype(np.float32)
    dots = (out * tfm.symvec(torch.from_numpy(y))).sum(-1)
    assert rel(dots, ((x * y).sum(-1)) ** 2) < CORE_TOL  # psi(q)·psi(k) = (q·k)²


@pytest.mark.parametrize("kw", [dict(), dict(order=1), dict(minus_one=True)])
def test_taylor_features_match_jax_and_the_polynomial(rng, kw):
    tc, jc = cfgs(**kw)
    q, k = (rng.standard_normal((2, 7, 16)).astype(np.float32) for _ in range(2))
    fq, fk = (tfm.taylor_features(torch.from_numpy(x), tc) for x in (q, k))
    assert fq.dtype == torch.float32 and fq.shape[-1] == tc.feature_dim(16)
    assert rel(fq, jfm.taylor_features(jnp.asarray(q), jc)) < CORE_TOL
    s = torch.from_numpy((q * k).sum(-1)) * tc.scale(16)
    assert rel((fq * fk).sum(-1), tfm.poly_scores(s, tc).numpy()) < CORE_TOL
    padded = np.concatenate([q, np.zeros_like(q)], axis=-1)
    assert rel(tfm.taylor_features(torch.from_numpy(padded), tc, d=16),
               jfm.taylor_features(jnp.asarray(padded), jc, d=16)) < CORE_TOL


# ---------------------------------------------------------------------------
# Decay
# ---------------------------------------------------------------------------


def test_decay_one_is_bit_identical(rng):
    (tq, tk, tv), _ = qkv(rng)
    for sym in (False, True):
        ref = tfm.TaylorConfig(order=2, sym_state=sym)
        one = tfm.TaylorConfig(order=2, sym_state=sym, decay=1.0)
        for mode in ("parallel", "chunked", "recurrent"):
            a = tt.taylor_attention(tq, tk, tv, ref, mode=mode, chunk=16)
            b = tt.taylor_attention(tq, tk, tv, one, mode=mode, chunk=16)
            assert torch.equal(a, b), (sym, mode)
        _, sa = tt.taylor_attention_chunked(tq, tk, tv, ref, chunk=16, return_state=True)
        _, sb = tt.taylor_attention_chunked(tq, tk, tv, one, chunk=16, return_state=True)
        assert all(torch.equal(x, y) for x, y in zip(sa, sb))


@pytest.mark.parametrize("sym", [False, True])
def test_decay_modes_agree_with_each_other_and_jax(rng, sym):
    (tq, tk, tv), (jq, jk, jv) = qkv(rng)
    tc, jc = cfgs(order=2, sym_state=sym, decay=DECAY)
    par = tt.taylor_attention(tq, tk, tv, tc, mode="parallel")
    for mode in ("parallel", "chunked", "recurrent"):
        out = tt.taylor_attention(tq, tk, tv, tc, mode=mode, chunk=16)
        assert rel(out, par.numpy()) < CORE_TOL, mode
        assert rel(out, jt.taylor_attention(jq, jk, jv, jc, mode=mode, chunk=16)) < CORE_TOL
    # the decayed state handed over by prefill, and decode steps on it
    out, st = tt.taylor_attention_chunked(tq, tk, tv, tc, chunk=16, return_state=True)
    jout, jst = jt.taylor_attention_chunked(jq, jk, jv, jc, chunk=16, return_state=True)
    assert rel(out, jout) < CORE_TOL
    for a, b in zip(st, jst):
        assert rel(a, b) < CORE_TOL
    (tq1, tk1, tv1), (jq1, jk1, jv1) = qkv(rng, nq=1)
    o, st = tt.taylor_decode_step(st, tq1[:, :, 0], tk1[:, :, 0], tv1[:, :, 0], tc)
    jo, jst = jt.taylor_decode_step(jst, jq1[:, :, 0], jk1[:, :, 0], jv1[:, :, 0], jc)
    assert rel(o, jo) < CORE_TOL
    assert rel(tt.taylor_prefill_state(tk, tv, tc).s1,
               jt.taylor_prefill_state(jk, jv, jc).s1) < CORE_TOL


@pytest.mark.parametrize("h_kv,decay", [(1, 0.9), (4, 0.5), (3, 1.0)])
def test_decay_gammas_match(h_kv, decay):
    g = tt.decay_gammas(h_kv, decay)
    assert g.dtype == torch.float32
    assert rel(g, jt.decay_gammas(h_kv, decay)) < 1e-6
    np.testing.assert_allclose(g.numpy(), decay ** (np.arange(1, h_kv + 1) / h_kv), rtol=1e-6)


@pytest.mark.parametrize("kw,attn_impl,match", [
    (dict(decay=0.9), "cuda", "undecayed recurrence"),
    (dict(sym_state=True), "cuda", "sym_state"),
    (dict(minus_one=True), "cuda", "minus_one"),
    (dict(decay=0.9), "torch", None),
    (dict(sym_state=True, decay=0.9), "auto", None),
])
def test_backend_validate_rejects_what_jax_rejects(kw, attn_impl, match):
    tc, jc = cfgs(**kw)
    cfg = get_reduced("smollm-135m", taylor=tc, attn_impl=attn_impl)
    jimpl = {"cuda": "pallas", "torch": "xla", "auto": "auto"}[attn_impl]
    jcfg = j_get_reduced("smollm-135m").replace(taylor=jc, attn_impl=jimpl)
    if match is None:
        assert resolve_backend(cfg).name == j_resolve_backend(jcfg).name == "taylor"
        assert get_backend("taylor").resolve_impl(cfg, torch.device("cuda")) == "torch"
        return
    with pytest.raises(ValueError, match=match):
        resolve_backend(cfg)
    with pytest.raises(ValueError, match=match):
        j_resolve_backend(jcfg)


# ---------------------------------------------------------------------------
# Non-causal
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nq,nk,hk,sym", [
    (48, 48, 2, False),    # one read of all queries
    (256, 40, 2, False),   # chunked query reads (nq a multiple of 128, > 128)
    (256, 64, 1, True),    # MQA, packed state
])
def test_noncausal_matches_jax_and_explicit_features(rng, nq, nk, hk, sym):
    (tq, tk, tv), (jq, jk, jv) = qkv(rng, hk=hk, nq=nq, nk=nk, d=16, dv=16)
    tc, jc = cfgs(sym_state=sym)
    out = tt.taylor_attention_noncausal(tq, tk, tv, tc)
    assert tuple(out.shape) == (2, 4, nq, 16)
    assert rel(out, jt.taylor_attention_noncausal(jq, jk, jv, jc)) < CORE_TOL
    assert torch.equal(out, tt.taylor_attention(tq, tk, tv, tc, causal=False))
    phi = lambda x: tfm.taylor_features(x, tc)
    feat = linear_attention(tq, tk, tv, phi=phi, causal=False, normalize_qk=True)
    assert rel(out, feat.numpy()) < CORE_TOL
    jfeat = j_linear_attention(jq, jk, jv, phi=lambda x: jfm.taylor_features(x, jc),
                               causal=False, normalize_qk=True)
    assert rel(feat, jfeat) < CORE_TOL
    # the backend's non-causal apply is this form
    cfg = get_reduced("smollm-135m", taylor=tc)
    assert torch.equal(get_backend("taylor").apply(tq, tk, tv, cfg, causal=False), out)


def test_noncausal_rejects_decay(rng):
    (tq, tk, tv), (jq, jk, jv) = qkv(rng, nq=8)
    tc, jc = cfgs(decay=0.9)
    with pytest.raises(ValueError, match="causal-self-attention only"):
        tt.taylor_attention_noncausal(tq, tk, tv, tc)
    with pytest.raises(ValueError, match="causal-self-attention only"):
        jt.taylor_attention_noncausal(jq, jk, jv, jc)
    with pytest.raises(ValueError, match="causal-self-attention only"):
        tt.taylor_attention_parallel(tq, tk, tv, tc, causal=False)


# ---------------------------------------------------------------------------
# sym_state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("decay", [1.0, DECAY])
def test_sym_state_prefill_and_decode_unpack_to_the_full_state(rng, decay):
    d = 8
    (tq, tk, tv), (jq, jk, jv) = qkv(rng, d=d, dv=8)
    full = tfm.TaylorConfig(decay=decay)
    sym = tfm.TaylorConfig(decay=decay, sym_state=True)
    init = tt.init_taylor_state(2, 2, d, 8, sym)
    jinit = jt.init_taylor_state(2, 2, d, 8, jfm.TaylorConfig(decay=decay, sym_state=True))
    assert tuple(init.z2.shape) == tuple(jinit.z2.shape) == (2, 2, d * (d + 1) // 2)
    assert tuple(init.s2.shape) == tuple(jinit.s2.shape) == (2, 2, d * (d + 1) // 2, 8)
    o_sym, s_sym = tt.taylor_attention_chunked(tq, tk, tv, sym, chunk=16, return_state=True)
    o_full, s_full = tt.taylor_attention_chunked(tq, tk, tv, full, chunk=16, return_state=True)
    assert rel(o_sym, o_full.numpy()) < CORE_TOL
    assert_unpacks_to(s_sym, s_full, d)
    _, js_sym = jt.taylor_attention_chunked(
        jq, jk, jv, jfm.TaylorConfig(decay=decay, sym_state=True), chunk=16,
        return_state=True)
    for a, b in zip(s_sym, js_sym):
        assert rel(a, b) < CORE_TOL
    assert_unpacks_to(tt.taylor_prefill_state(tk, tv, sym),
                      tt.taylor_prefill_state(tk, tv, full), d)
    for _ in range(3):
        (q1, k1, v1), _ = qkv(rng, nq=1, d=d, dv=8)
        a, s_sym = tt.taylor_decode_step(s_sym, q1[:, :, 0], k1[:, :, 0], v1[:, :, 0], sym)
        b, s_full = tt.taylor_decode_step(s_full, q1[:, :, 0], k1[:, :, 0], v1[:, :, 0], full)
        assert rel(a, b.numpy()) < CORE_TOL
        assert_unpacks_to(s_sym, s_full, d)
    q1 = torch.from_numpy(rng.standard_normal((2, 4, d)).astype(np.float32))
    assert rel(tt.taylor_state_read(s_sym, q1, sym),
               tt.taylor_state_read(s_full, q1, full).numpy()) < CORE_TOL


def test_sym_state_backend_cache_and_health():
    cfg = get_reduced("smollm-135m", taylor=tfm.TaylorConfig(sym_state=True))
    jcfg = j_get_reduced("smollm-135m").replace(taylor=jfm.TaylorConfig(sym_state=True))
    b = get_backend("taylor")
    cache = b.init_cache(cfg, 3, 16, "cpu", torch.float32)
    jcache = j_get_backend("taylor").init_cache(jcfg, 3, 16, jnp.float32)
    assert [tuple(x.shape) for x in cache] == [tuple(x.shape) for x in jcache]
    assert b.state_health(cache, cfg).tolist() == [True, True, True]
    cache.s2[1, 0, 5, 3] = float("nan")
    cache.n0[2, 1] = -1.0
    assert b.state_health(cache, cfg).tolist() == [True, False, False]


# ---------------------------------------------------------------------------
# A decayed model: training and decode against the JAX package's
# ---------------------------------------------------------------------------


def decayed_cfgs():
    cfg = get_reduced("smollm-135m", taylor=tfm.TaylorConfig(decay=0.95))
    jcfg = j_get_reduced("smollm-135m").replace(taylor=jfm.TaylorConfig(decay=0.95))
    return jcfg, cfg


def test_decayed_model_trains_three_steps_like_jax():
    jcfg, cfg = decayed_cfgs()
    lr, steps = 2e-3, 3
    jopt = j_adamw(j_cosine_warmup(lr, 1, steps))
    jstate = j_train_state_init(jax.random.PRNGKey(0), jcfg, jopt)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), cfg,
                             device="cpu")
    task = make_task("bigram", cfg.vocab, 64, 4, seed=0)
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    opt = adamw(cosine_warmup(lr, 1, steps))
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    step = make_train_step(cfg, opt)
    losses = []
    for s in range(steps):
        batch = task.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert rel(m["loss"], jm["loss"]) < 1e-3, s
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    ours = jax.tree_util.tree_leaves(params_to_numpy(state.params, cfg))
    theirs = jax.tree_util.tree_leaves(jax.tree_util.tree_map(np.asarray, jstate.params))
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        # AdamW moves near-zero-gradient elements by up to ±lr per step
        # either way (test_torch_train): a tenth of the steps' total lr.
        assert float(np.abs(a - b).max()) < 0.1 * steps * lr


def test_decayed_model_decodes_like_jax(rng):
    jcfg, cfg = decayed_cfgs()
    jparams = jlm.lm_init(jax.random.PRNGKey(1), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
    n, steps = 32, 6  # a chunked prefill (n = 2 chunks) hands over the state
    toks = rng.integers(0, cfg.vocab, (2, n + steps)).astype(np.int32)
    tt_ = torch.from_numpy(toks.astype(np.int64))
    jl, jc = jlm.lm_prefill(jparams, {"tokens": jnp.asarray(toks[:, :n])}, jcfg, n + steps)
    tl, tc = tlm.lm_prefill(tp, {"tokens": tt_[:, :n]}, cfg, n + steps)
    assert rel(tl, jl) < MODEL_TOL
    for i in range(steps):
        jl, jc = jlm.lm_decode_step(jparams, jnp.asarray(toks[:, n + i]), jc, n + i, jcfg)
        tl, tc = tlm.lm_decode_step(tp, tt_[:, n + i], tc, n + i, cfg)
        assert rel(tl, jl) < MODEL_TOL, i
    (ts,), (js,) = tc["group"], jc["group"]
    for name, a, b in zip(ts._fields, ts, js):
        assert rel(a, b) < MODEL_TOL, name
    # decode agrees with teacher forcing through the decayed chunked scan
    full, _ = tlm.lm_apply(tp, {"tokens": tt_}, cfg)
    assert rel(tl, full[:, -1].detach().numpy()) < MODEL_TOL
    assert dataclasses.replace(cfg.taylor, decay=1.0) == tfm.TaylorConfig()
