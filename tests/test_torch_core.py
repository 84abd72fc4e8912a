"""Parity of the PyTorch port's Taylor core (repro_torch.core) with repro.core.

Both packages get the same numpy inputs; every comparison is float32 on the
CPU with relative error max|port - jax| / max|jax| < 2e-5 (the two sum in
different orders; 2e-5 is ~170 float32 ulps of the largest value).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import feature_map as jfm
from repro.core import taylor as jt
from repro_torch.core import feature_map as tfm
from repro_torch.core import taylor as tt


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 2e-5
# (order, h, hk): GQA at both orders, and MQA.
CASES = [(1, 4, 2), (2, 4, 2), (2, 4, 1)]
IDS = ["order1-gqa", "order2-gqa", "order2-mqa"]


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def qkv(rng, b=2, h=4, hk=2, n=64, d=16, dv=16):
    return (rng.normal(size=(b, h, n, d)).astype(np.float32),
            rng.normal(size=(b, hk, n, d)).astype(np.float32),
            rng.normal(size=(b, hk, n, dv)).astype(np.float32))


def both(*arrays):
    return [torch.from_numpy(a) for a in arrays], [jnp.asarray(a) for a in arrays]


def cfgs(order, **kw):
    return tfm.TaylorConfig(order=order, **kw), jfm.TaylorConfig(order=order, **kw)


def assert_states_close(ts, js):
    for name, a, b in zip(jt.TaylorState._fields, ts, js):
        if b is None:
            assert a is None, name
            continue
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel(a, b) < TOL, (name, rel(a, b))


@pytest.mark.parametrize("kw", [dict(order=3), dict(alpha=0.0), dict(decay=0.0),
                                dict(decay=1.5), dict(decay=-0.5)])
def test_taylor_config_rejects_what_jax_rejects(kw):
    with pytest.raises(ValueError):
        jfm.TaylorConfig(**kw)
    with pytest.raises(ValueError):
        tfm.TaylorConfig(**kw)


def test_feature_map_helpers(rng):
    x = rng.normal(size=(3, 5, 16)).astype(np.float32) * 3 + 1
    (tx,), (jx,) = both(x)
    assert rel(tfm.layernorm_no_affine(tx), jfm.layernorm_no_affine(jx)) < TOL
    for order in (1, 2):
        for minus_one in (False, True):
            tc, jc = cfgs(order, minus_one=minus_one)
            assert rel(tfm.poly_scores(tx, tc), jfm.poly_scores(jx, jc)) < TOL
            assert tc.scale(16) == jc.scale(16)
            assert tc.feature_dim(16) == jc.feature_dim(16)


@pytest.mark.parametrize("order", [1, 2])
def test_init_state_and_safe_div(rng, order):
    tc, jc = cfgs(order)
    assert_states_close(tt.init_taylor_state(2, 3, 8, 5, tc),
                        jt.init_taylor_state(2, 3, 8, 5, jc))
    num = rng.normal(size=(4, 3)).astype(np.float32)
    den = np.array([2.0, -3e-7, 4e-7, 0.0], np.float32)
    (tn, td), (jn, jd) = both(num, den)
    assert rel(tt._safe_div(tn, td), jt._safe_div(jn, jd)) < TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_state_update_and_inter_chunk_read(rng, case):
    order, h, hk = case
    tc, jc = cfgs(order)
    b, c, d, dv = 2, 16, 64, 8  # d = 64: _quad_num and the update tile by 32
    q, k, v = qkv(rng, b=b, h=h, hk=hk, n=c, d=d, dv=dv)
    qg = q.reshape(b, hk, h // hk, c, d)
    (tqg, tk, tv), (jqg, jk, jv) = both(qg, k, v)
    t_state = tt._state_update(tt.init_taylor_state(b, hk, d, dv, tc), tk, tv, tc)
    j_state = jt._state_update(jt.init_taylor_state(b, hk, d, dv, jc), jk, jv, jc)
    assert_states_close(t_state, j_state)
    a = tc.scale(d)
    t_num, t_den = tt._chunk_inter(tqg, t_state, tc, a)
    j_num, j_den = jt._chunk_inter(jqg, j_state, jc, a)
    assert rel(t_num, j_num) < TOL
    assert rel(t_den, j_den) < TOL
    if order == 2:
        assert rel(tt._quad_num(tqg, t_state.s2, 0.5 * a * a),
                   jt._quad_num(jqg, j_state.s2, 0.5 * a * a)) < TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_parallel(rng, case):
    order, h, hk = case
    tc, jc = cfgs(order)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(rng, h=h, hk=hk))
    out = tt.taylor_attention_parallel(tq, tk, tv, tc)
    assert rel(out, jt.taylor_attention_parallel(jq, jk, jv, jc)) < TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_with_initial_and_returned_state(rng, case):
    order, h, hk = case
    tc, jc = cfgs(order)
    q, k, v = qkv(rng, h=h, hk=hk, n=96)
    (tq, tk, tv), (jq, jk, jv) = both(q, k, v)
    # first 32 tokens build the state that the last 64 continue from
    t_out0, t_state0 = tt.taylor_attention_chunked(
        tq[:, :, :32], tk[:, :, :32], tv[:, :, :32], tc, chunk=16, return_state=True)
    j_out0, j_state0 = jt.taylor_attention_chunked(
        jq[:, :, :32], jk[:, :, :32], jv[:, :, :32], jc, chunk=16, return_state=True)
    assert rel(t_out0, j_out0) < TOL
    assert_states_close(t_state0, j_state0)
    t_out, t_state = tt.taylor_attention_chunked(
        tq[:, :, 32:], tk[:, :, 32:], tv[:, :, 32:], tc, chunk=16,
        initial_state=t_state0, return_state=True)
    j_out, j_state = jt.taylor_attention_chunked(
        jq[:, :, 32:], jk[:, :, 32:], jv[:, :, 32:], jc, chunk=16,
        initial_state=j_state0, return_state=True)
    assert rel(t_out, j_out) < TOL
    assert_states_close(t_state, j_state)
    # the plain chunked call (no state) equals the JAX custom-VJP forward
    assert rel(tt.taylor_attention_chunked(tq, tk, tv, tc, chunk=16),
               jt.taylor_attention_chunked(jq, jk, jv, jc, chunk=16)) < TOL


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_chunked_num_den(rng, case):
    order, h, hk = case
    tc, jc = cfgs(order)
    b, n, c, d = 2, 48, 16, 16
    q, k, v = qkv(rng, b=b, h=h, hk=hk, n=n)
    g, nc = h // hk, n // c
    qs = np.moveaxis(q.reshape(b, hk, g, nc, c, d), 3, 0).copy()
    ks = np.moveaxis(k.reshape(b, hk, nc, c, d), 2, 0).copy()
    vs = np.moveaxis(v.reshape(b, hk, nc, c, d), 2, 0).copy()
    (tqs, tks, tvs), (jqs, jks, jvs) = both(qs, ks, vs)
    t = tt.chunked_num_den(tqs, tks, tvs, tc, tt.init_taylor_state(b, hk, d, d, tc))
    j = jt.chunked_num_den(jqs, jks, jvs, jc, jt.init_taylor_state(b, hk, d, d, jc))
    assert rel(t[0], j[0]) < TOL
    assert rel(t[1], j[1]) < TOL
    assert_states_close(t[2], j[2])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_decode_steps_match_jax_recurrent(rng, case):
    order, h, hk = case
    tc, jc = cfgs(order)
    q, k, v = qkv(rng, h=h, hk=hk, n=24)
    (tq, tk, tv), (jq, jk, jv) = both(q, k, v)
    ref = jt.taylor_attention_recurrent(jq, jk, jv, jc)
    assert rel(tt.taylor_attention_recurrent(tq, tk, tv, tc), ref) < TOL
    state = tt.init_taylor_state(2, hk, 16, 16, tc)
    for t in range(q.shape[2]):
        out, state = tt.taylor_decode_step(state, tq[:, :, t], tk[:, :, t], tv[:, :, t], tc)
        assert rel(out, ref[:, :, t]) < TOL, t


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_prefill_state_read_and_merge(rng, case):
    order, h, hk = case
    tc, jc = cfgs(order)
    q, k, v = qkv(rng, h=h, hk=hk, n=40)
    (tq, tk, tv), (jq, jk, jv) = both(q, k, v)
    t_a = tt.taylor_prefill_state(tk[:, :, :25], tv[:, :, :25], tc)
    t_b = tt.taylor_prefill_state(tk[:, :, 25:], tv[:, :, 25:], tc)
    j_a = jt.taylor_prefill_state(jk[:, :, :25], jv[:, :, :25], jc)
    j_b = jt.taylor_prefill_state(jk[:, :, 25:], jv[:, :, 25:], jc)
    assert_states_close(t_a, j_a)
    t_ab, j_ab = tt.merge_states(t_a, t_b), jt.merge_states(j_a, j_b)
    assert_states_close(t_ab, j_ab)
    assert_states_close(tt.taylor_prefill_state(tk[:, :, 25:], tv[:, :, 25:], tc, t_a), j_ab)
    assert rel(tt.taylor_state_read(t_ab, tq[:, :, -1], tc),
               jt.taylor_state_read(j_ab, jq[:, :, -1], jc)) < TOL


@pytest.mark.parametrize("mode", ["auto", "parallel", "chunked", "recurrent"])
@pytest.mark.parametrize("n", [48, 40])  # 40 % 16 != 0: chunked falls back to parallel
def test_dispatcher(rng, mode, n):
    tc, jc = cfgs(2)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(rng, n=n))
    out = tt.taylor_attention(tq, tk, tv, tc, mode=mode, chunk=16)
    assert rel(out, jt.taylor_attention(jq, jk, jv, jc, mode=mode, chunk=16)) < TOL


def test_minus_one_variant(rng):
    tc, jc = cfgs(2, minus_one=True)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(rng, n=32))
    assert rel(tt.taylor_attention_chunked(tq, tk, tv, tc, chunk=16),
               jt.taylor_attention_chunked(jq, jk, jv, jc, chunk=16)) < TOL


@pytest.mark.parametrize("kw", [dict(decay=0.9), dict(sym_state=True)])
def test_unported_variants_raise(rng, kw):
    # Both variants run the torch paths now, as the reference runs them on
    # XLA; they raise only where the reference's do: decay in the
    # non-causal form, and either variant forced onto the CUDA kernels.
    from repro_torch.backends import resolve_backend
    from repro_torch.configs import get_reduced

    tc, jc = cfgs(2, **kw)
    (tq, tk, tv), (jq, jk, jv) = both(*qkv(rng, n=32))
    assert rel(tt.taylor_attention_chunked(tq, tk, tv, tc, chunk=16),
               jt.taylor_attention_chunked(jq, jk, jv, jc, chunk=16)) < TOL
    shapes = lambda st: [None if x is None else tuple(x.shape) for x in st]
    assert shapes(tt.init_taylor_state(1, 1, 4, 4, tc)) == shapes(
        jt.init_taylor_state(1, 1, 4, 4, jc))
    if tc.decay != 1.0:
        for fn, q, k, v, c in ((tt.taylor_attention, tq, tk, tv, tc),
                               (jt.taylor_attention, jq, jk, jv, jc)):
            with pytest.raises(ValueError, match="causal-self-attention only"):
                fn(q, k, v, dataclasses.replace(c), causal=False)
    else:
        assert rel(tt.taylor_attention(tq, tk, tv, tc, causal=False),
                   jt.taylor_attention(jq, jk, jv, jc, causal=False)) < TOL
    with pytest.raises(ValueError, match="attn_impl='cuda'"):
        resolve_backend(get_reduced("smollm-135m", taylor=tc, attn_impl="cuda"))
