"""The port's Mamba2 (SSD) core and its block-level backend against the JAX
package.

The same numpy inputs, drawn from a seed, go through ``repro.models.ssm``
and ``repro_torch.models.ssm``.  Tolerances, relative (max|Δ| / max|ref|):
1e-5 for the float32 SSD, the conv, the block's outputs and decode states,
and 1e-5 for the block's gradients against ``jax.grad`` (sums taken in
another order).  The SSD computes every chunk's intra-chunk terms at once
and masks the decay exponent before ``exp`` (``_ssd_chunked``'s docstring):
the values are the reference's, and its gradients stay finite where the
reference's ``exp`` overflows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serve import slots as j_slots
from repro_torch.backends import SSMBackend, get_backend, resolve_backend, tree_slot_health
from repro_torch.configs import get_reduced
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm
from repro_torch.serve import slots

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def both(x):
    """(jax array, torch tensor) of one numpy array."""
    return jnp.asarray(x), torch.from_numpy(np.array(x))


def ssd_inputs(rng, b=2, n=32, H=4, P=8, G=2, N=8, dt_scale=1.0):
    x = rng.normal(size=(b, n, H, P)).astype(np.float32)
    dt = (dt_scale * np.log1p(np.exp(rng.normal(size=(b, n, H)) - 1.0))).astype(np.float32)
    A = -np.exp(rng.uniform(0.0, np.log(16.0), size=(H,))).astype(np.float32)
    B = rng.normal(size=(b, n, G, N)).astype(np.float32)
    C = rng.normal(size=(b, n, G, N)).astype(np.float32)
    h0 = rng.normal(size=(b, H, P, N)).astype(np.float32)
    return x, dt, A, B, C, h0


@pytest.mark.parametrize("n,chunk", [(32, 8), (32, 16), (24, 24)])
def test_ssd_chunked_matches_jax(rng, n, chunk):
    """Two chunk sizes, and one chunk of the whole sequence (what
    ``mamba_apply`` falls back to when the chunk does not divide n); from
    zeros and from an initial state, with the final state returned."""
    x, dt, A, B, C, h0 = ssd_inputs(rng, n=n)
    J = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    T = [torch.from_numpy(a) for a in (x, dt, A, B, C)]
    assert rel(tssm._ssd_chunked(*T, chunk), jssm._ssd_chunked(*J, chunk)) < TOL
    jy, jh = jssm._ssd_chunked(*J, chunk, initial_state=jnp.asarray(h0), return_state=True)
    ty, th = tssm._ssd_chunked(*T, chunk, initial_state=torch.from_numpy(h0),
                               return_state=True)
    assert ty.dtype == th.dtype == torch.float32
    assert rel(ty, jy) < TOL and rel(th, jh) < TOL


def test_ssd_gradients_stay_finite_where_exp_overflows(rng):
    """Steps long enough that exp(cum_i − cum_j) above the diagonal
    overflows float32: the outputs equal the reference's, and the port's
    gradients are finite (autograd through the reference's unmasked ``exp``
    gives 0·inf = NaN there)."""
    x, dt, A, B, C, _ = ssd_inputs(rng, n=16, dt_scale=20.0)
    J = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    T = [torch.from_numpy(a).requires_grad_() for a in (x, dt, A, B, C)]
    y = tssm._ssd_chunked(*T, 16)
    assert rel(y, jssm._ssd_chunked(*J, 16)) < TOL
    grads = torch.autograd.grad(y.square().sum(), T)
    assert all(torch.isfinite(g).all() for g in grads)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jssm._ssd_chunked(*a, 16) ** 2),
                              argnums=(0, 1, 2, 3, 4)))(*J)
    assert not all(bool(jnp.isfinite(g).all()) for g in jgrads)  # the hazard is real here


@pytest.mark.parametrize("streaming", [False, True])
def test_causal_conv_matches_jax(rng, streaming):
    xbc = rng.normal(size=(2, 7, 12)).astype(np.float32)
    w = (0.3 * rng.normal(size=(4, 12))).astype(np.float32)
    b = (0.1 * rng.normal(size=(12,))).astype(np.float32)
    state = rng.normal(size=(2, 3, 12)).astype(np.float32) if streaming else None
    jy, js = jssm._causal_conv(*(jnp.asarray(a) for a in (xbc, w, b)),
                               state=None if state is None else jnp.asarray(state))
    ty, ts = tssm._causal_conv(*(torch.from_numpy(a) for a in (xbc, w, b)),
                               state=None if state is None else torch.from_numpy(state))
    assert rel(ty, jy) < TOL
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def block_weights(jcfg, seed):
    """One mamba block's params (JAX layout) as numpy draws: weights
    N(0, 1/fan_in), conv taps N(0, 0.1²), norm scales 1 + N(0, 0.1²), the
    reference's A_log and dt_bias with noise, D and conv_b not 0 or 1."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jblocks.block_init(jax.random.PRNGKey(0), "mamba", jcfg))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=s.shape)
        if name.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif "conv" in name or "['D']" in name:
            x = 0.1 * x + (1.0 if "['D']" in name else 0.0)
        elif "A_log" in name:
            x = np.log(np.linspace(1.0, 16.0, s.shape[0])) + 0.1 * x
        elif "dt_bias" in name:
            x = np.log(np.expm1(0.01)) + 0.5 * x
        else:
            x = x / np.sqrt(s.shape[0])
        return x.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, shapes)
    torch_tree = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    return jax.tree_util.tree_map(jnp.asarray, tree), torch_tree


@pytest.fixture(scope="module")
def mamba():
    jcfg, cfg = j_get_reduced("mamba2-780m"), get_reduced("mamba2-780m")
    jp, tp = block_weights(jcfg, seed=3)
    return jcfg, cfg, jp, tp


def test_mamba_apply_prefill_and_decode_match_jax(mamba, rng):
    """``mamba_apply`` at two sequence lengths (32: two chunks of
    attn_chunk 16; 24: the one-chunk fallback), ``mamba_prefill``'s output
    and cache, then 4 ``mamba_decode_step``s."""
    jcfg, cfg, jp, tp = mamba
    japply = jax.jit(jssm.mamba_apply, static_argnums=(2, 3))
    for n in (32, 24):
        jx, tx = both(rng.normal(size=(2, n, cfg.d_model)).astype(np.float32))
        assert rel(tssm.mamba_apply(tp["mamba"], tx, cfg, chunk=cfg.attn_chunk),
                   japply(jp["mamba"], jx, jcfg, jcfg.attn_chunk)) < TOL
    jx, tx = both(rng.normal(size=(2, 36, cfg.d_model)).astype(np.float32))
    jy, jc = jax.jit(jssm.mamba_prefill, static_argnums=2)(jp["mamba"], jx[:, :32], jcfg)
    ty, tc = tssm.mamba_prefill(tp["mamba"], tx[:, :32], cfg)
    jstep = jax.jit(jssm.mamba_decode_step, static_argnums=3)
    assert rel(ty, jy) < TOL
    assert type(tc).__name__ == type(jc).__name__ == "MambaCache"
    assert tc.ssd.dtype == torch.float32 and tc.conv.dtype == torch.float32
    assert rel(tc.conv, jc.conv) < TOL and rel(tc.ssd, jc.ssd) < TOL
    for i in range(32, 36):
        jy, jc = jstep(jp["mamba"], jx[:, i], jc, jcfg)
        ty, tc = tssm.mamba_decode_step(tp["mamba"], tx[:, i], tc, cfg)
        assert rel(ty, jy) < TOL, i
    assert rel(tc.conv, jc.conv) < TOL and rel(tc.ssd, jc.ssd) < TOL
    # the zero cache has the reference's shapes and dtypes
    jz = jssm.mamba_init_cache(jcfg, 3)
    tz = tssm.mamba_init_cache(cfg, 3, "cpu")
    for a, b in zip(tz, jz):
        assert tuple(a.shape) == b.shape and str(a.dtype).endswith(str(b.dtype))


def test_mamba_block_gradients_match_jax_grad(mamba, rng):
    """d(Σ out·t)/d(params, x) of one mamba block (pre-norm + SSD +
    residual) at n = 32 (two chunks), against ``jax.grad``."""
    jcfg, cfg, jp, tp = mamba
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    t = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)

    def jloss(p, x):
        return jnp.sum(jblocks.block_apply(p, "mamba", x, jcfg)[0] * t)

    jg, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves, tdef = jax.tree_util.tree_flatten(tp)
    leaves = [a.clone().requires_grad_() for a in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tblocks.block_apply(jax.tree_util.tree_unflatten(tdef, leaves), "mamba", tx, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(t)).sum(), leaves + [tx])
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat_j) == len(leaves)
    for (path, g_ref), g in zip(flat_j, grads[:-1]):
        assert rel(g, g_ref) < TOL, jax.tree_util.keystr(path)
    assert rel(grads[-1], jgx) < TOL


def test_ssm_backend_protocol_and_registry():
    """The block-level backend: its flags, the registry's and the
    schedule's rejections (the JAX package's messages), the protocol
    methods that do not apply, and ``init_cache`` = ``mamba_init_cache``."""
    backend = get_backend("ssm")
    assert isinstance(backend, SSMBackend)
    assert (backend.level, backend.state_kind, backend.impls) == ("block", "ssm", ("torch",))
    assert backend.bounded_state
    cfg = get_reduced("mamba2-780m")
    assert cfg.is_attention_free and not cfg.uses_kv_cache and cfg.supports_long_context
    assert cfg.attention_backend_names == ()
    with pytest.raises(ValueError, match="block-level"):
        resolve_backend(cfg.replace(attention="ssm"))
    with pytest.raises(ValueError, match="block-level"):
        get_reduced("qwen2-1.5b").replace(pattern=("attn", "attn"),
                                          attention_schedule={1: "ssm"})
    with pytest.raises(NotImplementedError, match="causal"):
        backend.apply({}, torch.zeros(1, 4, cfg.d_model), cfg, causal=False)
    with pytest.raises(NotImplementedError, match="decay"):
        backend.merge_state(None, None)
    cache = backend.init_cache(cfg, 2, 64, "cpu", torch.float32)
    assert type(cache) is tssm.MambaCache and cache.ssd.shape == (2, 8, 16, 16)
    zamba = get_reduced("zamba2-7b")
    assert not zamba.is_attention_free and zamba.attention_backend_names == ("taylor",)
    with pytest.raises(ValueError, match="'mamba' block needs"):
        cfg.replace(ssm=None)


@pytest.mark.parametrize("arch", ["mamba2-780m", "zamba2-7b"])
def test_slot_health_flags_only_corrupted_slot(arch):
    """``corrupt_slot`` + ``slot_health`` over SSM (and zamba2's moment)
    states: exactly the poisoned slot is flagged, as in the JAX package
    (tests/test_resilience.py); ``tree_slot_health`` on a ``MambaCache``."""
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    caches = tlm.lm_init_caches(cfg, 4, 32, device="cpu")
    jcaches = jlm.lm_init_caches(jcfg, 4, 32, jnp.float32)
    assert slots.slot_health(caches, cfg).tolist() == [True] * 4
    caches = slots.corrupt_slot(caches, 2, float("nan"))
    jcaches = j_slots.corrupt_slot(jcaches, jnp.asarray(2, jnp.int32),
                                   jnp.asarray(float("nan"), jnp.float32))
    want = [True, True, False, True]
    assert slots.slot_health(caches, cfg).tolist() == want
    np.testing.assert_array_equal(np.asarray(j_slots.slot_health(jcaches, jcfg)), want)
    tail = caches["tail"][-1] if cfg.tail else None
    mamba_run = caches["group"][0]  # [n_groups, run_len, slots, ...]
    assert type(mamba_run) is tssm.MambaCache
    flat = tssm.MambaCache(*(x[0, 0] for x in mamba_run))
    assert tree_slot_health(flat).tolist() == want
    if tail is not None:
        assert type(tail) is tssm.MambaCache and tree_slot_health(tail).tolist() == want
    assert slots.slot_state_kinds(cfg) == j_slots.slot_state_kinds(jcfg)
