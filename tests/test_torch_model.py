"""The port's smollm model against the JAX package's, on the same weights.

Reduced smollm-135m (3 layers, d_model 64, head dim 16, attn_chunk 16,
float32).  The JAX ``lm_init(PRNGKey(0))`` params go through
``params_from_jax``; both packages then see the same tokens.  Logits and
decode caches are compared with relative error max|Δ| / max|ref| < 1e-4:
three float32 layers whose sums run in different orders in the two
frameworks (the single-op parity bound of test_torch_core is 2e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro_torch.backends import get_backend, resolve_backend
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jcfg = j_get_reduced("smollm-135m")
    cfg = get_reduced("smollm-135m")
    jp = jlm.lm_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    return jcfg, cfg, jp, tp


def rel(port, ref) -> float:
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def tokens(rng, b, n):
    t = rng.integers(0, 128, (b, n)).astype(np.int32)
    return t, torch.from_numpy(t.astype(np.int64))


def assert_caches_close(tc, jc):
    (t_state,), (j_state,) = tc["group"], jc["group"]
    for name, a, b in zip(t_state._fields, t_state, j_state):
        assert tuple(a.shape) == tuple(b.shape), name
        assert rel(a, b) < TOL, (name, rel(a, b))
    assert tc["tail"] == () and jc["tail"] == ()


def test_configs_copy_the_jax_values():
    from repro.configs import get_config as j_get_config

    for ours, theirs in ((get_config("smollm-135m"), j_get_config("smollm-135m")),
                         (get_reduced("smollm-135m"), j_get_reduced("smollm-135m"))):
        for field in ("d_model", "n_heads", "n_kv_heads", "d_ff", "vocab", "pattern",
                      "n_groups", "tie_embeddings", "attention", "pos", "attn_chunk",
                      "dtype", "param_dtype", "norm_eps", "rope_theta", "max_seq"):
            assert getattr(ours, field) == getattr(theirs, field), field
        assert ours.resolved_head_dim == theirs.resolved_head_dim
        assert ours.n_layers == theirs.n_layers
        assert ours.taylor.order == theirs.taylor.order
        assert ours.taylor.alpha == theirs.taylor.alpha
    assert get_config("whisper-medium").family == "encdec"  # every arch is ported
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("whisper-large")


def test_lm_init_matches_jax_shapes_and_scales(weights):
    _, cfg, _, tp = weights
    ours = tlm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")

    def leaves(tree, prefix=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{prefix}/{k}")
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{prefix}/{i}")
        else:
            yield prefix, tree

    theirs = dict(leaves(tp))
    mine = dict(leaves(ours))
    assert mine.keys() == theirs.keys()
    for name, x in mine.items():
        assert x.shape == theirs[name].shape, name
        if x.numel() > 1000:  # init scales agree to sampling noise
            assert abs(float(x.std()) / float(theirs[name].std()) - 1) < 0.1, name
    again = tlm.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert torch.equal(again["blocks"][2]["attn"]["wq"]["w"],
                       ours["blocks"][2]["attn"]["wq"]["w"])


def test_lm_apply_logits(weights, rng):
    jcfg, cfg, jp, tp = weights
    jt_, tt_ = tokens(rng, 2, 48)
    ref = jlm.lm_apply(jp, {"tokens": jnp.asarray(jt_)}, jcfg)[0]
    for impl in ("auto", "torch", "cuda"):  # "cuda" on CPU tensors: plain version
        out, aux = tlm.lm_apply(tp, {"tokens": tt_}, cfg.replace(attn_impl=impl))
        assert out.dtype == torch.float32 and tuple(out.shape) == (2, 48, 128)
        assert rel(out, ref) < TOL, impl
        assert float(aux) == 0.0


@pytest.mark.parametrize("n", [32, 20])  # chunked-with-state / parallel + state
def test_prefill_then_decode(weights, rng, n):
    jcfg, cfg, jp, tp = weights
    jt_, tt_ = tokens(rng, 2, n + 8)
    jl, jc = jlm.lm_prefill(jp, {"tokens": jnp.asarray(jt_[:, :n])}, jcfg, n + 8)
    tl, tc = tlm.lm_prefill(tp, {"tokens": tt_[:, :n]}, cfg, n + 8)
    assert rel(tl, jl) < TOL
    assert_caches_close(tc, jc)
    for i in range(8):
        pos = n + i
        jl, jc = jlm.lm_decode_step(jp, jnp.asarray(jt_[:, pos]), jc, pos, jcfg)
        tl, tc = tlm.lm_decode_step(tp, tt_[:, pos], tc, pos, cfg)
        assert rel(tl, jl) < TOL, i
    assert_caches_close(tc, jc)


def test_decode_with_per_row_positions(weights, rng):
    jcfg, cfg, jp, tp = weights
    jt_, tt_ = tokens(rng, 2, 1)
    jc = jlm.lm_init_caches(jcfg, 2, 16, jnp.float32)
    tc = tlm.lm_init_caches(cfg, 2, 16, device="cpu")
    assert_caches_close(tc, jc)
    pos = np.array([3, 7], np.int32)
    jl, _ = jlm.lm_decode_step(jp, jnp.asarray(jt_[:, 0]), jc, jnp.asarray(pos), jcfg)
    tl, _ = tlm.lm_decode_step(tp, tt_[:, 0], tc, torch.from_numpy(pos), cfg)
    assert rel(tl, jl) < TOL


def test_backend_envelope():
    cfg = get_reduced("smollm-135m")
    b = get_backend("taylor")
    assert b.resolve_impl(cfg, torch.device("cpu")) == "torch"
    assert b.resolve_impl(cfg, torch.device("cuda")) == "cuda"
    assert b.resolve_impl(cfg.replace(attn_impl="torch"), torch.device("cuda")) == "torch"
    minus_one = cfg.replace(taylor=cfg.taylor.__class__(minus_one=True))
    assert b.resolve_impl(minus_one, torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="minus_one"):
        resolve_backend(minus_one.replace(attn_impl="cuda"))
    with pytest.raises(ValueError, match="head_dim"):
        resolve_backend(cfg.replace(head_dim=256, attn_impl="cuda"))
    with pytest.raises(ValueError, match="attn_impl"):
        cfg.replace(attn_impl="pallas")
    with pytest.raises(ValueError, match="block-level"):
        resolve_backend(cfg.replace(attention="ssm"))
    assert cfg.layer_cfg("taylor") is cfg
    assert cfg.layer_cfg("softmax").attention == "softmax"


def test_state_health_flags_bad_rows(weights, rng):
    _, cfg, _, tp = weights
    _, caches = tlm.lm_prefill(tp, {"tokens": tokens(rng, 3, 20)[1]}, cfg, 32)
    state = tlm._split_caches(caches, cfg)[1]
    backend = get_backend("taylor")
    assert backend.state_health(state, cfg).tolist() == [True, True, True]
    state.s2[1, 0, 3, 3, 3] = float("nan")
    state.n0[2, 1] = -1.0
    assert backend.state_health(state, cfg).tolist() == [True, False, False]
