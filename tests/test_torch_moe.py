"""The port's mixture-of-experts FFN against the JAX package's ``models/moe.py``.

Reduced qwen2-moe-a2.7b geometry (d_model 64); router, experts and inputs
are numpy draws from a seed fed to both packages (the JAX ``moe_init``
params go through ``np.asarray``).  Tolerances: 1e-5 relative (max|Δ| /
max|ref|) on float32 outputs, gates, aux losses and gradients; routing
indices and the kept (token, k) pairs exactly.  The dense-vs-capacity
comparison keeps the JAX test's own bounds (atol 1e-4, aux rtol 1e-5).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import moe as j_moe
from repro.models.config import MoEConfig as JMoEConfig
from repro_torch.configs import get_reduced
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-5


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def configs(act="silu", **moe_kw):
    kw = dict(n_experts=6, top_k=2, d_ff_expert=32, n_shared_experts=2, d_ff_shared=64,
              impl="dense")
    kw.update(moe_kw)
    jcfg = j_get_reduced("qwen2-moe-a2.7b").replace(act=act, moe=JMoEConfig(**kw))
    cfg = get_reduced("qwen2-moe-a2.7b").replace(act=act, moe=MoEConfig(**kw))
    return jcfg, cfg


def with_impl(cfg, impl):
    return cfg.replace(moe=dataclasses.replace(cfg.moe, impl=impl))


def init(jcfg, seed=2, bias_rng=None):
    """JAX ``moe_init`` params, as (jax tree, the port's tensors); gelu
    biases drawn from ``bias_rng`` so that they are not zero."""
    tree = jax.tree_util.tree_map(np.asarray, j_moe.moe_init(jax.random.PRNGKey(seed), jcfg))
    if bias_rng is not None:
        tree = jax.tree_util.tree_map_with_path(
            lambda p, x: (0.1 * bias_rng.normal(size=x.shape)).astype(np.float32)
            if jax.tree_util.keystr(p).endswith(("['b_up']", "['b_down']")) else x, tree)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            jax.tree_util.tree_map(lambda x: torch.from_numpy(x.copy()), tree))


def test_moe_config_copies_the_jax_fields():
    ours = {f.name: f.default for f in dataclasses.fields(MoEConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JMoEConfig)}
    assert ours == theirs
    with pytest.raises(ValueError, match="needs ModelConfig.moe"):
        get_reduced("qwen2-moe-a2.7b").replace(moe=None)
    with pytest.raises(ValueError, match="act"):
        get_reduced("qwen2-1.5b").replace(act="relu")
    cfg = with_impl(configs()[1], "ep_a2a_typo")
    with pytest.raises(ValueError, match="unknown moe impl"):
        moe.moe_apply(moe.moe_init(torch.Generator().manual_seed(0), cfg),
                      torch.zeros(1, 2, cfg.d_model), cfg)


def test_moe_init_matches_jax_shapes():
    jcfg, cfg = configs(act="gelu")
    jp, _ = init(jcfg)
    ours = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    theirs = jax.tree_util.tree_map(lambda x: tuple(x.shape), jp)
    assert jax.tree_util.tree_map(lambda x: tuple(x.shape), ours) == theirs
    assert ours["router"]["w"].dtype == torch.float32
    assert theirs["experts"]["w_up"] == (6, 64, 32)


@pytest.mark.parametrize("tied", [False, True])
def test_route_matches_jax(rng, tied):
    jcfg, cfg = configs(n_experts=8, top_k=3)
    jp, tp = init(jcfg)
    if tied:  # columns 1, 4 and 6 equal: their probabilities tie exactly
        w = np.asarray(jp["router"]["w"]).copy()
        w[:, 4] = w[:, 6] = w[:, 1]
        jp = dict(jp, router={"w": jnp.asarray(w)})
        tp = dict(tp, router={"w": torch.from_numpy(w)})
    x = rng.normal(size=(40, cfg.d_model)).astype(np.float32)
    jg, ji, ja = j_moe._route(jp, jnp.asarray(x), jcfg.moe)
    tg, ti, ta = moe._route(tp, torch.from_numpy(x), cfg.moe)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert rel(tg, jg) < TOL and rel(ta, ja) < TOL
    if tied:  # the tie is real and decided as jax.lax.top_k decides it
        probs = torch.softmax(torch.from_numpy(x) @ tp["router"]["w"], -1)
        assert torch.equal(probs[:, 1], probs[:, 4]) and torch.equal(probs[:, 4], probs[:, 6])
        picked = [set(r) & {1, 4, 6} for r in ti.tolist()]
        assert any(len(s) in (1, 2) for s in picked)  # the tie splits a top-k
        for row in ti.tolist():  # among tied experts the lower index comes first
            tied_here = [e for e in row if e in (1, 4, 6)]
            assert tied_here == sorted(tied_here)


@pytest.mark.parametrize("impl", ["dense", "ep", "auto"])
@pytest.mark.parametrize("act", ["silu", "gelu", "geglu"])
def test_moe_apply_matches_jax(rng, act, impl):
    jcfg, cfg = configs(act=act, impl=impl)
    jp, tp = init(jcfg, bias_rng=rng)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    jy, ja = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    ty, ta = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert ty.shape == (2, 16, cfg.d_model)
    assert rel(ty, jy) < TOL and rel(ta, ja) < TOL


def test_moe_dispatch_paths_agree(rng):
    """tests/test_models.py::test_moe_dispatch_paths_agree on the port: dense
    (oracle) and capacity dispatch agree when the capacity is ample; both
    also agree with the JAX package's."""
    jcfg, cfg = configs(n_shared_experts=0, d_ff_shared=0, capacity_factor=8.0)
    jp, tp = init(jcfg)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    y_dense, aux_d = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    y_ep, aux_e = moe.moe_apply(tp, torch.from_numpy(x), with_impl(cfg, "ep"))
    np.testing.assert_allclose(y_dense.numpy(), y_ep.numpy(), atol=1e-4)
    np.testing.assert_allclose(float(aux_d), float(aux_e), rtol=1e-5)
    jy, _ = j_moe.moe_apply(jp, jnp.asarray(x), with_impl(jcfg, "ep"))
    assert rel(y_ep, jy) < TOL


def _jax_keep(idx, n_experts, capacity):
    """The kept (token, k) pairs of the JAX package's capacity dispatch
    (moe.py:302-306: a float cumsum of one-hots, tokens first, then k)."""
    t, k = idx.shape
    flat = jax.nn.one_hot(idx, n_experts, dtype=jnp.float32).reshape(t * k, n_experts)
    pos = jnp.sum((jnp.cumsum(flat, axis=0) - flat) * flat, axis=-1).reshape(t, k)
    return np.asarray(pos.astype(jnp.int32) < capacity)


def test_moe_capacity_drops_tokens_gracefully(rng):
    """tests/test_models.py::test_moe_capacity_drops_tokens_gracefully on the
    port, with the kept pairs and the output equal to the JAX package's."""
    jcfg, cfg = configs(n_experts=4, top_k=2, d_ff_expert=16, n_shared_experts=0,
                        d_ff_shared=0, capacity_factor=0.25, impl="ep")
    jp, tp = init(jcfg)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    y, _ = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    assert torch.isfinite(y).all()
    jy, _ = j_moe.moe_apply(jp, jnp.asarray(x), jcfg)
    assert rel(y, jy) < TOL
    xf = torch.from_numpy(x.reshape(64, -1))
    _, idx, _ = moe._route(tp, xf, cfg.moe)
    cap = moe._capacity(cfg.moe, 64, 4)
    assert cap == j_moe._capacity(jcfg.moe, 64, 4) == 8
    _, keep = moe._dispatch_positions(torch.nn.functional.one_hot(idx, 4).float(), cap)
    want = _jax_keep(jnp.asarray(idx.numpy()), 4, cap)
    np.testing.assert_array_equal(keep.numpy(), want)
    assert 0 < int(keep.sum()) < keep.numel()  # some pairs dropped, not all


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_moe_gradients_match_jax(rng, impl):
    jcfg, cfg = configs(act="gelu", impl=impl, capacity_factor=1.0)
    jp, tp = init(jcfg, bias_rng=rng)
    x = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    t = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p, x):
        y, aux = j_moe.moe_apply(p, x, jcfg)
        return jnp.sum(y * t) + aux

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    leaves = [p.clone().requires_grad_() for p in jax.tree_util.tree_leaves(tp)]
    tp_g = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tp), leaves)
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_apply(tp_g, xt, cfg)
    (y * torch.from_numpy(t)).sum().add(aux).backward()
    assert rel(xt.grad, jgx) < TOL
    for (path, want), got in zip(jax.tree_util.tree_flatten_with_path(jgp)[0], leaves):
        assert rel(got.grad, want) < TOL, jax.tree_util.keystr(path)


def test_ep_a2a_without_a_mesh_runs_ep(rng):
    _, cfg = configs(capacity_factor=0.5)
    params = moe.moe_init(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32))
    y_ep, a_ep = moe.moe_apply(params, x, with_impl(cfg, "ep"))
    y_a2a, a_a2a = moe.moe_apply(params, x, with_impl(cfg, "ep_a2a"))
    assert torch.equal(y_ep, y_a2a) and torch.equal(a_ep, a_a2a)
    y_auto, _ = moe.moe_apply(params, x, with_impl(cfg, "auto"))
    y_dense, _ = moe.moe_apply(params, x, with_impl(cfg, "dense"))
    assert torch.equal(y_auto, y_dense) and not torch.equal(y_auto, y_ep)
