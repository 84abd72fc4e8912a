"""mamba2-780m and zamba2-7b of the port against the JAX package.

At ``reduced()`` size (float32): one random JAX-layout weight tree of
numpy draws from a seed, with the JAX ``lm_init`` shapes, goes to the port
through ``params_from_jax``; both packages see the same tokens.  The draws
are N(0, 1/fan_in) for weights, 1 + N(0, 0.1²) for norm scales, the
reference's ``A_log`` and ``dt_bias`` with noise, and D and the conv taps
not 0 or 1.  Tolerances, relative (max|Δ| / max|ref|): 1e-5 on logits,
decode caches and gradients (float32, sums in another order).  After one
AdamW step the weights answer to 0.1·lr absolute (AdamW's first update is
lr·g/(|g| + eps): where |g| is near eps its sign is decided by rounding,
tests/test_torch_train.py's rule).  A mamba block's chunked prefill scans
its token recurrence while whole prefill runs the chunked SSD, so each is
held to the JAX function of the same name.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_get_reduced
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.serve import prefill_chunked as j_prefill_chunked
from repro.serve import slots as j_slots
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeEngine as JServeEngine
from repro.train import make_train_step as j_make_train_step
from repro.train.step import TrainState as JTrainState
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import make_task
from repro_torch.models import count_params, lm_init, schedule_runs
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.ssm import MambaCache
from repro_torch.optim import adamw, constant
from repro_torch.serve import Request, ServeEngine, prefill_chunked, slots
from repro_torch.serve.state_repr import make_state_store
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves

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
LR = 1e-3
ARCHS = ("mamba2-780m", "zamba2-7b")


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def flat(tree):
    """{path: numpy} of a JAX-layout tree."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def random_tree(jcfg, seed):
    """A JAX ``lm_init``-layout tree of numpy draws (module docstring)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    hd = jcfg.resolved_head_dim

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=s.shape)
        if name.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif "conv_" in name:
            x = 0.1 * x
        elif name.endswith("['D']"):
            x = 1 + 0.1 * x
        elif "A_log" in name:
            x = np.log(np.linspace(1.0, 16.0, s.shape[-1])) + 0.1 * x
        elif "dt_bias" in name:
            x = np.log(np.expm1(0.01)) + 0.5 * x
        elif "w_down" in name or "out_proj" in name:
            x = x / np.sqrt(s.shape[-2])
        elif "['wo']" in name:
            x = x / np.sqrt(jcfg.n_heads * hd)
        else:
            x = x / np.sqrt(jcfg.d_model)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_WEIGHTS = {}


def weights(arch, **overrides):
    """(JAX cfg, port cfg, JAX params, port params, numpy tree), once each."""
    key = (arch, tuple(sorted(overrides.items())))
    if key not in _WEIGHTS:
        jcfg, cfg = j_get_reduced(arch, **overrides), get_reduced(arch, **overrides)
        tree = random_tree(jcfg, seed=ARCHS.index(arch))
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        _WEIGHTS[key] = (jcfg, cfg, jp, params_from_jax(tree, cfg, device="cpu"), tree)
    return _WEIGHTS[key]


def tokens(rng, b, n):
    t = rng.integers(0, 128, (b, n)).astype(np.int32)
    return t, torch.from_numpy(t.astype(np.int64))


def assert_caches_close(tc, jc):
    for key in ("group", "tail"):
        assert len(tc[key]) == len(jc[key]), key
        for ts, js in zip(tc[key], jc[key]):
            assert type(ts).__name__ == type(js).__name__
            for name, a, b in zip(ts._fields, ts, js):
                if b is None:
                    assert a is None, name
                    continue
                assert tuple(a.shape) == tuple(b.shape), name
                assert rel(a, b) < TOL, (name, rel(a, b))


def test_param_counts_and_the_shared_block():
    """The published counts, the reduced ones (the JAX package's), each the
    sum of the port's own leaves; zamba2's shared block is one set of leaves
    under ``"shared"``, its occurrences ``None`` in ``"blocks"``."""
    assert count_params(get_config("mamba2-780m")) == 780_148_992
    assert count_params(get_config("zamba2-7b")) == 5_893_372_128
    for arch, n in (("mamba2-780m", 92_712), ("zamba2-7b", 192_776)):
        cfg = get_reduced(arch)
        params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        assert count_params(cfg) == n == sum(p.numel() for p in tree_leaves(params))
    kinds = [k for k, _ in tlm._layer_cfgs(cfg)]
    assert [i for i, p in enumerate(params["blocks"]) if p is None] == \
        [i for i, k in enumerate(kinds) if k == "shared_attn"] == [2, 5]
    assert set(params["shared"]) == {"norm1", "attn", "norm2", "mlp"}


@pytest.mark.parametrize("arch", ARCHS)
def test_weight_bridge_round_trip(arch):
    """The JAX tree goes in and comes back out bit for bit (zamba2's group
    holds ``r0`` and no ``r1``: the shared run has none); the port's
    ``lm_init`` has the JAX tree's leaves and shapes."""
    jcfg, cfg, _, tp, tree = weights(arch)
    back, want = flat(params_to_numpy(tp, cfg)), flat(tree)
    assert list(back) == list(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    if arch == "zamba2-7b":
        assert sorted(tree["blocks"]["group"]) == ["r0"] and "shared" in tree["blocks"]
    ours = flat(params_to_numpy(lm_init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                                cfg))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_logits(arch, rng):
    jcfg, cfg, jp, tp, _ = weights(arch)
    jt, tt = tokens(rng, 2, 32)  # two SSD chunks (the one-chunk fallback: test_torch_ssm)
    jl, _ = jax.jit(jlm.lm_apply, static_argnums=2)(jp, {"tokens": jnp.asarray(jt)}, jcfg)
    for impl in ("auto", "cuda"):  # "cuda" on CPU tensors: the kernels' plain versions
        tl, ta = tlm.lm_apply(tp, {"tokens": tt}, cfg.replace(attn_impl=impl))
        assert tl.shape == (2, 32, cfg.vocab) and rel(tl, jl) < TOL and float(ta) == 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode(arch, rng):
    jcfg, cfg, jp, tp, _ = weights(arch)
    n, steps = 32, 4
    jt, tt = tokens(rng, 2, n + steps)
    jl, jc = jax.jit(jlm.lm_prefill, static_argnums=(2, 3))(
        jp, {"tokens": jnp.asarray(jt[:, :n])}, jcfg, n + steps)
    tl, tc = tlm.lm_prefill(tp, {"tokens": tt[:, :n]}, cfg, n + steps)
    assert rel(tl, jl) < TOL
    assert_caches_close(tc, jc)
    assert type(tc["group"][0]) is MambaCache
    jstep = jax.jit(jlm.lm_decode_step, static_argnums=4)
    for i in range(steps):
        pos = n + i
        jl, jc = jstep(jp, jnp.asarray(jt[:, pos]), jc, pos, jcfg)
        tl, tc = tlm.lm_decode_step(tp, tt[:, pos], tc, pos, cfg)
        assert rel(tl, jl) < TOL, i
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_chunked_and_verify(arch, rng):
    """37 prompt tokens in chunks of 16 through ``lm_prefill_chunk`` in both
    packages (a mamba block scans its recurrence), then a 5-token
    ``lm_verify_chunk``."""
    jcfg, cfg, jp, tp, _ = weights(arch)
    jt, tt = tokens(rng, 2, 37)
    jl, jc = j_prefill_chunked(jp, {"tokens": jnp.asarray(jt)}, jcfg, 48, 16)
    tl, tc = prefill_chunked(tp, {"tokens": tt}, cfg, 48, 16)
    assert rel(tl, jl) < TOL
    assert_caches_close(tc, jc)
    jw, tw = tokens(rng, 2, 5)
    jl, jc = jlm.lm_verify_chunk(jp, jnp.asarray(jw), jc, 37, jcfg)
    tl, tc = tlm.lm_verify_chunk(tp, tw, tc, 37, cfg)
    assert tl.shape == (2, 5, cfg.vocab) and rel(tl, jl) < TOL
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_training_step(arch):
    """One AdamW step (clip_norm 1.0) on a bigram batch: the loss, the
    clipped gradient (AdamW's first moment, 0.1·g after one step) of every
    leaf — zamba2's shared block summed over its occurrences, in one leaf
    with one update — and every weight after the step."""
    jcfg, cfg, jp, tp, _ = weights(arch)
    task = make_task("bigram", cfg.vocab, 32, 4, seed=0)
    batch = task.batch_at(0)
    jopt, opt = j_adamw(j_constant(LR)), adamw(constant(LR))
    jstate = JTrainState(jnp.zeros((), jnp.int32), jp, jopt.init(jp))
    jstate, jm = jax.jit(j_make_train_step(jcfg, jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = TrainState(torch.zeros((), dtype=torch.int32), tp, opt.init(tp))
    state, m = make_train_step(cfg, opt)(state, {k: torch.from_numpy(v)
                                                 for k, v in batch.items()})
    assert rel(m["loss"], jm["loss"]) < TOL
    grads, jgrads = flat(params_to_numpy(state.opt_state.m, cfg)), flat(jstate.opt_state.m)
    after, jafter = flat(params_to_numpy(state.params, cfg)), flat(jstate.params)
    assert list(grads) == list(jgrads)
    assert any("['shared']" in k for k in grads) == (arch == "zamba2-7b")
    for k in grads:
        assert rel(grads[k], jgrads[k]) < TOL, (k, rel(grads[k], jgrads[k]))
        assert np.abs(after[k] - jafter[k]).max() < 0.1 * LR, k


def test_shared_block_at_head_dim_112_trains_like_jax(rng):
    """zamba2's shared block at its published head dim 112 (the reduced
    config with ``head_dim=112``): its output and gradients (params and
    input) through the CUDA kernels' path (``attn_impl="cuda"``: on CPU
    tensors their plain versions, behind the wrapper's padding of d to 128,
    its alpha rescale and its slicing of dq and dk back to 112) against
    ``jax.grad`` of the JAX block on its plain ("xla") path."""
    jcfg = j_get_reduced("zamba2-7b", head_dim=112, attn_impl="xla")
    cfg = get_reduced("zamba2-7b", head_dim=112, attn_impl="cuda")
    tree = random_tree(jcfg, seed=5)["blocks"]["shared"]
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    x = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    t = rng.normal(size=(2, 32, cfg.d_model)).astype(np.float32)
    def jloss(p, x):
        out = jblocks.block_apply(p, "shared_attn", x, jcfg)[0]
        return jnp.sum(out * t), out

    (_, jout), (jg, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        jp, jnp.asarray(x))
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    leaves, tdef = jax.tree_util.tree_flatten(tree)
    leaves = [torch.from_numpy(np.array(a)).requires_grad_() for a in leaves]
    tx = torch.from_numpy(x).requires_grad_()
    out, _ = tblocks.block_apply(jax.tree_util.tree_unflatten(tdef, leaves), "shared_attn",
                                 tx, cfg, torch.arange(32))
    assert rel(out, jout) < TOL
    grads = torch.autograd.grad((out * torch.from_numpy(t)).sum(), leaves + [tx])
    for path, g, g_ref in zip(paths, grads, jax.tree_util.tree_leaves(jg)):
        assert rel(g, g_ref) < TOL, path
    assert rel(grads[-1], jgx) < TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_equal_the_jax_engine(arch, rng):
    jcfg, cfg, jp, tp, _ = weights(arch)
    lens, budgets = [12, 12, 20, 7, 30], [6, 9, 5, 8, 7]
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in lens]
    jeng = JServeEngine(jp, jcfg, max_slots=2, n_max=64, decode_block=4, prefill_chunk=16)
    jrids = [jeng.submit(JRequest(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, budgets)]
    jouts = jeng.run()
    teng = ServeEngine(tp, cfg, max_slots=2, n_max=64, decode_block=4, prefill_chunk=16,
                       device="cpu")
    trids = [teng.submit(Request(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, budgets)]
    touts = teng.run()
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(touts[tr], np.asarray(jouts[jr]))
    assert teng.stats()["ok"] == len(lens)
    assert teng.slot_state_bytes == jeng.slot_state_bytes
    assert slots.slot_state_kinds(cfg) == j_slots.slot_state_kinds(jcfg)
    assert tlm.lm_state_bytes(cfg, 3, 64) == jlm.lm_state_bytes(jcfg, 3, 64, jnp.float32)


def test_int8_store_keeps_mamba_nodes_dense(rng):
    """An int8 slot store over zamba2: the moment nodes are quantised, the
    mamba nodes stay dense and come back bit-identical through write and
    read, beside a quantised moment round trip."""
    jcfg, cfg, jp, tp, _ = weights("zamba2-7b")
    store = make_state_store(cfg, 3, 64, device="cpu", state_dtype="int8")
    _, one = tlm.lm_prefill(tp, {"tokens": tokens(rng, 1, 20)[1]}, cfg, 64)
    stored = store.write_slot(store.init_caches(), one, 1)
    kinds = [k for k, _, _ in schedule_runs(cfg)] + list(cfg.tail)
    nodes = list(stored["group"]) + list(stored["tail"])
    assert [type(n).__name__ for n in nodes] == [
        "MambaCache" if k == "mamba" else "TaylorState" for k in kinds]
    assert type(stored["group"][1].s2).__name__ == "QuantizedLeaf"
    back = store.read_slot(stored, 1)
    for got, want, kind in zip(list(back["group"]) + list(back["tail"]),
                               list(one["group"]) + list(one["tail"]), kinds):
        if kind == "mamba":
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert store.health(stored).tolist() == [True] * 3
