"""The port's model zoo (the dense and MoE decoders) against the JAX package.

For each of qwen2-1.5b (qkv bias, rope_theta 1e6), granite-20b (MQA, 2-matrix
GELU MLP with biases), gemma-7b (GeGLU, head dim 32 reduced / 256 full,
embed scale), qwen2-moe-a2.7b (60 → 6 experts, shared MLP, qkv bias) and
kimi-k2-1t-a32b (384 → 8 experts) at ``reduced()`` size (float32): one
random JAX-layout weight tree, numpy draws from a seed with the JAX
``lm_init`` shapes (biases and norm scales not zero or one, so that every
leaf is exercised), goes to the port through ``params_from_jax``; both
packages see the same tokens.  Tolerances, relative (max|Δ| / max|ref|):
1e-5 on logits, aux losses, decode caches and gradients (float32, sums in
another order).  After one AdamW step the weights answer to 0.1·lr
absolute: AdamW's first update is lr·g/(|g| + eps), so where |g| is near
eps its sign is decided by rounding (tests/test_torch_train.py's rule).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models.config import count_active_params as j_count_active_params
from repro.models.config import count_params as j_count_params
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.serve import prefill_chunked as j_prefill_chunked
from repro.serve import slots as j_slots
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeEngine as JServeEngine
from repro.train import make_train_step as j_make_train_step
from repro.train.step import TrainState as JTrainState
from repro_torch import serve_longcontext, train_resume
from repro_torch.backends import get_backend, resolve_backend
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data import make_task
from repro_torch.models import count_active_params, count_params, lm_init
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import adamw, constant
from repro_torch.serve import Request, ServeEngine, prefill_chunked, slots
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves

TOL = 1e-5
LR = 1e-3
ZOO = ("qwen2-1.5b", "granite-20b", "gemma-7b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
CROSS = ("whisper-medium", "llama-3.2-vision-11b")  # tests/test_torch_cross.py
SSM = ("zamba2-7b", "mamba2-780m")  # tests/test_torch_ssm_zoo.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module.  The suite runs several
    workers side by side; each worker's default intra-op pool (one thread
    per core) oversubscribes the cores, and six concurrent runs of
    train_resume then take ~60x their time alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def flat(tree):
    """{path: numpy} of a JAX-layout tree."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def random_tree(jcfg, seed):
    """A JAX ``lm_init``-layout tree of numpy draws: weights N(0, 1/fan_in)
    (fan-in d_model, or d_ff / h·hd for the down and out projections),
    biases N(0, 0.1²), norm scales 1 + N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    hd = jcfg.resolved_head_dim

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=s.shape)
        if name.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif name.endswith(("['b']", "['b_up']", "['b_down']")):
            x = 0.1 * x
        elif "w_down" in name:
            x = x / np.sqrt(s.shape[-2])
        elif "['wo']" in name:
            x = x / np.sqrt(jcfg.n_heads * hd)
        else:
            x = x / np.sqrt(jcfg.d_model)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_WEIGHTS = {}


def weights(arch):
    """(JAX cfg, port cfg, JAX params, port params, numpy tree), once per arch."""
    if arch not in _WEIGHTS:
        jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
        tree = random_tree(jcfg, seed=ZOO.index(arch))
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        _WEIGHTS[arch] = (jcfg, cfg, jp, params_from_jax(tree, cfg, device="cpu"), tree)
    return _WEIGHTS[arch]


def tokens(rng, b, n):
    t = rng.integers(0, 128, (b, n)).astype(np.int32)
    return t, torch.from_numpy(t.astype(np.int64))


def assert_caches_close(tc, jc):
    assert len(tc["group"]) == len(jc["group"]) and tc["tail"] == jc["tail"] == ()
    for ts, js in zip(tc["group"], jc["group"]):
        assert type(ts).__name__ == type(js).__name__
        for name, a, b in zip(ts._fields, ts, js):
            if b is None:
                assert a is None, name
                continue
            assert tuple(a.shape) == tuple(b.shape), name
            assert rel(a, b) < TOL, (name, rel(a, b))


# fields of the port's config that the JAX package's lacks, at the value
# every architecture of its registry has (Zamba2's hybrid sites)
PORT_ONLY = {"sites": None}


def same_fields(ours, theirs):
    """Every field of the port's config equals the JAX config's; a field the
    JAX config lacks holds ``PORT_ONLY``'s value."""
    for f in dataclasses.fields(ours):
        if f.name in PORT_ONLY and not hasattr(theirs, f.name):
            assert getattr(ours, f.name) == PORT_ONLY[f.name], f.name
            continue
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            assert dataclasses.asdict(a) == {k: v for k, v in dataclasses.asdict(b).items()
                                             if k in dataclasses.asdict(a)}, f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_jax_package_field_by_field(arch):
    same_fields(get_config(arch), j_get_config(arch))
    same_fields(get_reduced(arch), j_get_reduced(arch))
    assert get_config(arch, backend="softmax").attention == "softmax"


def test_archs_in_the_jax_order_and_the_rest_unported():
    """Every architecture of the JAX registry is ported, in its order (the
    cross-attention families too, since they were the last); a name outside
    the registry raises."""
    from repro.configs import ARCHS as J_ARCHS

    assert ARCHS == J_ARCHS
    assert set(ZOO) | set(SSM) | set(CROSS) | {"smollm-135m"} == set(ARCHS)
    for arch in CROSS:
        assert get_config(arch).family in ("encdec", "vlm")
        assert get_reduced(arch).d_model == 64
    with pytest.raises(ValueError, match="unknown architecture"):
        get_config("llama-3.2-vision-90b")
    with pytest.raises(ValueError, match="unknown architecture"):
        get_reduced("llama-3.2-vision-90b")


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equal_the_jax_package(arch):
    """The repaired count: exact for gelu/geglu MLPs, qkv and MLP biases and
    MoE blocks, full configs (kimi-k2's 1 T included) and reduced ones."""
    for ours, theirs in ((get_config(arch), j_get_config(arch)),
                         (get_reduced(arch), j_get_reduced(arch))):
        assert count_params(ours) == j_count_params(theirs)
        assert count_active_params(ours) == j_count_active_params(theirs)
    params = lm_init(torch.Generator().manual_seed(0), get_reduced(arch), device="cpu")
    assert sum(p.numel() for p in tree_leaves(params)) == count_params(get_reduced(arch))
    if arch == "kimi-k2-1t-a32b":
        assert count_params(get_config(arch)) > 10**12


@pytest.mark.parametrize("arch", ZOO)
def test_lm_init_and_weight_bridge(arch):
    """The port's ``lm_init`` has the JAX tree's leaves and shapes, and
    ``params_to_numpy`` gives the JAX tree back bit for bit."""
    jcfg, cfg, _, tp, tree = weights(arch)
    back = flat(params_to_numpy(tp, cfg))
    want = flat(tree)
    assert list(back) == list(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    ours = flat(params_to_numpy(lm_init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                                cfg))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch", ZOO)
def test_lm_apply_logits_and_aux(arch, rng):
    jcfg, cfg, jp, tp, _ = weights(arch)
    jt, tt = tokens(rng, 2, 40)
    jl, ja = jlm.lm_apply(jp, {"tokens": jnp.asarray(jt)}, jcfg)
    for impl in ("auto", "cuda"):  # "cuda" on CPU tensors: the kernels' plain versions
        if impl == "cuda" and cfg.resolved_head_dim > 128:
            continue
        tl, ta = tlm.lm_apply(tp, {"tokens": tt}, cfg.replace(attn_impl=impl))
        assert tl.shape == (2, 40, cfg.vocab)
        assert rel(tl, jl) < TOL, impl
        assert abs(float(ta) - float(ja)) <= TOL * max(abs(float(ja)), 1.0)
    assert (float(ja) > 0) == (cfg.moe is not None)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_then_decode(arch, rng):
    jcfg, cfg, jp, tp, _ = weights(arch)
    n, steps = 24, 4
    jt, tt = tokens(rng, 2, n + steps)
    jl, jc = jlm.lm_prefill(jp, {"tokens": jnp.asarray(jt[:, :n])}, jcfg, n + steps)
    tl, tc = tlm.lm_prefill(tp, {"tokens": tt[:, :n]}, cfg, n + steps)
    assert rel(tl, jl) < TOL
    assert_caches_close(tc, jc)
    jstep = jax.jit(jlm.lm_decode_step, static_argnums=4)
    for i in range(steps):
        pos = n + i
        jl, jc = jstep(jp, jnp.asarray(jt[:, pos]), jc, pos, jcfg)
        tl, tc = tlm.lm_decode_step(tp, tt[:, pos], tc, pos, cfg)
        assert rel(tl, jl) < TOL, i
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("arch", ZOO)
def test_prefill_chunked(arch, rng):
    """37 prompt tokens in chunks of 16 (16 + 16 + 5), through
    ``lm_prefill_chunk`` in both packages, then a 5-token ``lm_verify_chunk``."""
    jcfg, cfg, jp, tp, _ = weights(arch)
    jt, tt = tokens(rng, 2, 37)
    jl, jc = j_prefill_chunked(jp, {"tokens": jnp.asarray(jt)}, jcfg, 48, 16)
    tl, tc = prefill_chunked(tp, {"tokens": tt}, cfg, 48, 16)
    assert rel(tl, jl) < TOL
    assert_caches_close(tc, jc)
    # the speculative verify chunk: every position's logits, from position 37
    jw, tw = tokens(rng, 2, 5)
    jl, jc = jlm.lm_verify_chunk(jp, jnp.asarray(jw), jc, 37, jcfg)
    tl, tc = tlm.lm_verify_chunk(tp, tw, tc, 37, cfg)
    assert tl.shape == (2, 5, cfg.vocab) and rel(tl, jl) < TOL
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("arch", ZOO)
def test_one_training_step(arch):
    """One AdamW step (clip_norm 1.0) on a bigram batch: loss, aux, the
    clipped gradient (AdamW's first moment, 0.1·g after one step) per leaf,
    and every weight after the step."""
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
    assert abs(float(m["aux_loss"]) - float(jm["aux_loss"])) <= TOL * max(
        abs(float(jm["aux_loss"])), 1.0)
    grads, jgrads = flat(params_to_numpy(state.opt_state.m, cfg)), flat(jstate.opt_state.m)
    weights_after, jweights = flat(params_to_numpy(state.params, cfg)), flat(jstate.params)
    assert list(grads) == list(jgrads)
    for k in grads:
        assert rel(grads[k], jgrads[k]) < TOL, (k, rel(grads[k], jgrads[k]))
        assert np.abs(weights_after[k] - jweights[k]).max() < 0.1 * LR, k


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen2-moe-a2.7b"])
def test_engine_tokens_equal_the_jax_engine(arch, rng):
    jcfg, cfg, jp, tp, _ = weights(arch)
    lens, budgets = [12, 12, 20, 7, 30], [6, 9, 5, 8, 7]
    prompts = [rng.integers(0, 128, (n,)).astype(np.int32) for n in lens]
    jeng = JServeEngine(jp, jcfg, max_slots=2, n_max=64, decode_block=4)
    jrids = [jeng.submit(JRequest(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, budgets)]
    jouts = jeng.run()
    teng = ServeEngine(tp, cfg, max_slots=2, n_max=64, decode_block=4, device="cpu")
    trids = [teng.submit(Request(tokens=p, max_new_tokens=m)) for p, m in zip(prompts, budgets)]
    touts = teng.run()
    for jr, tr in zip(jrids, trids):
        np.testing.assert_array_equal(touts[tr], np.asarray(jouts[jr]))
    assert teng.stats()["ok"] == len(lens)
    assert teng.slot_state_bytes == jeng.slot_state_bytes
    assert slots.slot_state_kinds(cfg) == j_slots.slot_state_kinds(jcfg) == {
        cfg.pattern[0]: "moments"}
    assert tlm.lm_state_bytes(cfg, 3, 64) == jlm.lm_state_bytes(jcfg, 3, 64, jnp.float32)


def test_head_dim_256_stays_on_the_torch_paths():
    """gemma-7b's head dim 256 is outside the kernels' envelope (d ≤ 128, as
    the JAX package's backends/taylor.py:46-48): "auto" picks the torch
    paths on the card, a forced "cuda" raises, as JAX's "pallas" does."""
    cfg = get_config("gemma-7b")
    assert cfg.resolved_head_dim == 256
    taylor = get_backend("taylor")
    assert taylor.resolve_impl(cfg, torch.device("cuda")) == "torch"
    with pytest.raises(ValueError, match="head_dim"):
        resolve_backend(cfg.replace(attn_impl="cuda"))
    for arch in ("qwen2-1.5b", "granite-20b", "qwen2-moe-a2.7b", "kimi-k2-1t-a32b"):
        full = get_config(arch)
        assert full.resolved_head_dim == 128
        assert taylor.resolve_impl(full, torch.device("cuda")) == "cuda"


def test_train_resume_is_exact_on_the_cpu(capsys):
    """The demo at 6 steps a run (its default is 30): a checkpoint every 2,
    stopped at 3, resumed from the checkpoint of step 3."""
    assert train_resume.run(torch.device("cpu"), steps=6) < 1e-5
    out = capsys.readouterr().out
    assert "resumed from checkpoint step 3" in out and "resume is exact" in out


def test_serve_longcontext_on_the_cpu(capsys):
    """The cache bytes equal the JAX package's ``lm_state_bytes`` (taylor
    constant, softmax linear in n_ctx); the engine's tokens equal the
    per-token loop's (the script checks them).  Contexts of 256 and 2048
    tokens and 4 requests of 16 new tokens (the demo's defaults: 256, 2048
    and 16384; 8 of 32)."""
    cpu = torch.device("cpu")
    growth = serve_longcontext.cache_growth(cpu, (256, 2048))
    loop_tps, engine_tps, slot_bytes = serve_longcontext.continuous_batching(cpu, 4, 16)
    for backend, rows in growth.items():
        jcfg = j_get_reduced("granite-20b").replace(attention=backend)
        for n_ctx, (nbytes, us) in rows.items():
            assert nbytes == jlm.lm_state_bytes(jcfg, 1, n_ctx, jnp.float32), (backend, n_ctx)
            assert us > 0
    assert len({b for b, _ in growth["taylor"].values()}) == 1
    assert growth["softmax"][2048][0] > 8 * growth["softmax"][256][0] * 0.99
    jcfg = j_get_reduced("qwen2-1.5b")
    assert slot_bytes == jlm.lm_state_bytes(jcfg, 1, 128, jnp.float32)
    assert loop_tps > 0 and engine_tps > 0
    assert "continuous batching" in capsys.readouterr().out
