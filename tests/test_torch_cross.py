"""The port's cross-attention families against the JAX package: the
encoder-decoder whisper-medium and the VLM llama-3.2-vision-11b.

Both at ``reduced()`` size (float32): one random JAX-layout weight tree,
numpy draws from a seed with the JAX ``lm_init`` shapes (biases, layernorm
biases and norm scales not zero or one, so that every leaf is exercised),
goes to the port through ``params_from_jax``; both packages see the same
tokens and the same source extras (``audio_frames`` [b, 24, 64],
``image_embeds`` [b, 16, 32], numpy draws).  Tolerances, relative
(max|Δ| / max|ref|): 1e-5 on logits, decode caches, losses and gradients
(float32, sums in another order); after one AdamW step the weights answer
to 0.1·lr absolute (tests/test_torch_zoo.py's rule).  Engine tokens are
equal.  Whisper runs the Taylor backend and its softmax baseline (the
cross source as a KV cache); neither model reaches a CUDA kernel, as in
the JAX package, whose Pallas envelope excludes cross models.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.backends import resolve_backend as j_resolve_backend
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.models import lm as jlm
from repro.models import layers as jlayers
from repro.models.config import count_params as j_count_params
from repro.optim import adamw as j_adamw
from repro.optim import constant as j_constant
from repro.serve.scheduler import Request as JRequest
from repro.serve.scheduler import ServeEngine as JServeEngine
from repro.train import make_train_step as j_make_train_step
from repro.train.step import TrainState as JTrainState
from repro_torch.backends import get_backend, resolve_backend
from repro_torch.backends.state import CrossCache
from repro_torch.configs import get_config, get_reduced
from repro_torch.models import count_params, lm_init
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import adamw, constant
from repro_torch.serve import (
    Request,
    RequestRejected,
    ServeEngine,
    corrupt_slot,
    generate,
    prefill_chunked,
    slot_health,
)
from repro_torch.serve.state_repr import make_state_store
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_items, tree_leaves

TOL = 1e-5
LR = 1e-3
CROSS = ("whisper-medium", "llama-3.2-vision-11b")
# (arch, attention backend): whisper also on its softmax baseline
CASES = [("whisper-medium", "taylor"), ("whisper-medium", "softmax"),
         ("llama-3.2-vision-11b", "taylor")]
CASE_IDS = ["whisper", "whisper-softmax", "vlm"]


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


def flat(tree):
    """{path: numpy} of a JAX-layout tree."""
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def random_tree(jcfg, seed):
    """A JAX ``lm_init``-layout tree of numpy draws: weights N(0, 1/fan_in),
    biases N(0, 0.1²), norm scales 1 + N(0, 0.1²), position tables
    N(0, 0.1²)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jlm.lm_init(jax.random.PRNGKey(0), jcfg))
    hd = jcfg.resolved_head_dim

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.normal(size=s.shape)
        if name.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif name.endswith(("['b']", "['b_up']", "['b_down']", "['bias']", "['pos_embed']")):
            x = 0.1 * x
        elif "w_down" in name:
            x = x / np.sqrt(s.shape[-2])
        elif "['wo']" in name:
            x = x / np.sqrt(jcfg.n_heads * hd)
        elif "vision_proj" in name:
            x = x / np.sqrt(jcfg.vision_dim)
        else:
            x = x / np.sqrt(jcfg.d_model)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


_WEIGHTS = {}


def weights(arch, backend="taylor", **overrides):
    """(JAX cfg, port cfg, JAX params, port params, numpy tree), once per case."""
    key = (arch, backend, tuple(sorted(overrides.items())))
    if key not in _WEIGHTS:
        jcfg = j_get_reduced(arch).replace(attention=backend, **overrides)
        cfg = get_reduced(arch).replace(attention=backend, **overrides)
        tree = random_tree(jcfg, seed=CROSS.index(arch))
        jp = jax.tree_util.tree_map(jnp.asarray, tree)
        _WEIGHTS[key] = (jcfg, cfg, jp, params_from_jax(tree, cfg, device="cpu"), tree)
    return _WEIGHTS[key]


def extras(cfg, rng, b):
    """The family's source input, numpy float32 with a leading [b] axis."""
    if cfg.family == "vlm":
        return {"image_embeds": rng.normal(size=(b, cfg.n_image_tokens, cfg.vision_dim))
                .astype(np.float32)}
    return {"audio_frames": rng.normal(size=(b, cfg.n_audio_ctx, cfg.d_model))
            .astype(np.float32)}


def batches(cfg, rng, b, n):
    """The same batch for both packages: (JAX dict, port dict, numpy tokens)."""
    t = rng.integers(0, cfg.vocab, (b, n)).astype(np.int32)
    ex = extras(cfg, rng, b)
    jb = {"tokens": jnp.asarray(t), **{k: jnp.asarray(v) for k, v in ex.items()}}
    tb = {"tokens": torch.from_numpy(t.astype(np.int64)),
          **{k: torch.from_numpy(v) for k, v in ex.items()}}
    return jb, tb, t


def prefix(batch, n):
    return dict(batch, tokens=batch["tokens"][:, :n])


def assert_caches_close(tc, jc):
    """Every leaf of the port's cache tree (cross pairs and kv_src too) at
    the JAX tree's path, shape and value."""
    ours = dict(tree_items(tc))
    theirs = {p: x for p, x in jax.tree_util.tree_flatten_with_path(jc)[0]}
    assert len(ours) == len(theirs)
    for (path, a), b in zip(ours.items(), theirs.values()):
        assert tuple(a.shape) == tuple(b.shape), path
        assert rel(a, b) < TOL, (path, rel(a, b))


def test_configs_counts_and_the_registry():
    """Field by field (every port field equals the JAX config's), the exact
    parameter counts of the published and reduced configs (whisper's
    encoder and layernorm biases, the VLM's projector), the registry in the
    JAX order, and the learned-position variant's tables."""
    from repro.configs import ARCHS as J_ARCHS
    from repro_torch.configs import ARCHS

    assert ARCHS == J_ARCHS
    for arch in CROSS:
        for ours, theirs in ((get_config(arch), j_get_config(arch)),
                             (get_reduced(arch), j_get_reduced(arch))):
            for f in dataclasses.fields(ours):
                if f.name == "sites" and not hasattr(theirs, f.name):
                    assert ours.sites is None  # the port's Zamba2 sites field
                    continue
                a, b = getattr(ours, f.name), getattr(theirs, f.name)
                if not dataclasses.is_dataclass(a):
                    assert a == b, f.name
            assert count_params(ours) == j_count_params(theirs)
            assert ours.n_encoder_layers == theirs.n_encoder_layers
    assert count_params(get_config("whisper-medium")) == 758_248_448
    assert count_params(get_config("llama-3.2-vision-11b")) == 10_115_977_216
    assert count_params(get_config("llama-3.2-vision-11b", n_groups=1)) == 2_188_427_264
    for arch in CROSS:
        learned = get_reduced(arch, pos="learned")
        assert count_params(learned) == j_count_params(j_get_reduced(arch, pos="learned"))
        params = lm_init(torch.Generator().manual_seed(0), learned, device="cpu")
        assert sum(p.numel() for p in tree_leaves(params)) == count_params(learned)


@pytest.mark.parametrize("arch", CROSS)
def test_weight_bridge_both_ways(arch):
    """``params_to_numpy`` gives the JAX tree back bit for bit (the stacked
    encoder, ``vision_proj``, the cross blocks, the layernorm biases), and
    the port's own ``lm_init`` has the JAX tree's leaves and shapes."""
    _, cfg, _, tp, tree = weights(arch)
    back, want = flat(params_to_numpy(tp, cfg)), flat(tree)
    assert list(back) == list(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])
    assert any("encoder" in k for k in want) == (arch == "whisper-medium")
    assert any("vision_proj" in k for k in want) == (arch != "whisper-medium")
    ours = flat(params_to_numpy(lm_init(torch.Generator().manual_seed(0), cfg, device="cpu"),
                                cfg))
    assert {k: v.shape for k, v in ours.items()} == {k: v.shape for k, v in want.items()}


@pytest.mark.parametrize("arch,backend", CASES, ids=CASE_IDS)
def test_lm_apply_logits(arch, backend, rng):
    jcfg, cfg, jp, tp, _ = weights(arch, backend)
    jb, tb, _ = batches(cfg, rng, 2, 40)
    jl, _ = jlm.lm_apply(jp, jb, jcfg)
    tl, ta = tlm.lm_apply(tp, tb, cfg)
    assert tl.shape == (2, 40, cfg.vocab)
    assert rel(tl, jl) < TOL
    assert float(ta) == 0.0
    # the source matters: another source gives other logits
    tl2, _ = tlm.lm_apply(tp, dict(tb, **{k: torch.flip(v, (0,)) for k, v in tb.items()
                                          if k != "tokens"}), cfg)
    assert rel(tl2, tl) > 1e-3


@pytest.mark.parametrize("arch,backend", CASES, ids=CASE_IDS)
def test_prefill_decode_and_verify(arch, backend, rng):
    """Prefill of 24 tokens, 8 teacher-forced decode steps and a 5-token
    ``lm_verify_chunk``, against JAX at 1e-5 (logits and every cache leaf,
    the cross pairs and ``kv_src`` included), and against the port's own
    ``lm_apply`` at the JAX test's 2e-3 (tests/test_models.py)."""
    jcfg, cfg, jp, tp, _ = weights(arch, backend)
    n, steps = 24, 8
    jb, tb, t = batches(cfg, rng, 2, n + steps)
    full, _ = tlm.lm_apply(tp, tb, cfg)
    jl, jc = jlm.lm_prefill(jp, prefix(jb, n), jcfg, 64)
    tl, tc = tlm.lm_prefill(tp, prefix(tb, n), cfg, 64)
    assert rel(tl, jl) < TOL
    np.testing.assert_allclose(tl.numpy(), full[:, n - 1].detach().numpy(), atol=2e-3, rtol=2e-3)
    assert_caches_close(tc, jc)
    jstep = jax.jit(jlm.lm_decode_step, static_argnums=4)
    for i in range(n, n + steps):
        jl, jc = jstep(jp, jnp.asarray(t[:, i]), jc, i, jcfg)
        tl, tc = tlm.lm_decode_step(tp, tb["tokens"][:, i], tc, i, cfg)
        assert rel(tl, jl) < TOL, i
        if i < n + steps - 1:
            np.testing.assert_allclose(tl.numpy(), full[:, i].detach().numpy(),
                                       atol=2e-3, rtol=2e-3)
    assert_caches_close(tc, jc)
    w = rng.integers(0, cfg.vocab, (2, 5)).astype(np.int32)
    jl, jc = jlm.lm_verify_chunk(jp, jnp.asarray(w), jc, n + steps, jcfg)
    tl, tc = tlm.lm_verify_chunk(tp, torch.from_numpy(w.astype(np.int64)), tc, n + steps, cfg)
    assert tl.shape == (2, 5, cfg.vocab) and rel(tl, jl) < TOL
    assert_caches_close(tc, jc)


@pytest.mark.parametrize("arch,backend", CASES, ids=CASE_IDS)
def test_init_caches_structure_matches_prefill(arch, backend, rng):
    """``lm_init_caches`` has ``lm_prefill``'s tree (paths, shapes, dtypes),
    and the JAX package's zeros; ``lm_state_bytes`` equals JAX's; and
    ``prefill_chunked`` refuses a source family, as in the JAX package."""
    jcfg, cfg, _, tp, _ = weights(arch, backend)
    _, tb, _ = batches(cfg, rng, 3, 12)
    _, tc = tlm.lm_prefill(tp, tb, cfg, 32)
    zero = tlm.lm_init_caches(cfg, 3, 32, device="cpu")
    got, want = dict(tree_items(zero)), dict(tree_items(tc))
    assert list(got) == list(want)
    for path in got:
        assert (got[path].shape, got[path].dtype) == (want[path].shape, want[path].dtype), path
    assert type(tc["group"][-1]) is tuple and isinstance(tc["group"][-1][1], CrossCache)
    assert tuple(tc["kv_src"].shape) == (3, cfg.n_source_tokens, cfg.d_model)
    assert_caches_close(zero, jlm.lm_init_caches(jcfg, 3, 32, jnp.float32))
    assert tlm.lm_state_bytes(cfg, 3, 32) == jlm.lm_state_bytes(jcfg, 3, 32, jnp.float32)
    with pytest.raises(ValueError, match="decoder-only"):
        prefill_chunked(tp, tb, cfg, 32, 4)


@pytest.mark.parametrize("arch", CROSS)
def test_one_training_step(arch):
    """One AdamW step on a bigram batch with its source extras: the loss,
    the clipped gradient per leaf (encoder and projector included) and
    every weight after the step."""
    from repro_torch.data import make_task

    jcfg, cfg, jp, tp, _ = weights(arch)
    batch = make_task("bigram", cfg.vocab, 32, 2, seed=0).batch_at(0)
    batch.update(extras(cfg, np.random.default_rng(7), 2))
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
    for k in grads:
        assert rel(grads[k], jgrads[k]) < TOL, (k, rel(grads[k], jgrads[k]))
        assert np.abs(after[k] - jafter[k]).max() < 0.1 * LR, k
    src = "encoder" if arch == "whisper-medium" else "vision_proj"
    assert any(src in k and np.abs(g).max() > 0 for k, g in grads.items())


def _serve(eng, prompts, budgets, exs, **kw):
    rids = [eng.submit(Request(tokens=p, max_new_tokens=m, extras=e, **kw) if
                       isinstance(eng, ServeEngine) else
                       JRequest(tokens=p, max_new_tokens=m, extras=e, **kw))
            for p, m, e in zip(prompts, budgets, exs)]
    outs = eng.run()
    return [np.asarray(outs[r]) for r in rids]


@pytest.mark.parametrize("arch,backend,state_dtype",
                         [(a, b, "dense") for a, b in CASES] + [("whisper-medium", "taylor",
                                                                 "int8")],
                         ids=CASE_IDS + ["whisper-int8"])
def test_engine_tokens_equal_the_jax_engine(arch, backend, state_dtype, rng):
    """Five requests, each with its own source, on 2 slots (admission
    groups, slot reuse): the tokens of the JAX engine, and each request's
    tokens equal ``generate``'s and the per-token loop's."""
    jcfg, cfg, jp, tp, _ = weights(arch, backend)
    lens, budgets = [12, 12, 20, 7, 12], [6, 9, 5, 8, 7]
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in lens]
    exs = [extras(cfg, rng, 1) for _ in lens]
    kw = dict(max_slots=2, n_max=64, decode_block=4, state_dtype=state_dtype)
    want = _serve(JServeEngine(jp, jcfg, **kw), prompts, budgets, exs)
    teng = ServeEngine(tp, cfg, device="cpu", **kw)
    got = _serve(teng, prompts, budgets, exs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert teng.stats()["ok"] == len(lens)
    if state_dtype == "dense":
        assert teng.slot_state_bytes == tlm.lm_state_bytes(cfg, 1, 64)
        two = {"tokens": torch.from_numpy(np.stack(prompts[:2]).astype(np.int64)),
               **{k: torch.from_numpy(np.concatenate([exs[0][k], exs[1][k]]))
                  for k in exs[0]}}
        toks = generate(tp, two, cfg, steps=5, device="cpu")
        np.testing.assert_array_equal(toks.numpy(), np.stack([w[:5] for w in want[:2]]))
        from repro_torch.serve import generate_loop

        np.testing.assert_array_equal(generate_loop(tp, two, cfg, steps=5, device="cpu"), toks)


def test_vlm_tokens_depend_on_the_image(rng):
    """tests/test_serve.py's case: two images, other tokens."""
    _, cfg, _, tp, _ = weights("llama-3.2-vision-11b")
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 12)))
    imgs = [torch.from_numpy(extras(cfg, rng, 1)["image_embeds"]) for _ in range(2)]
    t1, t2 = (generate(tp, {"tokens": prompt, "image_embeds": im}, cfg, steps=4, device="cpu")
              for im in imgs)
    assert not torch.equal(t1, t2)


@pytest.mark.parametrize("arch", CROSS)
def test_submit_rejects_bad_extras(arch, rng):
    """A source of the wrong length, or none, is rejected at submit with the
    JAX package's reason and message."""
    jcfg, cfg, jp, tp, _ = weights(arch)
    name, shape = (("image_embeds", (1, cfg.n_image_tokens + 4, cfg.vision_dim))
                   if cfg.family == "vlm" else ("audio_frames", (1, cfg.n_audio_ctx + 4,
                                                                 cfg.d_model)))
    prompt = rng.integers(0, cfg.vocab, (8,)).astype(np.int32)
    eng = ServeEngine(tp, cfg, max_slots=2, n_max=64, device="cpu")
    jeng = JServeEngine(jp, jcfg, max_slots=2, n_max=64)
    for ex in ({name: np.zeros(shape, np.float32)}, {}):
        with pytest.raises(RequestRejected, match=name) as exc:
            eng.submit(Request(tokens=prompt, max_new_tokens=4, extras=ex))
        with pytest.raises(ValueError) as jexc:
            jeng.submit(JRequest(tokens=prompt, max_new_tokens=4, extras=ex))
        assert exc.value.reason == jexc.value.reason == "bad_extras"
        assert str(exc.value) == str(jexc.value)
    assert eng.stats()["rejected"] == 2


def test_int8_store_keeps_the_cross_state_dense(rng):
    """An int8 slot store over whisper: each cross pair's self moments are
    quantised, its ``CrossCache`` and ``kv_src`` stay dense and come back
    bit-identical through write and read."""
    _, cfg, _, tp, _ = weights("whisper-medium")
    store = make_state_store(cfg, 3, 64, device="cpu", state_dtype="int8")
    _, tb, _ = batches(cfg, rng, 1, 20)
    _, one = tlm.lm_prefill(tp, tb, cfg, 64)
    stored = store.write_slot(store.init_caches(), one, 1)
    self_state, cc = stored["group"][0]
    assert type(self_state.s2).__name__ == "QuantizedLeaf"
    assert all(isinstance(x, torch.Tensor) for x in tree_leaves(cc))
    back = store.read_slot(stored, 1)
    for a, b in zip(tree_leaves((back["group"][0][1], back["kv_src"])),
                    tree_leaves((one["group"][0][1], one["kv_src"]))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert store.health(stored).tolist() == [True] * 3


@pytest.mark.parametrize("where", ["cross", "kv_src"])
def test_slot_health_sees_a_poisoned_source_state(where, rng):
    """``slot_health`` ANDs a cross block's self and source states and
    ``kv_src``: NaN in one slot's cross state (or source) flags that slot
    alone; ``corrupt_slot`` poisons every floating leaf of a slot."""
    _, cfg, _, tp, _ = weights("llama-3.2-vision-11b")
    _, tb, _ = batches(cfg, rng, 3, 10)
    _, caches = tlm.lm_prefill(tp, tb, cfg, 32)
    assert slot_health(caches, cfg).tolist() == [True] * 3
    if where == "cross":
        cc = caches["group"][-1][1].kv
        cc.s1[:, :, 1].fill_(float("nan"))  # [n_groups, run_len, slots, ...]
    else:
        caches["kv_src"][1, 3].fill_(float("inf"))
    assert slot_health(caches, cfg).tolist() == [True, False, True]
    _, fresh = tlm.lm_prefill(tp, tb, cfg, 32)
    assert slot_health(corrupt_slot(fresh, 2, float("nan")), cfg).tolist() == [True, True, False]


def test_learned_positions_and_layernorm_units(rng):
    """``pos="learned"`` (no published config uses it): logits and
    prefill + decode of the reduced whisper and VLM against JAX; the
    layernorm and the sinusoidal table against JAX's."""
    x = rng.normal(size=(3, 5, 64)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=64)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=64)).astype(np.float32)}
    got = tlayers.norm_apply({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), "layernorm", 1e-5)
    want = jlayers.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                              "layernorm", 1e-5)
    assert rel(got, want) < TOL
    assert set(tlayers.norm_init(8, "layernorm")) == {"scale", "bias"}
    # up to whisper's source length and past the serving context; far beyond,
    # pos × (one ulp of a frequency, whose exp the two packages round apart)
    # moves the float32 angle past 1e-5 in both packages alike
    pos = np.array([0, 3, 1499, 2047])
    assert rel(tlayers.sinusoidal_pos(torch.from_numpy(pos), 64),
               jlayers.sinusoidal_pos(jnp.asarray(pos), 64)) < TOL
    for arch in CROSS:
        jcfg, cfg, jp, tp, _ = weights(arch, pos="learned")
        assert "pos_embed" in tp and ("pos_embed" in tp.get("encoder", {})) == (
            cfg.family == "encdec")
        jb, tb, t = batches(cfg, rng, 2, 20)
        assert rel(tlm.lm_apply(tp, tb, cfg)[0], jlm.lm_apply(jp, jb, jcfg)[0]) < TOL
        jl, jc = jlm.lm_prefill(jp, prefix(jb, 16), jcfg, 32)
        tl, tc = tlm.lm_prefill(tp, prefix(tb, 16), cfg, 32)
        assert rel(tl, jl) < TOL
        pos = torch.tensor([16, 17])  # a [b] position vector
        jl, jc = jlm.lm_decode_step(jp, jnp.asarray(t[:, 16]), jc, jnp.asarray([16, 17]), jcfg)
        tl, tc = tlm.lm_decode_step(tp, tb["tokens"][:, 16], tc, pos, cfg)
        assert rel(tl, jl) < TOL


def test_vlm_speculative_ngram_request_equals_the_jax_engine(rng):
    """A speculative request (n-gram draft, k = 3) on the reduced VLM, with
    a repetitive prompt so drafts are proposed, co-batched with a plain
    one: both engines serve it, and their tokens are equal, to each other
    and to plain decode's."""
    jcfg, cfg, jp, tp, _ = weights("llama-3.2-vision-11b")
    base = rng.integers(0, cfg.vocab, (6,)).astype(np.int32)
    prompts = [np.tile(base, 3), rng.integers(0, cfg.vocab, (18,)).astype(np.int32)]
    exs = [extras(cfg, rng, 1) for _ in prompts]
    kw = dict(max_slots=2, n_max=64, decode_block=4)
    outs = {}
    for name, make, spec in (
            ("jax", lambda: JServeEngine(jp, jcfg, **kw), True),
            ("port", lambda: ServeEngine(tp, cfg, device="cpu", **kw), True),
            ("plain", lambda: ServeEngine(tp, cfg, device="cpu", **kw), False)):
        eng = make()
        req = Request if name != "jax" else JRequest
        rids = [eng.submit(req(tokens=prompts[0], max_new_tokens=12, extras=exs[0],
                               **(dict(speculative_k=3, draft="ngram") if spec else {}))),
                eng.submit(req(tokens=prompts[1], max_new_tokens=12, extras=exs[1]))]
        res = eng.run()
        outs[name] = [np.asarray(res[r]) for r in rids]
        if name == "port":
            assert eng.stats()["spec_drafted"] > 0
    for a, b, c in zip(outs["port"], outs["jax"], outs["plain"]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_the_kernel_envelope_excludes_cross_models():
    """tests/test_backends.py's whisper cases, held to the JAX package: a
    forced kernel impl on a cross model raises naming "cross" (JAX's
    "pallas", the port's "cuda"), a backend without cross support raises
    naming cross-attention; under "auto" on the card the port picks the
    torch paths for both published configs (head dim 64 and 128, inside
    the kernels' head-dim envelope), as JAX picks XLA."""
    for j_cfg, t_cfg, match in (
            (j_get_reduced("whisper-medium").replace(attn_impl="pallas"),
             get_reduced("whisper-medium").replace(attn_impl="cuda"), "cross"),
            (j_get_reduced("whisper-medium").replace(attention="linear_elu"),
             get_reduced("whisper-medium").replace(attention="linear_elu"), "cross-attention"),
            (j_get_reduced("llama-3.2-vision-11b").replace(attention="softmax_window"),
             get_reduced("llama-3.2-vision-11b").replace(attention="softmax_window"),
             "cross-attention")):
        with pytest.raises(ValueError, match=match):
            j_resolve_backend(j_cfg)
        with pytest.raises(ValueError, match=match):
            resolve_backend(t_cfg)
    taylor = get_backend("taylor")
    for arch in CROSS:
        cfg = get_config(arch)
        assert taylor.resolve_impl(cfg, torch.device("cuda")) == "torch"
        assert taylor.resolve_impl(get_config(arch, attn_impl="cuda"),
                                   torch.device("cuda")) == "cuda"
        with pytest.raises(ValueError, match="cross"):
            resolve_backend(cfg.replace(attn_impl="cuda"))
        resolve_backend(get_config(arch, backend="softmax"))
    with pytest.raises(ValueError, match="cross"):
        get_reduced("whisper-medium").replace(pattern=("cross",), n_groups=1,
                                              attention_schedule={0: "linear_elu"})
