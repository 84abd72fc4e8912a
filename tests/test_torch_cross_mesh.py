"""The cross-attention families and Adafactor on a device mesh, against the
JAX package's single-device functions.

Reduced whisper-medium (the encoder-decoder: an encoder stream of 24
frames, 4 heads) and reduced llama-3.2-vision-11b (the VLM: ``vision_proj``
over 16 image tokens, 4 query heads over 2 kv heads) train on tp 1×2 and on
dp × fsdp 2×1: the loss and every gradient leaf against ``jax.value_and_grad``
of the JAX package's loss on the same batch (``audio_frames`` /
``image_embeds`` included), and two AdamW steps against its train step.
Adafactor trains reduced qwen2-1.5b and reduced whisper-medium two steps on
both meshes against ``repro.optim.adafactor``'s: the params and every
``row``/``col``/``full`` and momentum leaf of the state in the stacked
layout, gathered from the ranks' blocks.  Both packages see the same numpy
weights (JAX ``lm_init`` shapes, biases and norm scales not zero or one)
through ``models/convert.py``.  The sharded ``ServeEngine`` serves both
families on 1×2 and 2×1 (each request with its own source), the VLM with
one kv head on 1×2 (the cross state's "dv" mode) and whisper with int8
moments on 1×2: tokens against the JAX single-device engine, teacher-forced
logits against one device's, each rank's slot-cache bytes against its
share, and ``kv_src`` held by the slot's owner.

The ranks are ``gloo`` processes (one torch thread each, a file store under
the test's temporary directory), one spawn of 2 running every case.
Tolerances (``tests/test_torch_moe_mesh.py``): float32 losses rel 1e-5,
gradients and the state's statistics rel 1e-4 of each leaf's largest,
params after two steps within 1e-2 of the run's update in RMS (the bf16
momentum within 1e-2 of its largest: one bf16 step), teacher-forced logits
rel 1e-4; tokens and a restored checkpoint exact.
"""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_reduced
from repro_torch.data import make_task
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    Placements,
    distribute_tree,
    gather_tree,
    global_shape,
    param_specs,
    whole_template,
)
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.convert import params_from_jax, to_jax_layout
from repro_torch.models.lm import lm_decode_step, lm_prefill
from repro_torch.optim import adafactor, adamw, constant
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import train_state_init
from repro_torch.train.step import make_loss_fn
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten

LR, STEPS, SEQ, BATCH = 1e-3, 2, 32, 4
TOL, GRAD_TOL, PARAM_TOL, LOGIT_TOL = 1e-5, 1e-4, 1e-2, 1e-4
MESHES = ((1, 2), (2, 1))
CROSS = ("whisper-medium", "llama-3.2-vision-11b")
ADAFACTOR = ("qwen2-1.5b", "whisper-medium")
# name -> (arch, config overrides): the weight trees both packages share
MODELS = {"whisper-medium": ("whisper-medium", {}),
          "llama-3.2-vision-11b": ("llama-3.2-vision-11b", {}),
          "qwen2-1.5b": ("qwen2-1.5b", {}),
          "vlm_mqa": ("llama-3.2-vision-11b", dict(n_kv_heads=1))}
# the engines: prompt lengths, budgets, the first two submitted before a step
LENS, BUDGETS, FIRST = (12, 12, 9), (5, 6, 4), 2
ENGINE = dict(max_slots=2, n_max=64, decode_block=3)
LAUNCH = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--optimizer", "adafactor",
          "--steps", "2", "--batch", "4", "--seq", "32", "--log-every", "0"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(name):
    arch, over = MODELS[name]
    return get_reduced(arch, **over)


def _jax_cfg(name):
    from repro.configs import get_reduced as j_get_reduced

    arch, over = MODELS[name]
    return j_get_reduced(arch, **over)


def _jax_tree(name):
    """The JAX ``lm_init`` layout of numpy draws: weights N(0, 1/fan_in),
    biases and position tables N(0, 0.1²), norm scales 1 + N(0, 0.1²)."""
    import jax

    from repro.models import lm_init as j_lm_init

    jcfg = _jax_cfg(name)
    rng = np.random.default_rng(len(name))
    shapes = jax.eval_shape(lambda: j_lm_init(jax.random.PRNGKey(0), jcfg))

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        x = rng.normal(size=s.shape)
        if key.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif key.endswith(("['b']", "['b_up']", "['b_down']", "['bias']", "['pos_embed']")):
            x = 0.1 * x
        else:
            x = x / np.sqrt(s.shape[-2] if len(s.shape) > 1 else jcfg.d_model)
        return x.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _batch(cfg, s):
    """Step ``s``'s batch, numpy: tokens, labels and the family's source."""
    task = make_task("bigram", cfg.vocab, SEQ, BATCH, seed=3)
    out = dict(task.batch_at(s))
    out.update(task.extras_at(s, cfg))
    return out


def _torch_batch(cfg, s):
    return {k: torch.from_numpy(v) for k, v in _batch(cfg, s).items()}


def _stacked(tree, cfg):
    """A whole port param tree (torch) -> {JAX path: numpy} in the stacked layout."""
    np_tree = tree_map(lambda x: x.detach().numpy(), tree)
    return dict(tree_items(to_jax_layout(np_tree, cfg, lambda rows: np.stack(
        [np.stack(r) for r in rows]))))


def _flat(tree):
    import jax

    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------


def _grads(name, jtree, mesh):
    """The loss and the gradients, whole in the stacked layout, of the
    model's loss on step 0's batch inside ``spmd.region``."""
    cfg = _cfg(name)
    rules = dist_api.rules_for_mesh(mesh)
    whole = params_from_jax(jtree, cfg, device="cpu")
    specs = param_specs(whole, mesh, rules)
    pl = Placements(mesh, specs)
    leaves = [p.requires_grad_() for p in tree_leaves(distribute_tree(whole, pl))]
    params = tree_unflatten(whole, leaves)
    batch = _torch_batch(cfg, 0)
    lay = spmd.layout_for(mesh, rules, BATCH, SEQ, cfg.d_model)
    with spmd.region(lay, params, specs):
        loss, _ = make_loss_fn(cfg)(params, spmd.local_batch(batch, lay))
    grads = tree_unflatten(whole, list(torch.autograd.grad(loss, leaves)))
    return float(loss), _stacked(gather_tree(grads, pl), cfg)


def _train(name, jtree, mesh, opt_name):
    """STEPS steps on ``mesh`` from the JAX weights.  Returns (results:
    losses, the params and the optimizer state whole in the stacked layout;
    the state; its placements)."""
    cfg = _cfg(name)
    opt = adamw(constant(LR)) if opt_name == "adamw" else adafactor(constant(LR), cfg=cfg)
    shapes = {k: torch.empty_like(v, device="meta") for k, v in _torch_batch(cfg, 0).items()}
    state, step, pl, _ = launch.make_sharded_state_and_step(
        cfg, opt, mesh, dist_api.rules_for_mesh(mesh), shapes, seed=0, device="cpu")
    pp = Placements(mesh, pl.specs.params)
    local = distribute_tree(params_from_jax(jtree, cfg, device="cpu"), pp)
    state = state._replace(params=local)
    out = {"losses": []}
    if opt_name == "adafactor":  # each stacked leaf's local block and its statistics' shapes
        blocks = dict(tree_items(opt.state_layout(local)))
        rows = dict(tree_items(state.opt_state.v))
        out["blocks"] = {p: (tuple(x.shape), tuple(rows[f"{p}.row"].shape))
                         for p, x in blocks.items()}
    for s in range(STEPS):
        state, m = step(state, _torch_batch(cfg, s))
        out["losses"].append(float(m["loss"]))
    out["params"] = _stacked(gather_tree(state.params, pp), cfg)
    whole = gather_tree(state.opt_state, Placements(mesh, pl.specs.opt_state))
    out["opt"] = {p: x.float().numpy() for p, x in tree_items(whole)}
    return out, state, pl


def _serve(cfg, params, mesh, prompts, exs, **kw):
    """The requests through a port engine (``mesh=None``: one device): the
    tokens, the engine, and ``kv_src`` gathered whole after the first step."""
    eng = ServeEngine(params, cfg, device="cpu", mesh=mesh, **ENGINE, **kw)
    reqs = [Request(tokens=p, max_new_tokens=b, extras=e)
            for p, b, e in zip(prompts, BUDGETS, exs)]
    rids = [eng.submit(r) for r in reqs[:FIRST]]
    eng.step()
    caches = eng.caches if mesh is None else gather_tree(eng.caches, eng.state_store.placements)
    kv_src = caches["kv_src"].numpy().copy()
    rids += [eng.submit(r) for r in reqs[FIRST:]]
    out = eng.run()
    return [out[r].tolist() for r in rids], eng, kv_src


def _share(eng, one):
    """(this rank's slot-cache bytes, its share: each leaf's bytes in the
    one-device engine ``one`` over the ranks that its spec splits it over,
    the one-device bytes)."""
    held = share = 0
    for x, w, spec in zip(tree_leaves(eng.caches), tree_leaves(one.caches),
                          tree_leaves(eng.state_store.placements.specs)):
        assert global_shape(x.shape, spec, eng.mesh) == tuple(w.shape)
        ranks = int(np.prod([dist_api.mesh_axis_size(eng.mesh, e) for e in spec if e]))
        held += x.numel() * x.element_size()
        share += w.numel() * w.element_size() // ranks
    return held, share, one.live_state_bytes


def _requests(cfg, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in LENS]
    key, shape = (("image_embeds", (1, cfg.n_image_tokens, cfg.vision_dim))
                  if cfg.family == "vlm" else ("audio_frames", (1, cfg.n_audio_ctx, cfg.d_model)))
    return prompts, [{key: rng.normal(size=shape).astype(np.float32)} for _ in LENS]


def _teacher(cfg, params, mesh, steps=3):
    """The sharded engine's weights through ``lm_prefill`` (a batch of 2 with
    its sources, whole on every "data" rank) and ``lm_decode_step``,
    teacher-forced, against one device's: the largest max |Δlogits| /
    max |logits| over the steps."""
    eng = ServeEngine(params, cfg, mesh=mesh, device="cpu", **ENGINE)
    prompts, exs = _requests(cfg, 9)
    batch = {"tokens": torch.as_tensor(np.stack(prompts[:2])).long(),
             **{k: torch.from_numpy(np.concatenate([e[k] for e in exs[:2]])) for k in exs[0]}}
    follow = torch.as_tensor(np.random.default_rng(10).integers(0, cfg.vocab, (2, steps)))
    with eng._on_mesh(slotted=False):
        got, caches = lm_prefill(eng.params, batch, cfg, 64)
    want, wcaches = lm_prefill(params, batch, cfg, 64)
    n, worst = batch["tokens"].shape[1], 0.0
    for t in range(steps + 1):
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        if t == steps:
            break
        with eng._on_mesh(slotted=False):
            got, caches = lm_decode_step(eng.params, follow[:, t], caches, n + t, cfg)
        want, wcaches = lm_decode_step(params, follow[:, t], wcaches, n + t, cfg)
    return worst


def _engines(jtrees):
    out = {}
    cases = [(name, shape, {}) for name in CROSS for shape in MESHES]
    cases += [("vlm_mqa", (1, 2), {}), ("whisper-medium", (1, 2), dict(state_dtype="int8"))]
    for name, shape, kw in cases:
        cfg = _cfg(name)
        params = params_from_jax(jtrees[name], cfg, device="cpu")
        prompts, exs = _requests(cfg, 4)
        mesh = make_serve_mesh(*shape, device="cpu")
        toks, eng, kv_src = _serve(cfg, params, mesh, prompts, exs, **kw)
        _, one, kv_src_one = _serve(cfg, params, None, prompts, exs, **kw)
        res = dict(tokens=toks, bytes=_share(eng, one), kv_src=kv_src, kv_src_one=kv_src_one)
        if kw:  # int8: the cross pairs and kv_src stay dense tensors in the store
            _, cross = eng.caches["group"][0]
            res["dense"] = all(isinstance(x, torch.Tensor) and x.is_floating_point()
                               and x.dtype == torch.float32
                               for x in tree_leaves((cross, eng.caches["kv_src"])))
            res["quantised"] = type(eng.caches["group"][0][0].s2).__name__
        else:
            res["teacher"] = _teacher(cfg, params, mesh)
        out[(name, shape, tuple(kw))] = res
    return out


def _bits(x):
    """A leaf's bits as numpy (bf16 momentum as int16)."""
    return (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy()


def _rank(rank, world, jtrees, tmp):
    out = {}
    for shape in MESHES:
        mesh = make_host_mesh(*shape, device="cpu")
        for name in CROSS:
            out[("grads", name, shape)] = _grads(name, jtrees[name], mesh)
            out[("adamw", name, shape)] = _train(name, jtrees[name], mesh, "adamw")[0]
        for name in ADAFACTOR:
            res, state, pl = _train(name, jtrees[name], mesh, "adafactor")
            out[("adafactor", name, shape)] = res
        if shape == (2, 1):  # whisper's sharded Adafactor state, saved and restored whole
            save_checkpoint(f"{tmp}/ada", STEPS, state, placements=pl)
            saved = [_bits(x) for x in tree_leaves(gather_tree(state, pl))]
            back = restore_checkpoint(f"{tmp}/ada", whole_template(state, pl))
            out["ckpt"] = (saved, [_bits(x) for x in tree_leaves(back)])
    launch.main(LAUNCH + ["--mesh-data", "1", "--mesh-model", "2", "--ckpt-dir",
                          f"{tmp}/launcher"])
    out["engines"] = _engines(jtrees)
    return out


# ---------------------------------------------------------------------------
# The JAX references
# ---------------------------------------------------------------------------


def _jax_train(name, jtree, opt_name):
    """The JAX package's train step (its loss, optimizer and
    ``apply_updates``, jitted), STEPS steps from ``jtree``: losses, step 0's
    gradients and loss, the params and the optimizer state."""
    import jax
    import jax.numpy as jnp

    from repro.optim import adafactor as j_adafactor
    from repro.optim import adamw as j_adamw
    from repro.optim import apply_updates as j_apply_updates
    from repro.optim import constant as j_constant
    from repro.train.step import make_loss_fn as j_make_loss_fn

    jcfg = _jax_cfg(name)
    opt = (j_adamw if opt_name == "adamw" else j_adafactor)(j_constant(LR))
    loss_fn = j_make_loss_fn(jcfg)

    @jax.jit
    def step(params, opt_state, batch):
        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params, batch)
        updates, opt_state = opt.update(grads, opt_state, params)
        return j_apply_updates(params, updates), opt_state, metrics["loss"], loss, grads

    params = jax.tree_util.tree_map(jnp.asarray, jtree)
    opt_state = opt.init(params)
    out = {"losses": []}
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in _batch(_cfg(name), s).items()}
        params, opt_state, nll, loss, grads = step(params, opt_state, batch)
        out["losses"].append(float(nll))
        if s == 0:
            out["loss0"], out["grads"] = float(loss), _flat(grads)
    out["params"], out["opt"] = _flat(params), _flat(opt_state)
    return out


def _jax_engine(name, jtree, **kw):
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    eng = JServeEngine(jtree, _jax_cfg(name), **ENGINE, **kw)
    prompts, exs = _requests(_cfg(name), 4)
    reqs = [JRequest(tokens=p, max_new_tokens=b, extras=e)
            for p, b, e in zip(prompts, BUDGETS, exs)]
    rids = [eng.submit(r) for r in reqs[:FIRST]]
    eng.step()
    rids += [eng.submit(r) for r in reqs[FIRST:]]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, the 1×1 launcher run, then the spawn."""
    tmp = tmp_path_factory.mktemp("cross_mesh")
    jtrees = {name: _jax_tree(name) for name in MODELS}
    jax_train = {("adamw", name): _jax_train(name, jtrees[name], "adamw") for name in CROSS}
    jax_train.update({("adafactor", name): _jax_train(name, jtrees[name], "adafactor")
                      for name in ADAFACTOR})
    jax_engine = {(name, ()): _jax_engine(name, jtrees[name]) for name in CROSS + ("vlm_mqa",)}
    jax_engine[("whisper-medium", ("state_dtype",))] = _jax_engine(
        "whisper-medium", jtrees["whisper-medium"], state_dtype="int8")
    single = launch.main(LAUNCH)
    ranks = run_ranks(_rank, 2, backend="gloo", init_file=str(tmp / "store"),
                      args=(jtrees, str(tmp)))
    return dict(tmp=tmp, jax_train=jax_train, jax_engine=jax_engine, launcher=single,
                ranks=ranks, jtrees=jtrees)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


def _assert_params(got, want, init):
    """Each leaf within PARAM_TOL of the reference run's update, in RMS."""
    assert got.keys() == want.keys()
    for path in want:
        du = np.sqrt(np.mean((got[path] - want[path]) ** 2))
        u = np.sqrt(np.mean((want[path] - init[path]) ** 2))
        assert du <= PARAM_TOL * max(u, 1e-12), (path, du, u)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("name", CROSS)
def test_cross_family_loss_and_gradients_equal_jax_grad(runs, name, shape):
    """Step 0's loss and every gradient leaf (the encoder's or the
    projector's, the cross blocks') against ``jax.value_and_grad`` of the
    JAX loss on the same batch and source."""
    want = runs["jax_train"][("adamw", name)]
    for rk in runs["ranks"]:
        loss, grads = rk[("grads", name, shape)]
        assert abs(loss - want["loss0"]) <= TOL * abs(want["loss0"]), (loss, want["loss0"])
        assert grads.keys() == want["grads"].keys()
        for path, g in grads.items():
            assert _rel(g, want["grads"][path]) < GRAD_TOL, (path, _rel(g, want["grads"][path]))


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("name", CROSS)
def test_cross_family_adamw_steps_equal_the_jax_train_step(runs, name, shape):
    want = runs["jax_train"][("adamw", name)]
    init = _flat(runs["jtrees"][name])
    for rk in runs["ranks"]:
        got = rk[("adamw", name, shape)]
        assert all(abs(a - b) <= TOL * abs(b) for a, b in zip(got["losses"], want["losses"])), (
            got["losses"], want["losses"])
        _assert_params(got["params"], want["params"], init)


@pytest.mark.parametrize("leaf", ["['vision_proj']['w']",
                                  "['encoder']['group']['r0']['attn']['wk']['w']",
                                  "['encoder']['group']['r0']['mlp']['w_up']"])
def test_the_sources_gradient_is_summed_over_the_heads(runs, leaf):
    """On 1×2 each rank projects the source with its own heads only; the
    cross site sums the source's cotangent over "tp", so ``vision_proj``'s
    and the encoder's gradients are whole (one rank's share without it)."""
    name = "llama-3.2-vision-11b" if "vision" in leaf else "whisper-medium"
    want = runs["jax_train"][("adamw", name)]["grads"][leaf]
    for rk in runs["ranks"]:
        got = rk[("grads", name, (1, 2))][1][leaf]
        assert _rel(got, want) < GRAD_TOL, _rel(got, want)


@pytest.mark.parametrize("shape", MESHES, ids=["1x2", "2x1"])
@pytest.mark.parametrize("name", ADAFACTOR)
def test_adafactor_on_a_mesh_equals_the_jax_single_device_step(runs, name, shape):
    """Params after two steps, and every row/col/full statistic (rel 1e-4)
    and bf16 momentum leaf (one bf16 step) of the stacked state, gathered
    from the ranks' blocks."""
    want = runs["jax_train"][("adafactor", name)]
    _assert_params(runs["ranks"][0][("adafactor", name, shape)]["params"], want["params"],
                   _flat(runs["jtrees"][name]))
    for rk in runs["ranks"]:
        got = rk[("adafactor", name, shape)]
        assert all(abs(a - b) <= TOL * abs(b) for a, b in zip(got["losses"], want["losses"]))
        assert got["opt"].keys() == want["opt"].keys()
        for path, x in got["opt"].items():
            ref = want["opt"][path].astype(np.float32)
            assert x.shape == ref.shape, path
            tol = PARAM_TOL if path.startswith(".m") else GRAD_TOL
            assert _rel(x, ref) < tol or np.abs(ref).max() == 0, (path, _rel(x, ref))


def test_a_local_block_with_a_dim_of_1_keeps_row_and_col(runs):
    """Reduced qwen2-1.5b's 2 kv heads split over 1×2 leave each rank a
    block with a kv-head dim of 1; its statistics still factor as the whole
    leaf's do (``row`` is the block of ``[G, R, d, hk]``, not a placeholder)."""
    blocks = runs["ranks"][0][("adafactor", "qwen2-1.5b", (1, 2))]["blocks"]
    thin = {p: v for p, v in blocks.items() if 1 in v[0][-2:] and len(v[0]) >= 4}
    assert any("['wk']['w']" in p for p in thin), sorted(thin)
    for path, (block, row) in thin.items():
        assert row == block[:-1], (path, block, row)


def test_the_launcher_runs_adafactor_on_a_mesh(runs):
    """``--optimizer adafactor --mesh-model 2`` checkpoints the state the
    1×1 launcher reaches."""
    cfg = get_reduced("qwen2-1.5b")
    template = train_state_init(torch.Generator().manual_seed(1), cfg,
                                adafactor(constant(LR), cfg=cfg), device="cpu")
    sharded = restore_checkpoint(str(runs["tmp"] / "launcher"), template)
    single = runs["launcher"]
    assert int(sharded.step) == int(single.step) == 2
    for (key, a), b in zip(tree_items(sharded.params), tree_leaves(single.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=key)
    for (key, a), b in zip(tree_items(sharded.opt_state.v), tree_leaves(single.opt_state.v)):
        assert _rel(a.numpy(), b.numpy()) < GRAD_TOL or not b.abs().max(), key


def test_a_sharded_adafactor_state_restores_whole_bit_for_bit(runs):
    saved, back = runs["ranks"][0]["ckpt"]
    assert len(saved) == len(back)
    for a, b in zip(saved, back):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

ENGINE_CASES = [(name, shape, ()) for name in CROSS for shape in MESHES] + [
    ("vlm_mqa", (1, 2), ()), ("whisper-medium", (1, 2), ("state_dtype",))]


@pytest.mark.parametrize("name,shape,kw", ENGINE_CASES,
                         ids=["whisper-1x2", "whisper-2x1", "vlm-1x2", "vlm-2x1", "vlm-dv-1x2",
                              "whisper-int8-1x2"])
def test_sharded_cross_engine_equals_the_jax_single_device_engine(runs, name, shape, kw):
    """Every rank's tokens are the JAX engine's; each rank holds its share
    of the slot cache and the one-device bytes in all; after admission the
    slots' owners hold their requests' ``kv_src`` rows."""
    want = runs["jax_engine"][(name, kw)]
    for rk in runs["ranks"]:
        res = rk["engines"][(name, shape, kw)]
        assert res["tokens"] == want
        held, share, whole = res["bytes"]
        assert held == share and held < whole
        assert _rel(res["kv_src"], res["kv_src_one"]) < TOL
    wholes = {rk["engines"][(name, shape, kw)]["bytes"][2] for rk in runs["ranks"]}
    assert len(wholes) == 1


@pytest.mark.parametrize("name,shape", [(n, s) for n in CROSS for s in MESHES] +
                         [("vlm_mqa", (1, 2))],
                         ids=["whisper-1x2", "whisper-2x1", "vlm-1x2", "vlm-2x1", "vlm-dv-1x2"])
def test_teacher_forced_logits_on_a_mesh_equal_one_devices(runs, name, shape):
    """Degenerate greedy tokens hide mesh faults, so the logits of a
    teacher-forced prefill and decode answer too (the "dv" cross state's
    gathered key moments included)."""
    for rk in runs["ranks"]:
        assert rk["engines"][(name, shape, ())]["teacher"] < LOGIT_TOL


def test_an_int8_store_on_a_mesh_keeps_the_cross_state_dense(runs):
    for rk in runs["ranks"]:
        res = rk["engines"][("whisper-medium", (1, 2), ("state_dtype",))]
        assert res["dense"] and res["quantised"] == "QuantizedLeaf"
