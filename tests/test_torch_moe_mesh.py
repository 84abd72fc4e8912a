"""MoE on a device mesh: the port's ``ep_a2a`` expert parallelism, and MoE
blocks in sharded training and in the sharded serve engine, against the
JAX package.

The layer: the JAX package's ``_moe_ep_a2a`` runs as
``tests/test_perf_features.py::test_int8_a2a_moe_close_to_exact`` runs it
(a subprocess with forced host devices, jit under the mesh and
``sharding_rules``) on (2, 2) and (1, 4) meshes; the same numpy inputs and
weights go through the port's ``moe_apply`` inside ``spmd.region`` on 4
``gloo`` ranks (one torch thread each), and through the one-device
``_moe_ep_a2a_plain`` here.  Cases: reduced qwen2-moe's 6 experts (padded
to 8 on the 1×4 mesh) at capacity 1.25, where pairs drop; the int8
payload; kimi-k2's d_model 7168 at top-8 with narrow experts, whose ~1116
token chunk target gives 2 chunks a shard.  Tolerances: y and aux within
1e-5 of the reference's largest value (float32), gradients of ``Σ y·R + 3
aux`` within 1e-4 of each leaf's largest; with the int8 payload y within
one quantisation step of each token's row (its largest value / 127) and
the gradients within 1e-3 (XLA multiplies by 1/127 where the source
divides by 127: a payload element may round the other way).
``"dense"`` and ``"ep"`` on 2×2 give the JAX single-device function
(global capacity, the aux from global means) within 1e-5; under
``sharding_rules`` alone ``"auto"`` computes the mesh's function whole.

Whole models: reduced qwen2-moe and kimi-k2 with ``"dense"`` and ``"ep"``
train 3 steps on 2×2 within 2e-3 of a jitted single-device
``repro.train.make_train_step`` (the reference's own bound); ``"ep_a2a"``
on 1×2, 2×1 and 2×2 equals the port's one-device run whose MoE layers compute
``_moe_ep_a2a_plain`` at the mesh's sizes (losses within 1e-5, each
param leaf within 1e-2 of the run's update in RMS); engines on 1×2, 2×1
and 2×2 at a capacity where nothing drops give the JAX single-device
engine's tokens, teacher-forced logits within 1e-5 of one device's and a
rank's share of the slot-cache bytes.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.data import make_task
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import collectives as col
from repro_torch.distributed import spmd
from repro_torch.distributed.api import P
from repro_torch.distributed.sharding import (
    Placements,
    block_of,
    distribute_tree,
    gather_leaf,
    gather_tree,
    param_specs,
)
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import moe
from repro_torch.models.config import MoEConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import mlp_apply
from repro_torch.models.lm import lm_decode_step, lm_prefill
from repro_torch.optim import adamw, constant
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------

QWEN_MOE = dict(n_experts=6, top_k=2, d_ff_expert=32)
# name -> (mesh (data, model), MoEConfig fields, d_model, x's (b, n))
LAYER = {
    "qwen_2x2": ((2, 2), QWEN_MOE, 64, (4, 64)),
    "qwen_1x4": ((1, 4), QWEN_MOE, 64, (4, 64)),            # 6 experts padded to 8
    "int8_2x2": ((2, 2), dict(QWEN_MOE, a2a_quant="int8"), 64, (4, 64)),
    "kimi_2x2": ((2, 2), dict(n_experts=16, top_k=8, d_ff_expert=8), 7168, (2, 1152)),
}
AUX_W = 3.0  # the aux loss's weight in the layer's test loss
TOL, GRAD_TOL = 1e-5, 1e-4
# XLA folds the scale's ``/ 127.0`` into a multiply by the reciprocal, so a
# reference scale may sit an ulp from the port's (an exact division) and a
# payload element on a rounding boundary round the other way: one int8 step
# in an expert's input moves the gradients by ~1e-4 of their largest
INT8_GRAD_TOL = 1e-3
EXPERT_KEYS = ("w_gate", "w_up", "w_down")


def _layer_arrays(name):
    """The case's numpy inputs: x, the cotangent R, router and experts."""
    _, mk, d, (b, n) = LAYER[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    e, f = mk["n_experts"], mk["d_ff_expert"]
    f32 = lambda *s, scale=1.0: (rng.normal(size=s) * scale).astype(np.float32)  # noqa: E731
    router = f32(d, e, scale=d ** -0.5)
    router[:, 0] *= 4  # expert 0's logits spread widest: it is picked most, and overflows
    return {"x": f32(b, n, d), "R": f32(b, n, d), "router": router,
            "w_gate": f32(e, d, f, scale=d ** -0.5), "w_up": f32(e, d, f, scale=d ** -0.5),
            "w_down": f32(e, f, d, scale=f ** -0.5)}


def _layer_cfg(name, impl="ep_a2a"):
    _, mk, d, _ = LAYER[name]
    return get_reduced("qwen2-moe-a2.7b").replace(
        d_model=d, moe=MoEConfig(**mk, capacity_factor=1.25, impl=impl))


def _routed(arrays):
    return {"router": {"w": torch.from_numpy(arrays["router"])},
            "experts": {k: torch.from_numpy(arrays[k]) for k in EXPERT_KEYS}}


JAX_LAYER = textwrap.dedent("""
    import json, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.models.config import MoEConfig
    from repro.models import moe as moe_mod
    from repro.distributed import api as dist

    spec, src, dst = json.loads(sys.argv[1]), np.load(sys.argv[2]), sys.argv[3]
    out = {}
    for name, (shape, mk, d) in spec.items():
        a = {k.split("/", 1)[1]: src[k] for k in src.files if k.startswith(name + "/")}
        cfg = get_reduced("qwen2-moe-a2.7b").replace(
            d_model=d, moe=MoEConfig(**mk, capacity_factor=1.25, impl="ep_a2a"))
        params = {"router": {"w": jnp.asarray(a["router"])},
                  "experts": {k: jnp.asarray(a[k]) for k in ("w_gate", "w_up", "w_down")}}
        x, r = jnp.asarray(a["x"]), jnp.asarray(a["R"])

        def loss(p, x):
            y, aux = moe_mod.moe_apply(p, x, cfg)
            return jnp.sum(y * r) + 3.0 * aux, (y, aux)

        mesh = jax.make_mesh(tuple(shape), ("data", "model"))
        with mesh:
            with dist.sharding_rules(mesh, dist.rules_for_mesh(mesh)):
                (_, (y, aux)), (gp, gx) = jax.jit(
                    jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, x)
        out[name + "/y"], out[name + "/aux"], out[name + "/x"] = y, aux, gx
        out[name + "/router"] = gp["router"]["w"]
        for k, g in gp["experts"].items():
            out[name + "/" + k] = g
    np.savez(dst, **{k: np.asarray(v) for k, v in out.items()})
    print("JAX_LAYER_OK")
""")


def _jax_layers(tmp):
    """The JAX package's ``_moe_ep_a2a`` on each case's mesh, in a subprocess
    of 4 forced host devices (the JAX package's mesh tests' way)."""
    arrays = {f"{name}/{k}": v for name in LAYER for k, v in _layer_arrays(name).items()}
    np.savez(tmp / "layer_in.npz", **arrays)
    spec = {name: (shape, mk, d) for name, (shape, mk, d, _) in LAYER.items()}
    env = {"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin:/usr/local/bin",
           "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", JAX_LAYER, json.dumps(spec),
                          str(tmp / "layer_in.npz"), str(tmp / "layer_ref.npz")],
                         capture_output=True, text=True, timeout=600, env=env, cwd=str(ROOT))
    assert out.returncode == 0 and "JAX_LAYER_OK" in out.stdout, out.stderr[-3000:]
    ref = np.load(tmp / "layer_ref.npz")
    return {name: {k.split("/", 1)[1]: ref[k] for k in ref.files if k.startswith(name + "/")}
            for name in LAYER}


def _loss_grads(fn, arrays):
    """``fn(routed params, x) -> (y, aux)`` on one device: y, aux and the
    gradients of ``Σ y·R + AUX_W·aux`` as numpy."""
    routed = _routed(arrays)
    leaves = [p.requires_grad_() for p in tree_leaves(routed)]
    x = torch.from_numpy(arrays["x"]).requires_grad_()
    y, aux = fn(tree_unflatten(routed, leaves), x)
    loss = (y * torch.from_numpy(arrays["R"])).sum() + AUX_W * aux
    grads = torch.autograd.grad(loss, leaves + [x])
    g = tree_unflatten(routed, list(grads[:-1]))
    out = {"y": y.detach().numpy(), "aux": aux.detach().numpy(), "x": grads[-1].numpy(),
           "router": g["router"]["w"].numpy()}
    out.update({k: v.numpy() for k, v in g["experts"].items()})
    return out


def _layer_on_mesh(name, impl, shape):
    """The case through ``moe_apply`` inside ``spmd.region`` on this rank's
    blocks (the params cut by ``param_specs``, x and R by the residual
    stream's layout); returns y, aux and the gradients, gathered whole."""
    mesh = make_host_mesh(*shape, device="cpu")
    rules = dist_api.rules_for_mesh(mesh)
    arrays = _layer_arrays(name)
    cfg = _layer_cfg(name, impl)
    tree = {"moe": _routed(arrays)}
    specs = param_specs(tree, mesh, rules)
    blocks = distribute_tree(tree, Placements(mesh, specs))
    leaves = [p.requires_grad_() for p in tree_leaves(blocks)]
    blocks = tree_unflatten(blocks, leaves)
    b, n, d = arrays["x"].shape
    lay = spmd.layout_for(mesh, rules, b, n, d)
    stream = P(lay.dp, lay.sp, None)
    x = block_of(torch.from_numpy(arrays["x"]), stream, mesh).contiguous().requires_grad_()
    r = block_of(torch.from_numpy(arrays["R"]), stream, mesh)
    with spmd.region(lay, blocks, specs):
        y, aux = moe.moe_apply(blocks["moe"], x, cfg)
        loss = (y * r).sum()
        for axis in lay.dp_names + ((lay.sp,) if lay.sp else ()):
            loss = col.all_reduce(loss, mesh, axis)
        loss = loss + AUX_W * aux
    grads = torch.autograd.grad(loss, leaves + [x])
    whole = gather_tree(tree_unflatten(blocks, list(grads[:-1])), Placements(mesh, specs))
    out = {"y": gather_leaf(y.detach(), stream, mesh).numpy(), "aux": aux.detach().numpy(),
           "x": gather_leaf(grads[-1], stream, mesh).numpy(),
           "router": whole["moe"]["router"]["w"].numpy()}
    out.update({k: v.numpy() for k, v in whole["moe"]["experts"].items()})
    return out


def _dropped(name, dp, ep):
    """(routed pairs dropped at the capacity, chunks a shard) of the case
    at the mesh's sizes."""
    arrays, cfg = _layer_arrays(name), _layer_cfg(name)
    x = torch.from_numpy(arrays["x"])
    b, n, d = x.shape
    return (moe.ep_a2a_drops(_routed(arrays), x, cfg, dp, ep)[0],
            moe._ep_plan(cfg.moe, (b // dp) * n, d, ep)[1])


# ---------------------------------------------------------------------------
# Whole models
# ---------------------------------------------------------------------------

LR, STEPS = 1e-3, 3
SEQ, BATCH = 32, 8
NO_DROP = 8.0  # a capacity factor at which no routed pair drops (cap > tokens)
PARAM_TOL = 1e-2


def _moe_cfg(arch, **moe_kw):
    cfg = get_reduced(arch)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))


def _batch(cfg, s):
    task = make_task("bigram", cfg.vocab, SEQ, BATCH, seed=3)
    return {k: torch.from_numpy(v) for k, v in task.batch_at(s).items()}


def _train_mesh(arch, jparams, mesh, **moe_kw):
    """STEPS AdamW steps on ``mesh`` from the JAX weights: losses and the
    params' whole leaves."""
    cfg = _moe_cfg(arch, **moe_kw)
    rules = dist_api.rules_for_mesh(mesh)
    shapes = {k: torch.empty_like(v, device="meta") for k, v in _batch(cfg, 0).items()}
    state, step, placements, _ = launch.make_sharded_state_and_step(
        cfg, adamw(constant(LR)), mesh, rules, shapes, seed=0, device="cpu")
    pl = Placements(mesh, placements.specs.params)
    state = state._replace(params=distribute_tree(params_from_jax(jparams, cfg, device="cpu"),
                                                  pl))
    losses = []
    for s in range(STEPS):
        state, m = step(state, _batch(cfg, s))
        losses.append(float(m["loss"]))
    return losses, [x.numpy() for x in tree_leaves(gather_tree(state.params, pl))]


def _plain_moe(dp, ep):
    """``moe_apply`` with its routed experts through ``_moe_ep_a2a_plain``."""
    def apply(params, x, cfg):
        routed = {"router": params["router"], "experts": params["experts"]}
        y, aux = moe._moe_ep_a2a_plain(routed, x, cfg, dp, ep)
        if cfg.moe.n_shared_experts:
            y = y + mlp_apply(params["shared"], x, cfg.act)
        return y, aux
    return apply


def _train_plain(arch, jparams, dp, ep, monkeypatch):
    """The port's one-device run whose MoE layers compute the mesh's
    function (``_moe_ep_a2a_plain`` at dp × ep)."""
    cfg = _moe_cfg(arch, impl="ep_a2a")
    from repro_torch.train import TrainState

    opt = adamw(constant(LR))
    params = params_from_jax(jparams, cfg, device="cpu")
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    step = make_train_step(cfg, opt)
    losses = []
    with monkeypatch.context() as mp_:
        mp_.setattr(moe, "moe_apply", _plain_moe(dp, ep))
        for s in range(STEPS):
            state, m = step(state, _batch(cfg, s))
            losses.append(float(m["loss"]))
    return losses, [x.numpy() for x in tree_leaves(state.params)]


def _jax_train(arch, impl):
    """(JAX weights as numpy, the jitted single-device step's losses)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as j_get_reduced
    from repro.optim import adamw as j_adamw
    from repro.optim import constant as j_constant
    from repro.train import make_train_step as j_make_train_step
    from repro.train import train_state_init as j_train_state_init

    jcfg = j_get_reduced(arch)
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, impl=impl))
    opt = j_adamw(j_constant(LR))
    state = j_train_state_init(jax.random.PRNGKey(0), jcfg, opt)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    step = jax.jit(j_make_train_step(jcfg, opt))
    losses = []
    cfg = _moe_cfg(arch)
    for s in range(STEPS):
        state, m = step(state, {k: jnp.asarray(v.numpy()) for k, v in _batch(cfg, s).items()})
        losses.append(float(m["loss"]))
    return params, losses


# The engines' requests: (prompt lengths, budgets), the first two submitted
# before the first step
LENS, BUDGETS, FIRST = (16, 9, 21), (6, 9, 5), 2
ENGINE = dict(max_slots=2, n_max=64, decode_block=3)


def _prompts(cfg):
    rng = np.random.default_rng(4)
    return [rng.integers(0, cfg.vocab, (n,)).astype(np.int32) for n in LENS]


def _serve_cfg():
    return _moe_cfg("qwen2-moe-a2.7b", impl="auto", capacity_factor=NO_DROP)


def _serve(params, mesh):
    cfg = _serve_cfg()
    eng = ServeEngine(params, cfg, device="cpu", mesh=mesh, **ENGINE)
    reqs = [Request(tokens=p, max_new_tokens=b) for p, b in zip(_prompts(cfg), BUDGETS)]
    rids = [eng.submit(r) for r in reqs[:FIRST]]
    eng.step()
    rids += [eng.submit(r) for r in reqs[FIRST:]]
    out = eng.run()
    return [out[r].tolist() for r in rids], eng


def _teacher(params, mesh, steps=4):
    """The sharded engine's weights through ``lm_prefill`` and
    ``lm_decode_step`` (a batch of 2, whole on every "data" rank) against
    one device's: the largest of max |Δlogits| / max |logits|."""
    cfg = _serve_cfg()
    eng = ServeEngine(params, cfg, mesh=mesh, device="cpu", **ENGINE)
    rng = np.random.default_rng(9)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 12))).long()
    follow = torch.as_tensor(rng.integers(0, cfg.vocab, (2, steps))).long()
    with eng._on_mesh(slotted=False):
        got, caches = lm_prefill(eng.params, {"tokens": toks}, cfg, 64)
    want, wcaches = lm_prefill(params, {"tokens": toks}, cfg, 64)
    worst = 0.0
    for t in range(steps + 1):
        worst = max(worst, float((got - want).abs().max() / want.abs().max()))
        if t == steps:
            break
        with eng._on_mesh(slotted=False):
            got, caches = lm_decode_step(eng.params, follow[:, t], caches, 12 + t, cfg)
        want, wcaches = lm_decode_step(params, follow[:, t], wcaches, 12 + t, cfg)
    return worst


def _engine_case(jparams, shape):
    params = params_from_jax(jparams, _serve_cfg(), device="cpu")
    mesh = make_serve_mesh(*shape, device="cpu")
    toks, eng = _serve(params, mesh)
    return dict(tokens=toks, bytes=eng.live_state_bytes, teacher=_teacher(params, mesh))


# ---------------------------------------------------------------------------
# The spawns
# ---------------------------------------------------------------------------


def _four(rank, world, tmp, jparams):
    for name, (shape, *_) in LAYER.items():
        out = _layer_on_mesh(name, "ep_a2a", shape)
        if rank == 0:
            np.savez(f"{tmp}/port_{name}.npz", **out)
    for impl in ("dense", "ep"):
        out = _layer_on_mesh("qwen_2x2", impl, (2, 2))
        if rank == 0:
            np.savez(f"{tmp}/port_{impl}.npz", **out)
    mesh = make_host_mesh(2, 2, device="cpu")
    res = {"train": {}}
    for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b"):
        for impl in ("dense", "ep"):
            res["train"][(arch, impl)] = _train_mesh(arch, jparams[arch], mesh, impl=impl)
        res["train"][(arch, "ep_a2a")] = _train_mesh(arch, jparams[arch], mesh, impl="ep_a2a")
    res["engine"] = _engine_case(jparams["qwen2-moe-a2.7b"], (2, 2))
    return res


def _two(rank, world, jparams):
    res = {"train": {(arch, shape): _train_mesh(arch, jparams[arch],
                                                make_host_mesh(*shape, device="cpu"),
                                                impl="ep_a2a")
                     for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b")
                     for shape in ((1, 2), (2, 1))}}
    res["engine"] = {shape: _engine_case(jparams["qwen2-moe-a2.7b"], shape)
                     for shape in ((1, 2), (2, 1))}
    return res


def _jax_engine(jparams):
    from repro.configs import get_reduced as j_get_reduced
    from repro.serve import Request as JRequest
    from repro.serve import ServeEngine as JServeEngine

    jcfg = j_get_reduced("qwen2-moe-a2.7b")
    jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, capacity_factor=NO_DROP))
    eng = JServeEngine(jparams, jcfg, **ENGINE)
    reqs = [JRequest(tokens=p, max_new_tokens=b) for p, b in zip(_prompts(_serve_cfg()),
                                                                 BUDGETS)]
    rids = [eng.submit(r) for r in reqs[:FIRST]]
    eng.step()
    rids += [eng.submit(r) for r in reqs[FIRST:]]
    out = eng.run()
    return [np.asarray(out[r]).tolist() for r in rids]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references (the layer on its meshes in a subprocess, the
    single-device trainers and engine here), the port's one-device runs and
    both spawns."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    layer_ref = _jax_layers(tmp)
    jax_train, jparams = {}, {}
    for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b"):
        for impl in ("dense", "ep"):
            jparams[arch], jax_train[(arch, impl)] = _jax_train(arch, impl)
    four = run_ranks(_four, 4, backend="gloo", init_file=str(tmp / "store4"),
                     args=(str(tmp), jparams))
    two = run_ranks(_two, 2, backend="gloo", init_file=str(tmp / "store2"), args=(jparams,))
    port = {name: dict(np.load(tmp / f"port_{name}.npz")) for name in list(LAYER) +
            ["dense", "ep"]}
    return dict(layer_ref=layer_ref, port=port, jax_train=jax_train, jparams=jparams,
                jax_engine=_jax_engine(jparams["qwen2-moe-a2.7b"]), four=four, two=two)


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / max(np.abs(b).max(), 1e-30))


def _assert_layer(got, ref, int8=False):
    if int8:  # one quantisation step of the token's row
        step = np.abs(ref["y"]).max(axis=-1, keepdims=True) / 127.0
        assert (np.abs(got["y"] - ref["y"]) <= step + TOL).all()
    else:
        assert _rel(got["y"], ref["y"]) < TOL
    assert _rel(got["aux"], ref["aux"]) < TOL
    for k in ("x", "router") + EXPERT_KEYS:
        tol = INT8_GRAD_TOL if int8 else GRAD_TOL
        assert _rel(got[k], ref[k]) < tol, (k, _rel(got[k], ref[k]))


def test_sort_positions_equal_the_jax_packages():
    """Positions by a stable argsort and an exclusive prefix, with an expert
    count above the routed ones (``e_pad > E``) and empty experts."""
    import jax.numpy as jnp

    from repro.models import moe as j_moe

    rng = np.random.default_rng(0)
    for e, e_pad, t in ((6, 8, 40), (60, 64, 512), (5, 5, 7)):
        e_flat = rng.integers(0, e, (t,)).astype(np.int32)
        want = np.asarray(j_moe._sort_positions(jnp.asarray(e_flat), e_pad))
        got = moe._sort_positions(torch.from_numpy(e_flat).long(), e_pad)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("name", list(LAYER))
def test_ep_a2a_on_a_mesh_equals_the_jax_packages(runs, name):
    """The port's ``_moe_ep_a2a`` on 4 ranks against the reference's on the
    same mesh: where pairs drop at capacity 1.25, padded experts on 1×4,
    two chunks at kimi-k2's width, the int8 payload."""
    (dp, ep), *_ = LAYER[name]
    drops, chunks = _dropped(name, dp, ep)
    if name.startswith("kimi"):
        assert chunks >= 2
    else:
        assert drops > 0
    _assert_layer(runs["port"][name], runs["layer_ref"][name], int8=name.startswith("int8"))


@pytest.mark.parametrize("name", list(LAYER))
def test_ep_a2a_plain_equals_the_jax_packages(runs, name):
    """``_moe_ep_a2a_plain`` (one device, no collectives) at the mesh's dp ×
    ep against the reference's ``_moe_ep_a2a`` on that mesh."""
    (dp, ep), *_ = LAYER[name]
    cfg = _layer_cfg(name)
    got = _loss_grads(lambda p, x: moe._moe_ep_a2a_plain(p, x, cfg, dp, ep),
                      _layer_arrays(name))
    _assert_layer(got, runs["layer_ref"][name], int8=name.startswith("int8"))


@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_dense_and_ep_on_a_mesh_give_the_single_device_numbers(runs, impl):
    """On 2×2 "dense" is exact over the global batch and its aux comes from
    global means; "ep" takes capacity and positions over the global batch:
    both equal the JAX single-device function."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as j_get_reduced
    from repro.models import moe as j_moe
    from repro.models.config import MoEConfig as JMoEConfig

    arrays = _layer_arrays("qwen_2x2")
    jcfg = j_get_reduced("qwen2-moe-a2.7b").replace(
        moe=JMoEConfig(**QWEN_MOE, capacity_factor=1.25, impl=impl))
    jp = {"router": {"w": jnp.asarray(arrays["router"])},
          "experts": {k: jnp.asarray(arrays[k]) for k in EXPERT_KEYS}}

    def loss(p, x):
        y, aux = j_moe.moe_apply(p, x, jcfg)
        return jnp.sum(y * arrays["R"]) + AUX_W * aux, (y, aux)

    (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jp, jnp.asarray(arrays["x"]))
    ref = {"y": y, "aux": aux, "x": gx, "router": gp["router"]["w"], **gp["experts"]}
    got = runs["port"][impl]
    assert _rel(got["y"], ref["y"]) < TOL and _rel(got["aux"], ref["aux"]) < TOL
    for k in ("x", "router") + EXPERT_KEYS:
        assert _rel(got[k], ref[k]) < GRAD_TOL, k


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("impl", ["dense", "ep"])
def test_moe_models_train_on_2x2_as_the_jax_single_device_step(runs, arch, impl):
    want = runs["jax_train"][(arch, impl)]
    for rk in runs["four"]:
        losses, _ = rk["train"][(arch, impl)]
        assert all(abs(a - b) < 2e-3 for a, b in zip(losses, want)), (losses, want)
    assert all(rk["train"][(arch, impl)][0] == runs["four"][0]["train"][(arch, impl)][0]
               for rk in runs["four"])


def _rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(x, dtype=np.float64))))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2"])
def test_ep_a2a_training_equals_the_one_device_plain_run(runs, arch, shape, monkeypatch):
    """Losses within 1e-5; each param leaf's RMS distance from the plain
    run's within PARAM_TOL of the RMS of that run's update: AdamW moves an
    element by ~lr whatever its gradient's size, so rounding flips the few
    elements whose gradient is near 0 (``chip_smoke.py``'s
    ``DIST_PARAM_TOL`` rule).  On 2×1 the ep axis has one rank: the global
    capacity path, the plain version at (2, 1)."""
    dp, ep = (int(s) for s in shape.split("x"))
    want_losses, want_params = _train_plain(arch, runs["jparams"][arch], dp, ep, monkeypatch)
    init = [x.numpy() for x in tree_leaves(params_from_jax(runs["jparams"][arch],
                                                           _moe_cfg(arch), device="cpu"))]
    ranks = runs["four"] if shape == "2x2" else runs["two"]
    for rk in ranks:
        losses, params = (rk["train"][(arch, "ep_a2a")] if shape == "2x2"
                          else rk["train"][(arch, (dp, ep))])
        assert all(abs(a - b) < 1e-5 for a, b in zip(losses, want_losses)), (losses,
                                                                             want_losses)
        for a, b, i in zip(params, want_params, init):
            assert _rms(a - b) <= PARAM_TOL * _rms(b - i)


@pytest.mark.parametrize("shape", ["1x2", "2x1", "2x2"])
def test_moe_engine_on_a_mesh_equals_the_jax_single_device_engine(runs, shape):
    """Reduced qwen2-moe with ``impl="auto"`` (``ep_a2a`` on the mesh; on
    2×1 the ep axis has one rank: the global capacity path) at a capacity
    where nothing drops: every rank's tokens equal the JAX engine's, the
    teacher-forced logits one device's (1e-5), and a rank holds half (1×2:
    heads; 2×1: slots) or a quarter (2×2) of the slot-cache bytes."""
    key = tuple(int(s) for s in shape.split("x"))
    ranks = ([rk["engine"] for rk in runs["four"]] if key == (2, 2)
             else [rk["engine"][key] for rk in runs["two"]])
    single = ServeEngine(params_from_jax(runs["jparams"]["qwen2-moe-a2.7b"], _serve_cfg(),
                                         device="cpu"), _serve_cfg(), device="cpu",
                         **ENGINE).live_state_bytes
    for rk in ranks:
        assert rk["tokens"] == runs["jax_engine"]
        assert rk["teacher"] < 1e-5, rk["teacher"]
        assert rk["bytes"] * (4 if key == (2, 2) else 2) == single


def test_auto_under_sharding_rules_alone_computes_the_mesh_function(runs):
    """Under an ``api.sharding_rules`` context without a region the tensors
    are whole on every rank: ``impl="auto"`` runs ``ep_a2a``, computed whole
    at the mesh's dp × ep (the reference's choice, ``moe.py:107-112``)."""

    class FakeMesh:
        def __init__(self, sizes):
            self.shape, self.axis_names = dict(sizes), tuple(sizes)

    arrays = _layer_arrays("qwen_2x2")
    cfg = _layer_cfg("qwen_2x2", impl="auto")
    mesh = FakeMesh({"data": 2, "model": 2})
    with dist_api.sharding_rules(mesh, dist_api.rules_for_mesh(mesh)):
        got = _loss_grads(lambda p, x: moe.moe_apply(p, x, cfg), arrays)
    _assert_layer(got, runs["layer_ref"]["qwen_2x2"])
    off_mesh = _loss_grads(lambda p, x: moe.moe_apply(p, x, cfg), arrays)  # "auto" -> dense
    assert not np.array_equal(off_mesh["y"], got["y"])
