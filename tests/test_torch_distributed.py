"""The port's sharding rules, specs and sharded training against the JAX
package.

Specs need no ranks: every leaf of the ten reduced configs' trees and of
the full-width qwen2-1.5b, granite-20b and kimi-k2 shapes (meta tensors,
never allocated) gets the JAX package's ``spec_for``/``param_specs``/
``opt_state_specs`` entries on stand-in 16×16 and 2×4 meshes, without the
reference's stacked leading entries (its block leaves are ``[n_groups,
run_len, ...]``, the port's one per layer; ``models/convert.py`` pairs
them).  ``rules_for_mesh``, ``logical_to_spec`` and ``resolve_axes`` (the
reference ``constrain``'s divisibility and one-axis-once rules) agree, and
the model's layout hooks leave a one-rank forward and its gradients bit
for bit as they are off a mesh.

The sharded runs spawn ``gloo`` ranks (one torch thread each, a file
store under the test's temporary directory), one spawn of 4 ranks and one
of 2, each running all its checks.  Tolerances: losses within 2e-3 of a
jitted ``repro.train.make_train_step`` on one device (the reference's own
bound, ``tests/test_distributed.py``), cp against tp within 5e-3 (the
same), params after the steps within 1e-5 of the port's one-device run
(bf16 AdamW moments and SGD-momentum too, their losses within 1e-5); a
reshard restore and a JAX checkpoint's restore are exact (bit for bit).
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, restore_jax_checkpoint, save_checkpoint
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data import make_task
from repro_torch.distributed import api as dist_api
from repro_torch.distributed import spmd
from repro_torch.distributed.api import P
from repro_torch.distributed.sharding import (
    Placements,
    distribute_tree,
    gather_tree,
    opt_state_specs,
    param_specs,
    spec_for,
    whole_template,
)
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models import lm_init
from repro_torch.models.convert import params_from_jax, to_jax_layout
from repro_torch.optim import adafactor, adamw, constant, sgdm
from repro_torch.train import make_train_step, train_state_init
from repro_torch.train.step import loss_and_grads, make_loss_fn
from repro_torch.tree import tree_items, tree_leaves, tree_map, tree_unflatten

LR, STEPS = 1e-3, 3
QWEN = dict(arch="qwen2-1.5b", seq=32, overrides={})
GRANITE = dict(arch="granite-20b", seq=64, overrides=dict(attn_chunk=8, max_seq=256))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """Just enough of a mesh for the specs' divisibility checks."""

    def __init__(self, sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"16x16": {"data": 16, "model": 16}, "2x4": {"data": 2, "model": 4}}


# ---------------------------------------------------------------------------
# Specs against the JAX package (no ranks)
# ---------------------------------------------------------------------------


def _strip(spec):
    t = list(spec)
    while t and t[-1] is None:
        t.pop()
    return tuple(t)


def _jax_flat(tree, is_spec=False):
    import jax
    from jax.sharding import PartitionSpec as JP

    leaf = (lambda x: isinstance(x, JP)) if is_spec else None
    return {jax.tree_util.keystr(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def _trees(arch, reduced):
    """(JAX config, port config, JAX param shapes, the port's meta params)."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.configs import get_reduced as j_get_reduced
    from repro.models import lm_init as j_lm_init

    jcfg = j_get_reduced(arch) if reduced else j_get_config(arch)
    cfg = get_reduced(arch) if reduced else get_config(arch)
    key = jax.ShapeDtypeStruct((2,), "uint32")
    jshapes = jax.eval_shape(lambda k: j_lm_init(k, jcfg), key)
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), jshapes)
    return jcfg, cfg, jshapes, params_from_jax(meta, cfg, device="meta")


def _pairs(params, cfg):
    """JAX path -> (port leaf indices [n_groups, run_len] or ())."""
    idx = tree_unflatten(params, [np.array(i) for i in range(len(tree_leaves(params)))])
    return _jax_flat(to_jax_layout(idx, cfg, np.array))


def _assert_specs_equal(jspecs, pspecs, params, cfg, what):
    jflat = _jax_flat(jspecs, is_spec=True)
    plist = tree_leaves(pspecs)
    pairs = _pairs(params, cfg)
    assert jflat.keys() == pairs.keys(), what
    for path, idx in pairs.items():
        jspec = tuple(jflat[path])
        lead = idx.ndim
        assert all(e is None for e in jspec[:lead]), (what, path, jspec)
        for i in idx.flat:
            assert _strip(plist[int(i)]) == _strip(jspec[lead:]), (what, path, jspec,
                                                                  plist[int(i)])


CASES = [(arch, True) for arch in ARCHS] + [(a, False) for a in
                                            ("qwen2-1.5b", "granite-20b", "kimi-k2-1t-a32b")]


@pytest.mark.parametrize("arch,reduced", CASES)
def test_param_and_opt_specs_equal_the_jax_packages(arch, reduced):
    import jax

    from repro.distributed.api import SINGLE_POD_RULES as J_RULES
    from repro.distributed.sharding import opt_state_specs as j_opt_state_specs
    from repro.distributed.sharding import param_specs as j_param_specs
    from repro.optim import adafactor as j_adafactor
    from repro.optim import adamw as j_adamw
    from repro.optim import constant as j_constant

    jcfg, cfg, jshapes, params = _trees(arch, reduced)
    rules = dict(dist_api.SINGLE_POD_RULES)
    assert rules == dict(J_RULES)
    jadam = jax.eval_shape(j_adamw(j_constant(1e-3)).init, jshapes)
    jada = jax.eval_shape(j_adafactor(j_constant(1e-3)).init, jshapes)
    adam = adamw(constant(1e-3)).init(params)
    ada = adafactor(constant(1e-3), cfg=cfg).init(params)
    stacked = to_jax_layout(params, cfg, lambda rows: torch.stack([torch.stack(r) for r in rows]))
    for name, sizes in MESHES.items():
        mesh = FakeMesh(sizes)
        jp = j_param_specs(jshapes, mesh, rules)
        pp = param_specs(params, mesh, rules)
        _assert_specs_equal(jp, pp, params, cfg, (name, "params"))
        # AdamW: m and v inherit the params' specs; the step is replicated
        jo = j_opt_state_specs(jadam, jp, jshapes, mesh, rules)
        po = opt_state_specs(adam, pp, params, mesh, rules)
        assert tuple(po.step) == tuple(jo.step) == ()
        _assert_specs_equal(jo.m, po.m, params, cfg, (name, "m"))
        _assert_specs_equal(jo.v, po.v, params, cfg, (name, "v"))
        # Adafactor's state is in the stacked layout: row/col/full by path
        ja = _jax_flat(j_opt_state_specs(jada, jp, jshapes, mesh, rules), is_spec=True)
        pa = dict(tree_items(opt_state_specs(ada, param_specs(stacked, mesh, rules), stacked,
                                             mesh, rules)))
        assert ja.keys() == pa.keys()
        for path in ja:
            assert _strip(pa[path]) == _strip(tuple(ja[path])), (name, path)


def test_spec_rules_divisibility_fallback():
    """The reference's own cases (``tests/test_distributed.py``) on the
    port's per-layer leaves."""
    mesh = FakeMesh(MESHES["16x16"])
    rules = dict(dist_api.SINGLE_POD_RULES)
    assert spec_for("blocks.3.attn.wk.w", (1536, 2, 128), rules, mesh) == P("data", None, None)
    assert spec_for("blocks.3.attn.wq.w", (6144, 48, 128), rules, mesh) == P("data", "model",
                                                                             None)
    assert spec_for("blocks.3.moe.experts.w_gate", (384, 7168, 2048), rules, mesh) == P(
        "model", "data", None)
    assert spec_for("final_norm.scale", (1536,), rules, mesh) == P()
    assert spec_for("embed.w", (151936, 1536), rules, mesh) == P("model", "data")


def test_rules_logical_specs_and_constrain_resolve_as_the_reference(monkeypatch):
    import jax

    from repro.distributed import api as japi

    for names in (("data", "model"), ("pod", "data", "model")):
        fake = FakeMesh({n: 2 for n in names})
        assert dict(dist_api.rules_for_mesh(fake)) == dict(japi.rules_for_mesh(fake))
        assert dict(dist_api.rules_for_mesh(fake, sp=None)) == dict(
            japi.rules_for_mesh(fake, sp=None))
    rules = dict(dist_api.DEFAULT_RULES)
    for axes in (("dp", "sp", None), ("dp", "tp", "*", None), (None, "ep", "fsdp")):
        j = tuple(japi.logical_to_spec(axes, rules))
        p = tuple(dist_api.logical_to_spec(axes, rules))
        assert p == tuple("*" if e is jax.sharding.PartitionSpec.UNCONSTRAINED else e
                          for e in j), axes
    # constrain's resolution: the spec the reference hands to the partitioner
    monkeypatch.setattr(japi, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    cases = [(("dp", "sp", None), (8, 12, 4)), (("dp", "sp", "tp"), (8, 12, 30)),
             (("dp", "tp", None, None), (3, 8, 5, 4)), (("dp", None, "sp", None), (4, 4, 6, 2)),
             (("dp", "*", "tp"), (4, 3, 8)), (("tp", "tp"), (4, 4))]
    for sizes in ({"data": 2, "model": 4}, {"pod": 2, "data": 2, "model": 3}):
        mesh = FakeMesh(sizes)
        rules = dict(japi.rules_for_mesh(mesh))
        for axes, shape in cases:
            with japi.sharding_rules(mesh, rules):
                j = japi.constrain(np.zeros(shape), *axes)
            p = dist_api.resolve_axes(axes, shape, mesh, rules)
            assert tuple(p) == tuple("*" if e is jax.sharding.PartitionSpec.UNCONSTRAINED
                                     else e for e in j), (sizes, axes, shape)
    # outside a region the model's layout hooks are the identity
    x, tree = torch.zeros(2, 3), {"w": torch.zeros(3)}
    assert dist_api.active() is None
    assert spmd.to_stream(x) is x and spmd.stream_block(x) is x
    assert spmd.on_rows(tree) is tree and spmd.on_stream(tree) is tree


def test_meshes_in_one_process():
    """No process group: the host mesh shrinks to 1×1 (the reference's
    ``make_host_mesh`` shrinks to the devices there are), the serving mesh
    refuses to, and the production meshes raise."""
    from repro_torch.launch.mesh import SingleMesh, make_production_mesh, make_serve_mesh

    for shape in ((1, 1), (2, 2), (1, 4)):
        mesh = make_host_mesh(*shape, device="cpu")
        assert isinstance(mesh, SingleMesh) and mesh.mesh_dim_names == ("data", "model")
        assert dist_api.mesh_axis_size(mesh, "data") == dist_api.mesh_axis_size(mesh, "model") == 1
    assert isinstance(make_serve_mesh(1, 1, device="cpu"), SingleMesh)
    with pytest.raises(ValueError, match="needs 2 ranks but only 1"):
        make_serve_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 512 ranks, but the process group has 1"):
        make_production_mesh(multi_pod=True, device="cpu")


# ---------------------------------------------------------------------------
# Sharded training on gloo ranks
# ---------------------------------------------------------------------------


def _setup(case):
    cfg = get_reduced(case["arch"], **case["overrides"])
    task = make_task("bigram", cfg.vocab, case["seq"], 8, seed=3)
    return cfg, task


def _batch(task, s):
    return {k: torch.from_numpy(v) for k, v in task.batch_at(s).items()}


OPTS = {"adamw": lambda: adamw(constant(LR)),
        "adamw_bf16": lambda: adamw(constant(LR), state_dtype=torch.bfloat16),
        "sgdm": lambda: sgdm(constant(LR))}


def _train(case, jparams, mesh, steps=STEPS, opt="adamw", **cfg_kw):
    """``steps`` steps of optimizer ``opt`` on ``mesh`` from the JAX
    weights; returns the losses, the params' whole leaves (numpy), the
    state and its placements."""
    cfg, task = _setup(case)
    cfg = cfg.replace(**cfg_kw)
    rules = dist_api.rules_for_mesh(mesh)
    shapes = {k: torch.empty_like(v, device="meta") for k, v in _batch(task, 0).items()}
    opt = OPTS[opt]()
    state, step, placements, _ = launch.make_sharded_state_and_step(
        cfg, opt, mesh, rules, shapes, seed=0, device="cpu")
    whole = params_from_jax(jparams, cfg, device="cpu")
    state = state._replace(params=distribute_tree(whole, Placements(mesh,
                                                                    placements.specs.params)))
    losses = []
    for s in range(steps):
        state, m = step(state, _batch(task, s))
        losses.append(float(m["loss"]))
    params = [x.numpy() for x in tree_leaves(gather_tree(state.params, Placements(
        mesh, placements.specs.params)))]
    return losses, params, state, placements


def _four(rank, world, jparams, tmp, jax_ckpt):
    out = {}
    for shape in ((2, 2), (1, 4)):
        mesh = make_host_mesh(*shape, device="cpu")
        out[shape] = _train(QWEN, jparams["qwen"], mesh)[:2]
    # elastic reshard: saved on 2×2, restored on 4×1, 1×4 and whole
    mesh = make_host_mesh(2, 2, device="cpu")
    _, _, state, placements = _train(QWEN, jparams["qwen"], mesh)
    save_checkpoint(f"{tmp}/reshard", STEPS, state, placements=placements)
    saved = [x.numpy() for x in tree_leaves(gather_tree(state, placements))]
    restored = {}
    for shape in ((4, 1), (1, 4)):
        m2 = make_host_mesh(*shape, device="cpu")
        _, _, template, pl2 = _train(QWEN, jparams["qwen"], m2, steps=0)
        back = restore_checkpoint(f"{tmp}/reshard", template, placements=pl2)
        restored[shape] = [x.numpy() for x in tree_leaves(gather_tree(back, pl2))]
    whole = restore_checkpoint(f"{tmp}/reshard", whole_template(state, placements))
    restored[(1, 1)] = [x.numpy() for x in tree_leaves(whole)]
    out["reshard"] = (saved, restored)
    # a JAX trainer's checkpoint onto the 2×2 mesh
    cfg, _ = _setup(QWEN)
    _, _, template, pl = _train(QWEN, jparams["qwen"], mesh, steps=0)
    back = restore_jax_checkpoint(jax_ckpt, template, cfg, placements=pl)
    out["jax_ckpt"] = [x.numpy() for x in tree_leaves(gather_tree(back, pl))]
    # the launcher on a 2×2 host mesh
    launch.main(LAUNCH + ["--mesh-data", "2", "--mesh-model", "2", "--ckpt-dir",
                          f"{tmp}/launcher"])
    # what a mesh refuses, and the models and optimizer it no longer
    # refuses: one step each of MoE, whisper (its encoder and cross blocks)
    # and Adafactor
    errors = {}
    rules = dist_api.rules_for_mesh(mesh)
    for name, cfg_, opt in (
            ("moe", get_reduced("qwen2-moe-a2.7b"), adamw(constant(LR))),
            ("cross", get_reduced("whisper-medium"), adamw(constant(LR))),
            ("adafactor", get_reduced("qwen2-1.5b"),
             adafactor(constant(LR), cfg=get_reduced("qwen2-1.5b")))):
        task = make_task("bigram", cfg_.vocab, 32, 8, seed=3)
        batch = {k: torch.from_numpy(v) for k, v in
                 {**task.batch_at(0), **task.extras_at(0, cfg_)}.items()}
        shapes = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
        state, step, _, _ = launch.make_sharded_state_and_step(cfg_, opt, mesh, rules, shapes,
                                                               device="cpu")
        out[f"{name}_loss"] = float(step(state, batch)[1]["loss"])
    try:
        launch.main(LAUNCH + ["--production-mesh"])
    except ValueError as e:
        errors["production"] = str(e)
    out["errors"] = errors
    return out


def _two(rank, world, jparams):
    mesh = make_host_mesh(1, 2, device="cpu")
    out = {"tp": _train(GRANITE, jparams["granite"], mesh)[:2],
           "cp": _train(GRANITE, jparams["granite"], mesh, attn_sharding="cp")[:2]}
    # the cp path runs the one-exchange scan on sequence blocks (n 64 -> 2 × 32)
    from repro_torch.core import context_parallel as cp_mod

    calls = []
    real = cp_mod.taylor_cp_local
    cp_mod.taylor_cp_local = lambda *a, **k: calls.append(a[0].shape) or real(*a, **k)
    try:
        _train(GRANITE, jparams["granite"], mesh, steps=1, attn_sharding="cp")
    finally:
        cp_mod.taylor_cp_local = real
    out["cp_calls"] = calls
    out["opts"] = {name: _train(QWEN, jparams["qwen"], mesh, opt=name)[:2]
                   for name in ("adamw_bf16", "sgdm")}
    # remat "full" with the backward on another thread, as on a card: the
    # rerun must still see the region
    real = torch.autograd.grad

    def on_a_thread(*args, **kwargs):
        box = []
        t = threading.Thread(target=lambda: box.append(real(*args, **kwargs)))
        t.start()
        t.join()
        return box[0]

    torch.autograd.grad = on_a_thread
    try:
        out["remat"] = _train(QWEN, jparams["qwen"], mesh, remat="full")[:2]
    finally:
        torch.autograd.grad = real
    return out


LAUNCH = ["--arch", "qwen2-1.5b", "--reduced", "--device", "cpu", "--optimizer", "adamw",
          "--steps", "4", "--batch", "4", "--seq", "32", "--log-every", "0"]


def _jax_run(case, steps=STEPS):
    """(JAX weights as numpy, the jitted one-device step's losses)."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as j_get_reduced
    from repro.optim import adamw as j_adamw
    from repro.optim import constant as j_constant
    from repro.train import make_train_step as j_make_train_step
    from repro.train import train_state_init as j_train_state_init

    jcfg = j_get_reduced(case["arch"], **case["overrides"])
    _, task = _setup(case)
    opt = j_adamw(j_constant(LR))
    state = j_train_state_init(jax.random.PRNGKey(0), jcfg, opt)
    params = jax.tree_util.tree_map(np.asarray, state.params)
    step = jax.jit(j_make_train_step(jcfg, opt))
    losses = []
    for s in range(steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in task.batch_at(s).items()})
        losses.append(float(m["loss"]))
    return params, losses, state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX references, the port's one-device runs and both spawns."""
    from repro.checkpoint import save_checkpoint as j_save_checkpoint

    tmp = tmp_path_factory.mktemp("dist")
    qwen_p, qwen_l, qwen_state = _jax_run(QWEN)
    granite_p, granite_l, _ = _jax_run(GRANITE)
    j_save_checkpoint(str(tmp / "jax"), STEPS, qwen_state)
    jparams = {"qwen": qwen_p, "granite": granite_p}
    single = _train(QWEN, qwen_p, make_host_mesh(1, 1, device="cpu"))
    four = run_ranks(_four, 4, backend="gloo", init_file=str(tmp / "store4"),
                     args=(jparams, str(tmp), str(tmp / "jax")))
    two = run_ranks(_two, 2, backend="gloo", init_file=str(tmp / "store2"), args=(jparams,))
    return dict(tmp=tmp, jax={"qwen": qwen_l, "granite": granite_l}, single=single,
                four=four, two=two, qwen_state=qwen_state, jparams=jparams)


def _close(a, b, tol):
    assert len(a) == len(b) and all(abs(x - y) < tol for x, y in zip(a, b)), (a, b)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4)])
def test_sharded_training_equals_the_jax_single_device_step(runs, shape):
    """1×4 is also the kv-replicated fallback: 2 kv heads do not divide by
    4, so every rank of "model" runs all heads."""
    losses, params = runs["single"][:2] if shape == (1, 1) else runs["four"][0][shape]
    _close(losses, runs["jax"]["qwen"], 2e-3)
    for a, b in zip(params, runs["single"][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)
    for other in runs["four"][1:]:  # every rank ends with the same losses
        if shape != (1, 1):
            assert other[shape][0] == losses


def test_mqa_tensor_parallel_and_context_parallel_training(runs):
    """Reduced granite-20b (4 query heads over 1 kv head) on 1×2 under tp,
    and under cp against tp (the reference's 5e-3)."""
    two = runs["two"][0]
    _close(two["tp"][0], runs["jax"]["granite"], 2e-3)
    _close(two["cp"][0], two["tp"][0], 5e-3)
    _close(two["cp"][0], runs["jax"]["granite"], 2e-3)
    assert two["cp_calls"] and all(s[2] == 32 for s in two["cp_calls"]), two["cp_calls"]


@pytest.mark.parametrize("name", ["adamw_bf16", "sgdm"])
def test_bf16_adamw_moments_and_sgd_momentum_on_a_mesh(runs, name):
    """The elementwise optimizers run on the blocks; the clip norm sums each
    leaf over its blocks, so 1×2 equals one device."""
    losses, params = runs["two"][0]["opts"][name]
    ref_losses, ref_params = _train(QWEN, runs["jparams"]["qwen"],
                                    make_host_mesh(1, 1, device="cpu"), opt=name)[:2]
    _close(losses, ref_losses, 1e-5)
    for a, b in zip(params, ref_params):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_remat_on_a_mesh_with_the_backward_on_another_thread(runs):
    """remat "full" on 1×2, each backward on a thread of its own (a card's
    autograd thread sees none of the step's context variables): the rerun
    blocks still take the sharded path, so the run equals one device."""
    losses, params = runs["two"][0]["remat"]
    _close(losses, runs["jax"]["qwen"], 2e-3)
    for a, b in zip(params, runs["single"][1]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_elastic_reshard_restores_bit_for_bit(runs):
    saved, restored = runs["four"][0]["reshard"]
    for shape, leaves in restored.items():
        assert len(leaves) == len(saved)
        for a, b in zip(leaves, saved):
            np.testing.assert_array_equal(a, b, err_msg=str(shape))


def test_a_jax_checkpoint_restores_onto_a_mesh(runs):
    cfg, _ = _setup(QWEN)
    opt = adamw(constant(LR))
    template = train_state_init(torch.Generator().manual_seed(1), cfg, opt, device="cpu")
    whole = restore_jax_checkpoint(str(runs["tmp"] / "jax"), template, cfg)
    for a, b in zip(runs["four"][0]["jax_ckpt"], tree_leaves(whole)):
        np.testing.assert_array_equal(a, b.numpy())


def test_launcher_on_a_2x2_mesh_equals_the_1x1_run(runs, tmp_path):
    single = launch.main(LAUNCH + ["--ckpt-dir", str(tmp_path)])
    cfg = get_reduced("qwen2-1.5b")
    template = train_state_init(torch.Generator().manual_seed(1), cfg, adamw(constant(LR)),
                                device="cpu")
    sharded = restore_checkpoint(str(runs["tmp"] / "launcher"), template)
    assert int(sharded.step) == int(single.step) == 4
    for (key, a), b in zip(tree_items(sharded), tree_leaves(single)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, err_msg=key)


def test_the_layout_hooks_leave_a_one_rank_forward_as_it_is():
    """The one forward with its layout hooks: inside a region on the 1×1
    mesh (every collective the identity) the loss and every gradient equal
    the plain step's bit for bit; a tensor read as a parameter that is not
    one of the region's leaves raises."""
    cfg, task = _setup(QWEN)
    params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = _batch(task, 0)
    loss_fn = make_loss_fn(cfg)
    plain_loss, _, plain_grads = loss_and_grads(loss_fn, params, batch)
    mesh = make_host_mesh(1, 1, device="cpu")
    rules = dist_api.rules_for_mesh(mesh)
    specs = param_specs(params, mesh, rules)
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    tree = tree_unflatten(params, leaves)
    lay = spmd.layout_for(mesh, rules, *batch["tokens"].shape, cfg.d_model)
    with spmd.region(lay, tree, specs):
        loss, _ = loss_fn(tree, spmd.local_batch(batch, lay))
        with pytest.raises(KeyError, match="not one of its leaves"):
            spmd.on_stream({"scale": torch.ones(cfg.d_model)})
    grads = torch.autograd.grad(loss, leaves)
    assert torch.equal(loss.detach(), plain_loss)
    for a, b in zip(grads, tree_leaves(plain_grads)):
        assert torch.equal(a, b)


def test_what_a_mesh_refuses(runs):
    """A production mesh raises with fewer ranks than it names; reduced
    qwen2-moe, reduced whisper-medium (encoder and cross blocks) and an
    Adafactor step on reduced qwen2-1.5b build and take a finite step on
    2×2 (tests/test_torch_moe_mesh.py and tests/test_torch_cross_mesh.py
    hold their numbers to the JAX package)."""
    errors = runs["four"][0]["errors"]
    assert set(errors) == {"production"}
    for name in ("moe", "cross", "adafactor"):
        assert all(np.isfinite(rk[f"{name}_loss"]) for rk in runs["four"]), name
    assert "needs 256 ranks" in errors["production"]
