"""The port's training launcher, JAX checkpoint loader and remat
"dots_saveable" against the JAX package.

The JAX launcher (``repro.launch.train``) raises ``ShardingTypeError`` on
a 1×1 host mesh under the installed jax, so the port's launcher is held to
the single-device pieces that launcher composes: a jitted
``repro.train.make_train_step`` over ``repro.optim``'s optimizers (its
``build_optimizer``: defaults over ``cosine_warmup``) on
``repro.data.make_task`` batches.  Reduced smollm-135m and reduced
zamba2-7b (its pattern widened to the published run of 6 mamba blocks and
the shared block, with its tail), float32.  Tolerances: losses 1e-4
relative; weights within a tenth of the steps' total lr, absolute (the rule
of tests/test_torch_train.py); a checkpoint's restore is exact (bit for
bit); the launcher's resume on the CPU is exact; gradients under
"dots_saveable" equal "none"'s at 1e-6 and ``jax.grad`` under the
reference's policy at 1e-4 (relative, max|Δ| / max|ref|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import save_checkpoint as j_save_checkpoint
from repro.configs import get_reduced as j_get_reduced
from repro.data import make_task as j_make_task
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim import optimizers as jo
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro.train.step import TrainState as JTrainState
from repro.train.step import make_loss_fn as j_make_loss_fn
from repro_torch.checkpoint import (
    restore_checkpoint,
    restore_jax_checkpoint,
    to_jax_layout_state,
)
from repro_torch.configs import get_reduced
from repro_torch.launch import train as launch
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.train import loss_and_grads, make_loss_fn, make_train_step, train_state_init
from repro_torch.tree import tree_items, tree_leaves, tree_unflatten


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OPTIMIZERS = ("adamw", "adafactor", "sgdm")
LR, WARMUP, STEPS, SEQ, BATCH = 3e-3, 2, 5, 32, 4
ZAMBA_RUN6 = dict(pattern=("mamba",) * 6 + ("shared_attn",))
OVERRIDES = {"smollm-135m": {}, "zamba2-7b": ZAMBA_RUN6}


def configs(arch):
    return j_get_reduced(arch, **OVERRIDES[arch]), get_reduced(arch, **OVERRIDES[arch])


_STEPS = {}


def jax_step(arch, name):
    """The jitted reference step of the launcher's optimizer ``name``, once."""
    if (arch, name) not in _STEPS:
        jcfg, _ = configs(arch)
        opt = jo.make_optimizer(name, j_cosine_warmup(LR, WARMUP, STEPS))
        _STEPS[arch, name] = opt, jax.jit(j_make_train_step(jcfg, opt))
    return _STEPS[arch, name]


def port_optimizer(name, cfg):
    return launch.build_optimizer(name, LR, WARMUP, STEPS, cfg)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def bits(x) -> np.ndarray:
    """The raw bytes of a tensor or array (bfloat16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().contiguous().reshape(-1).view(torch.uint8).numpy()
    x = np.ascontiguousarray(x)
    return x.reshape(-1).view(np.uint8)


def rel(port, ref) -> float:
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def batches(cfg):
    return j_make_task("bigram", cfg.vocab, SEQ, BATCH, seed=0)


def assert_params_close(state, jstate, cfg, steps):
    ours = params_to_numpy(state.params, cfg)
    theirs = flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    ours = dict(tree_items(ours))
    assert ours.keys() == theirs.keys()
    for key in ours:
        err = float(np.abs(ours[key] - theirs[key]).max())
        assert err < 0.1 * steps * LR, (key, err)


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
@pytest.mark.parametrize("name", OPTIMIZERS)
def test_a_jax_checkpoint_restores_exactly_and_training_continues(tmp_path, arch, name):
    jcfg, cfg = configs(arch)
    jopt, jstep = jax_step(arch, name)
    task = batches(cfg)
    jb = lambda s: {k: jnp.asarray(v) for k, v in task.batch_at(s).items()}
    jstate = j_train_state_init(jax.random.PRNGKey(0), jcfg, jopt)
    for s in range(3):
        jstate, _ = jstep(jstate, jb(s))
    j_save_checkpoint(str(tmp_path), 3, jstate)

    opt = port_optimizer(name, cfg)
    template = train_state_init(torch.Generator().manual_seed(1), cfg, opt, device="cpu")
    state = restore_jax_checkpoint(str(tmp_path), template, cfg)
    assert type(state.opt_state) is type(template.opt_state)
    ours = dict(tree_items(to_jax_layout_state(state, cfg)))
    theirs = flat(jstate)
    assert ours.keys() == theirs.keys()
    for key, t in ours.items():  # every leaf, bfloat16 momentum included
        assert tuple(t.shape) == theirs[key].shape, key
        assert str(t.dtype).split(".")[-1] == theirs[key].dtype.name, key
        np.testing.assert_array_equal(bits(t), bits(theirs[key]), err_msg=key)

    step = make_train_step(cfg, opt)
    for s in (3, 4):
        jstate, jm = jstep(jstate, jb(s))
        state, m = step(state, {k: torch.from_numpy(v) for k, v in task.batch_at(s).items()})
        assert rel(float(m["loss"]), float(jm["loss"])) < 1e-4, (s, float(m["loss"]))
    assert int(state.step) == int(jstate.step) == STEPS
    assert_params_close(state, jstate, cfg, 2)


def test_a_checkpoint_of_another_optimizer_is_refused(tmp_path):
    jcfg, cfg = configs("smollm-135m")
    jopt, _ = jax_step("smollm-135m", "adamw")
    j_save_checkpoint(str(tmp_path), 1, j_train_state_init(jax.random.PRNGKey(0), jcfg, jopt))
    for name in ("sgdm", "adafactor"):  # a subset of adamw's keys; other keys
        template = train_state_init(torch.Generator().manual_seed(0), cfg,
                                    port_optimizer(name, cfg), device="cpu")
        with pytest.raises((ValueError, KeyError)):
            restore_jax_checkpoint(str(tmp_path), template, cfg)


def launcher_args(name, *extra):
    return ["--arch", "smollm-135m", "--reduced", "--device", "cpu", "--optimizer", name,
            "--steps", str(STEPS), "--batch", str(BATCH), "--seq", str(SEQ), "--lr", str(LR),
            "--warmup", str(WARMUP), "--log-every", "1", *extra]


@pytest.mark.parametrize("name", OPTIMIZERS)
def test_launcher_trains_as_the_reference_pieces_and_resumes_exactly(tmp_path, capsys, name):
    # uninterrupted, against the reference's jitted step from the same weights
    full = launch.main(launcher_args(name))
    out = capsys.readouterr().out
    assert "[train] smollm-135m (119,232 params) on mesh {'data': 1, 'model': 1} (cpu) " \
           "backend=taylor" in out
    assert f"[loop] step {STEPS}/{STEPS}" in out and f"[train] done: step={STEPS}" in out
    jcfg, cfg = configs("smollm-135m")
    jopt, jstep = jax_step("smollm-135m", name)
    init = train_state_init(torch.Generator().manual_seed(0), cfg, port_optimizer(name, cfg),
                            device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(init.params, cfg))
    jstate = JTrainState(jnp.zeros((), jnp.int32), jp, jopt.init(jp))
    task = batches(cfg)
    for s in range(STEPS):
        jstate, _ = jstep(jstate, {k: jnp.asarray(v) for k, v in task.batch_at(s).items()})
    assert_params_close(full, jstate, cfg, STEPS)

    # stopped part way (a step count, or the wall-clock budget), then re-invoked
    ckpt = str(tmp_path / "ckpt")
    stop = ["--steps", "2"] if name != "sgdm" else ["--max-wall-seconds", "1e-9"]
    part = launch.main(launcher_args(name, "--ckpt-dir", ckpt, *stop))
    saved = restore_checkpoint(ckpt, part)  # what the stopped run wrote: itself
    for a, b in zip(tree_leaves(saved), tree_leaves(part)):
        np.testing.assert_array_equal(bits(a), bits(b))
    resumed = launch.main(launcher_args(name, "--ckpt-dir", ckpt))
    assert "[loop] resumed from checkpoint step" in capsys.readouterr().out
    assert int(resumed.step) == STEPS
    for (key, a), b in zip(tree_items(resumed), tree_leaves(full)):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=key)


def test_launcher_mesh_flags_and_device(capsys):
    # one process: the host mesh shrinks to 1×1 (as make_host_mesh does) and
    # the run is the single-device one, bit for bit
    meshed = launch.main(launcher_args("adamw", "--mesh-data", "2", "--mesh-model", "2"))
    assert "on mesh {'data': 1, 'model': 1} (cpu)" in capsys.readouterr().out
    plain = launch.main(launcher_args("adamw"))
    for (key, a), b in zip(tree_items(meshed), tree_leaves(plain)):
        np.testing.assert_array_equal(bits(a), bits(b), err_msg=key)
    # the production meshes need 256 / 512 ranks
    for extra, n in ((["--production-mesh"], 256), (["--production-mesh", "--multi-pod"], 512)):
        with pytest.raises(ValueError, match=f"needs {n} ranks, but the process group has 1"):
            launch.main(launcher_args("adamw", *extra))
    with pytest.raises(ValueError, match="unknown optimizer"):
        launch.build_optimizer("lion", LR, WARMUP, STEPS, get_reduced("smollm-135m"))
    if not torch.cuda.is_available():  # the card by default, never the CPU unasked
        args = launcher_args("adamw")
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.main(args[:args.index("--device")] + args[args.index("--device") + 2:])


class _CountProducts(TorchDispatchMode):
    """Counts the matrix products dispatched while it is active."""

    OPS = ("mm", "bmm", "addmm", "baddbmm")

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func.overloadpacket.__name__ in self.OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["smollm-135m", "zamba2-7b"])
def test_dots_saveable_saves_the_products_and_gives_the_gradients(arch):
    jcfg, cfg = j_get_reduced(arch), get_reduced(arch)
    jp = j_train_state_init(jax.random.PRNGKey(0), jcfg, jo.sgdm(j_cosine_warmup(1.0, 1, 2))
                            ).params
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg, device="cpu")
    batch = batches(cfg).batch_at(0)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads, backward_products = {}, {}
    for remat in ("none", "full", "dots_saveable"):
        loss_fn = make_loss_fn(cfg.replace(remat=remat))
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        loss, _ = loss_fn(tree_unflatten(params, leaves), tbatch)
        with _CountProducts() as count:
            g = torch.autograd.grad(loss, leaves)
        grads[remat], backward_products[remat] = g, count.n
    # the backward reruns the forward's products under "full" only
    assert backward_products["dots_saveable"] == backward_products["none"]
    assert backward_products["full"] > backward_products["none"]
    for a, b in zip(grads["dots_saveable"], grads["none"]):
        assert rel(a.numpy(), b.numpy()) < 1e-6
    jgrads = jax.grad(lambda p: j_make_loss_fn(jcfg.replace(remat="dots_saveable"))(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    _, _, tgrads = loss_and_grads(make_loss_fn(cfg.replace(remat="dots_saveable")), params,
                                  tbatch)
    ours, theirs = dict(tree_items(params_to_numpy(tgrads, cfg))), flat(jgrads)
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert rel(ours[key], theirs[key]) < 1e-4, (key, rel(ours[key], theirs[key]))
