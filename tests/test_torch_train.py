"""The port's training path against the JAX package's trainer.

Reduced smollm-135m (3 layers, d_model 64, head dim 16, attn_chunk 16,
float32, remat "none"): the JAX ``lm_init(PRNGKey(0))`` params go to the
port through ``params_from_jax``, both trainers see the same bigram
batches, and ``params_to_numpy`` brings the port's weights back for the
comparison.  Tolerances, relative (max|Δ| / max|ref|):

  * gradients of one step, per leaf: 1e-4 (float32 sums over 3 layers in
    different orders; the forward's logits agree to 1e-4);
  * losses over 5 steps: 1e-3;
  * the weights after them: within a tenth of the 5 steps' total lr
    (5·2e-3) of each other, absolute.  AdamW divides by √v, so where a
    gradient is near zero its update is decided by rounding; those
    elements move by up to ±lr per step in either trainer.
  * schedule and AdamW on a small tree: 1e-6 (elementwise float32 math).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.data import make_task as j_make_task
from repro.models import count_params as j_count_params
from repro.optim import adamw as j_adamw
from repro.optim import cosine_warmup as j_cosine_warmup
from repro.optim import linear_warmup as j_linear_warmup
from repro.train import make_train_step as j_make_train_step
from repro.train import train_state_init as j_train_state_init
from repro.train.step import make_loss_fn as j_make_loss_fn
from repro_torch import quickstart
from repro_torch.checkpoint import store
from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_saves,
)
from repro_torch.configs import get_config, get_reduced
from repro_torch.data import make_task
from repro_torch.models import count_params, lm_apply, lm_init
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import adamw, apply_updates, constant, cosine_warmup, linear_warmup
from repro_torch.train import (
    TrainLoopConfig,
    TrainState,
    loss_and_grads,
    make_loss_fn,
    make_train_step,
    run_training,
    train_state_init,
)
from repro_torch.tree import tree_items, tree_leaves


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module: the suite runs several
    workers side by side, and each worker's default intra-op pool (one
    thread per core) oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SEQ, BATCH, LR = 64, 4, 2e-3


def rel(port, ref) -> float:
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-30))


def flat(tree):
    """{path: numpy} of a JAX-layout numpy tree (sorted dict keys)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = j_get_reduced("smollm-135m"), get_reduced("smollm-135m")
    jopt = j_adamw(j_cosine_warmup(LR, 2, 5))
    jstate = j_train_state_init(jax.random.PRNGKey(0), jcfg, jopt)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jstate.params), cfg,
                             device="cpu")
    task = make_task("bigram", cfg.vocab, SEQ, BATCH, seed=0)
    return jcfg, cfg, jopt, jstate, params, task


def torch_batch(task, step):
    return {k: torch.from_numpy(v) for k, v in task.batch_at(step).items()}


def test_vendored_data_equals_the_reference():
    for kind in ("bigram", "copy", "uniform"):
        for hosts, host in ((1, 0), (2, 1)):
            ours = make_task(kind, 97, 33, 4, seed=3, n_hosts=hosts, host_id=host)
            theirs = j_make_task(kind, 97, 33, 4, seed=3, n_hosts=hosts, host_id=host)
            for step in (0, 1, 17):
                a, b = ours.batch_at(step), theirs.batch_at(step)
                assert a.keys() == b.keys()
                for k in a:
                    assert a[k].dtype == b[k].dtype
                    np.testing.assert_array_equal(a[k], b[k])


def test_schedules_match_the_reference():
    ours = [cosine_warmup(1e-3, 3, 10), linear_warmup(1e-3, 4), constant(5e-4)]
    from repro.optim import constant as j_constant

    theirs = [j_cosine_warmup(1e-3, 3, 10), j_linear_warmup(1e-3, 4), j_constant(5e-4)]
    for f, g in zip(ours, theirs):
        for step in range(13):
            lr = f(step)
            assert lr.dtype == torch.float32 and lr.shape == ()
            np.testing.assert_allclose(float(lr), float(g(jnp.int32(step))), rtol=1e-6)
        assert float(f(torch.tensor(3, dtype=torch.int32))) == float(f(3))


def test_adamw_matches_the_reference(rng):
    shapes = {"a": (3, 4), "b": {"c": (5,), "d": (2, 2, 2)}}
    params = jax.tree_util.tree_map(lambda s: rng.normal(size=s).astype(np.float32),
                                    shapes, is_leaf=lambda x: isinstance(x, tuple))
    jopt = j_adamw(j_cosine_warmup(0.1, 1, 3), clip_norm=1.0)
    opt = adamw(cosine_warmup(0.1, 1, 3), clip_norm=1.0)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    js, ts = jopt.init(jp), opt.init(tp)
    for _ in range(3):  # the first step's gradient norm is clipped
        g = jax.tree_util.tree_map(lambda p: rng.normal(size=p.shape).astype(np.float32) * 3,
                                   params)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, ju)
        tu, ts = opt.update(jax.tree_util.tree_map(torch.tensor, g), ts, tp)
        tp = apply_updates(tp, tu)
    assert int(ts.step) == int(js.step) == 3
    for (_, a), b in zip(tree_items(tp), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    for (_, a), b in zip(tree_items(ts.v), jax.tree_util.tree_leaves(js.v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-12)


def test_one_step_gradients_match_the_jax_step(setup):
    jcfg, cfg, _, jstate, params, task = setup
    jbatch = {k: jnp.asarray(v) for k, v in task.batch_at(0).items()}
    (jloss, _), jgrads = jax.value_and_grad(j_make_loss_fn(jcfg), has_aux=True)(
        jstate.params, jbatch)
    loss, metrics, grads = loss_and_grads(make_loss_fn(cfg), params, torch_batch(task, 0))
    assert rel(loss, jloss) < 1e-5
    assert float(metrics["aux_loss"]) == 0.0
    ours = flat(params_to_numpy(grads, cfg))
    theirs = flat(jax.tree_util.tree_map(np.asarray, jgrads))
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert ours[key].shape == theirs[key].shape, key
        assert rel(ours[key], theirs[key]) < 1e-4, (key, rel(ours[key], theirs[key]))


def test_five_steps_match_the_jax_trainer(setup):
    jcfg, cfg, jopt, jstate, params, task = setup
    jstep = jax.jit(j_make_train_step(jcfg, jopt))
    opt = adamw(cosine_warmup(LR, 2, 5))
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    step = make_train_step(cfg, opt)
    for s in range(5):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in task.batch_at(s).items()})
        state, m = step(state, torch_batch(task, s))
        assert rel(m["loss"], jm["loss"]) < 1e-3, s
    assert int(state.step) == int(jstate.step) == 5
    ours = flat(params_to_numpy(state.params, cfg))
    theirs = flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    for key in ours:
        err = float(np.abs(ours[key] - theirs[key]).max())
        assert err < 0.1 * 5 * LR, (key, err)


def test_lm_apply_is_differentiable(setup):
    # lm_apply is the training forward: gradients reach every parameter, and
    # the kernel route (attn_impl="cuda": on CPU tensors, the kernels' plain
    # versions through the trainable wrapper) gives the torch route's.
    _, cfg, _, _, params, task = setup
    batch = torch_batch(task, 1)
    _, _, g_torch = loss_and_grads(make_loss_fn(cfg.replace(attn_impl="torch")), params, batch)
    _, _, g_cuda = loss_and_grads(make_loss_fn(cfg.replace(attn_impl="cuda")), params, batch)
    for a, b in zip(tree_leaves(g_cuda), tree_leaves(g_torch)):
        assert torch.isfinite(a).all() and rel(a, b) < 1e-4
    wq = g_torch["blocks"][0]["attn"]["wq"]["w"]
    assert float(wq.abs().max()) > 0
    leaf = params["blocks"][1]["mlp"]["w_up"].detach().clone().requires_grad_()
    p = dict(params, blocks=list(params["blocks"]))
    p["blocks"][1] = dict(p["blocks"][1], mlp=dict(p["blocks"][1]["mlp"], w_up=leaf))
    logits, _ = lm_apply(p, batch, cfg)
    logits.square().mean().backward()
    assert leaf.grad is not None and float(leaf.grad.abs().max()) > 0


def test_full_remat_gives_the_same_gradients(setup):
    _, cfg, _, _, params, task = setup
    batch = torch_batch(task, 2)
    _, _, g_none = loss_and_grads(make_loss_fn(cfg), params, batch)
    _, _, g_full = loss_and_grads(make_loss_fn(cfg.replace(remat="full")), params, batch)
    for a, b in zip(tree_leaves(g_full), tree_leaves(g_none)):
        assert rel(a, b) < 1e-6
    _, _, g_dots = loss_and_grads(make_loss_fn(cfg.replace(remat="dots_saveable")), params,
                                  batch)
    for a, b in zip(tree_leaves(g_dots), tree_leaves(g_none)):
        assert rel(a, b) < 1e-6
    with pytest.raises(ValueError, match="remat"):
        cfg.replace(remat="offload")
    assert get_config("smollm-135m").remat == j_get_config("smollm-135m").remat == "full"
    assert cfg.remat == j_get_reduced("smollm-135m").remat == "none"


def test_count_params_matches_the_reference():
    for ours, theirs in ((get_reduced("smollm-135m"), j_get_reduced("smollm-135m")),
                         (get_config("smollm-135m"), j_get_config("smollm-135m"))):
        assert count_params(ours) == j_count_params(theirs)
    params = lm_init(torch.Generator().manual_seed(0), get_reduced("smollm-135m"), device="cpu")
    assert sum(p.numel() for p in tree_leaves(params)) == count_params(
        get_reduced("smollm-135m"))


def test_params_to_numpy_inverts_params_from_jax(setup):
    _, cfg, _, jstate, params, _ = setup
    theirs = flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    ours = flat(params_to_numpy(params, cfg))
    assert ours.keys() == theirs.keys()
    for key in ours:
        np.testing.assert_array_equal(ours[key], theirs[key])


def test_checkpoint_round_trip_with_bf16(tmp_path, setup):
    _, cfg, _, _, params, _ = setup
    tree = TrainState(torch.tensor(7, dtype=torch.int32),
                      {"w": params["embed"]["w"].to(torch.bfloat16),
                       "blocks": [params["blocks"][0]["norm1"]]},
                      (torch.arange(5, dtype=torch.int64), None))
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    template = TrainState(torch.zeros((), dtype=torch.int32),
                          {"w": torch.zeros_like(tree.params["w"]),
                           "blocks": [{"scale": torch.zeros(cfg.d_model)}]},
                          (torch.zeros(5, dtype=torch.int64), None))
    back = restore_checkpoint(str(tmp_path), template)
    assert int(back.step) == 7 and back.opt_state[1] is None
    assert back.params["w"].dtype == torch.bfloat16
    assert torch.equal(back.params["w"].view(torch.int16), tree.params["w"].view(torch.int16))
    assert torch.equal(back.params["blocks"][0]["scale"], tree.params["blocks"][0]["scale"])
    assert torch.equal(back.opt_state[0], tree.opt_state[0])


def test_a_corrupted_checkpoint_raises_and_an_empty_leaf_restores(tmp_path):
    """Restores map each member from the file and check its CRC-32 first."""
    tree = {"x": torch.arange(4096, dtype=torch.float32), "e": torch.zeros(0, 3)}
    path = os.path.join(save_checkpoint(str(tmp_path), 1, tree), "host_0.npz")
    back = restore_checkpoint(str(tmp_path), tree)
    assert torch.equal(back["x"], tree["x"]) and back["e"].shape == (0, 3)
    with open(path, "r+b") as f:  # one byte of x's data flipped
        blob = f.read()
        at = blob.index(np.float32(1000.0).tobytes())
        f.seek(at)
        f.write(bytes([blob[at] ^ 1]))
    with pytest.raises(ValueError, match="CRC-32"):
        restore_checkpoint(str(tmp_path), tree)


def test_uncommitted_checkpoints_are_ignored_and_retention_keeps_the_newest(tmp_path):
    tree = {"x": torch.ones(3)}
    for step in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), step, {"x": torch.full((3,), float(step))},
                        keep=2, block=step % 2 == 0)
    pending = list(store._PENDING)
    wait_for_saves()
    assert not store._PENDING and not any(t.is_alive() for t in pending)
    assert sorted(os.listdir(tmp_path)) == ["step_0000000003", "step_0000000004"]
    # a torn save: a newer directory without COMMIT, and a leftover tmp dir
    os.makedirs(tmp_path / "step_0000000009")
    os.makedirs(tmp_path / "step_0000000010.tmp0")
    assert latest_step(str(tmp_path)) == 4
    assert float(restore_checkpoint(str(tmp_path), tree)["x"][0]) == 4.0
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)


def test_resumed_run_equals_a_straight_run(tmp_path, setup):
    _, cfg, _, _, params, task = setup
    opt = adamw(cosine_warmup(LR, 2, 6))
    step = make_train_step(cfg, opt)

    def fresh():
        return TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))

    logs = []
    straight = run_training(step, fresh(), lambda s: torch_batch(task, s),
                            TrainLoopConfig(total_steps=6, log_every=3), log=logs.append)
    ck = str(tmp_path / "ck")
    run_training(step, fresh(), lambda s: torch_batch(task, s),
                 TrainLoopConfig(total_steps=3, checkpoint_dir=ck, checkpoint_every=2),
                 log=logs.append)
    assert latest_step(ck) == 3
    resumed = run_training(step, fresh(), lambda s: torch_batch(task, s),
                           TrainLoopConfig(total_steps=6, checkpoint_dir=ck,
                                           checkpoint_every=2),
                           log=logs.append)
    assert any("resumed from checkpoint step 3" in line for line in logs)
    assert int(resumed.step) == int(straight.step) == 6
    for a, b in zip(tree_leaves(resumed), tree_leaves(straight)):
        assert torch.equal(a, b)
    assert latest_step(ck) == 6


def test_train_state_init_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced("smollm-135m")
    opt = adamw(constant(1e-3))
    with pytest.raises(RuntimeError, match="CUDA"):
        train_state_init(torch.Generator().manual_seed(0), cfg, opt)
    state = train_state_init(torch.Generator().manual_seed(0), cfg, opt, device="cpu")
    assert state.step.dtype == torch.int32 and int(state.opt_state.step) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main(["--steps", "1"])


def test_quickstart_trains_and_generates_on_cpu(capsys):
    quickstart.main(["--device", "cpu", "--steps", "4", "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "119,232 params" in out and "greedy :" in out


def test_wall_clock_budget_stops_and_saves(tmp_path, setup):
    _, cfg, _, _, params, task = setup
    opt = adamw(constant(1e-3))
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    logs = []
    ck = str(tmp_path / "ck")
    out = run_training(make_train_step(cfg, opt), state, lambda s: torch_batch(task, s),
                       TrainLoopConfig(total_steps=5, checkpoint_dir=ck,
                                       max_wall_seconds=1e-9), log=logs.append)
    assert int(out.step) == 1 and latest_step(ck) == 1
    assert any("simulated preemption" in line for line in logs)
