"""The plain reference against the port at tiny sizes on the CPU, and the
reference's and the counts' independence from the program."""

import ast
from pathlib import Path

import pytest
import torch

from portbench import program, weights
from portbench.reference import model as ref
from portbench.reference.adamw import AdamW
from portbench.tests.tiny import REPO, TINY, tiny_config

F32 = {"dtype": "float32", "param_dtype": "float32", "remat": "none"}
OPT = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg["vocab"], (2, n + 1), generator=g)


@pytest.mark.parametrize("name", sorted(TINY))
def test_training_step_matches_the_port(name):
    """The loss, and every parameter after one AdamW step."""
    from repro_torch import optim as popt
    from repro_torch import train as ptrain

    cfg = tiny_config(name)
    rows = _tokens(cfg, 64)
    batch = {"tokens": rows[:, :-1], "labels": rows[:, 1:]}
    mc = program.model_config(cfg, F32)
    harness = weights.draw(cfg, 7, "cpu")
    paths = program.leaf_paths(cfg, harness)
    tree = program.to_program(cfg, harness)
    opt = popt.adamw(popt.constant(OPT["lr"]), b1=OPT["b1"], b2=OPT["b2"], eps=OPT["eps"],
                     weight_decay=OPT["weight_decay"], clip_norm=OPT["clip_norm"])
    state = ptrain.TrainState(torch.zeros((), dtype=torch.int32), tree, opt.init(tree))
    state, metrics = ptrain.make_train_step(mc, opt)(state, batch)

    params = weights.draw(cfg, 7, "cpu")
    keys = weights.leaf_names(cfg)
    leaves = [weights.unit_of(params, u)[k].requires_grad_() for u, k in keys]
    adam = AdamW(leaves, **OPT)
    loss = ref.loss(params, batch["tokens"], batch["labels"], cfg)
    grads = adam.clip_grads(torch.autograd.grad(loss, leaves))
    adam.step(grads)
    assert float(metrics["loss"]) == pytest.approx(float(loss.detach()), rel=1e-5)
    mine = dict(zip(keys, zip(leaves, grads)))
    for key, path in paths:
        leaf, grad = mine[key]
        # AdamW's first moment after one step is (1 - b1) times the clipped gradient
        torch.testing.assert_close(program.get(state.opt_state.m, path), (1 - OPT["b1"]) * grad,
                                   rtol=1e-4, atol=1e-4 * float(grad.abs().max()) + 1e-12,
                                   msg=lambda m, key=key: f"gradient {key}: {m}")
        # the first step moves an element by lr·g/(|g| + eps), which two
        # float32 summation orders agree on only where |g| is well above eps
        sure = grad.abs() > 100 * OPT["eps"]
        torch.testing.assert_close(program.get(state.params, path)[sure], leaf.detach()[sure],
                                   rtol=0, atol=1e-3 * OPT["lr"],
                                   msg=lambda m, key=key: f"update {key}: {m}")


@pytest.mark.parametrize("name", sorted(TINY))
def test_prefill_and_decode_match_the_full_forward(name):
    """The port's prefill and decode through its cache against the
    reference's one forward over the whole sequence."""
    from repro_torch.models import lm_decode_step, lm_prefill

    cfg = tiny_config(name)
    mc = program.model_config(cfg, F32)
    params = weights.draw(cfg, 11, "cpu")
    tree = program.to_program(cfg, params)
    seq = _tokens(cfg, 40, seed=1)[:, :40]
    prompt = 29
    logits, caches = lm_prefill(tree, {"tokens": seq[:, :prompt]}, mc, n_max=64)
    got = [logits]
    for t in range(prompt, seq.shape[1]):
        logits, caches = lm_decode_step(tree, seq[:, t], caches, t, mc)
        got.append(logits)
    with torch.no_grad():
        want = ref.forward(params, seq, cfg)[:, prompt - 1:]
    torch.testing.assert_close(torch.stack(got, dim=1), want, rtol=1e-4, atol=1e-4)


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def _harness_files():
    return [p for p in (REPO / "portbench").rglob("*.py") if "tests" not in p.parts]


@pytest.mark.parametrize("folder", ["reference", "counts"])
def test_yardstick_imports_nothing_of_either_package(folder):
    for path in (REPO / "portbench" / folder).rglob("*.py"):
        assert not _imports(path) & (FORBIDDEN | {"repro_torch"}), path


def test_harness_imports_no_jax_and_the_program_only_where_it_drives_it():
    drivers = {REPO / "portbench" / "program.py"} | set((REPO / "portbench" / "kinds").glob("*.py"))
    for path in _harness_files():
        names = _imports(path)
        assert not names & FORBIDDEN, path
        if "repro_torch" in names:
            assert path in drivers, path


def test_whole_names_tell_the_port_from_the_jax_package():
    """``repro_torch`` starts with ``repro`` but is not it."""
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert "repro" in RUN_FORBIDDEN and "repro_torch".split(".")[0] not in RUN_FORBIDDEN
