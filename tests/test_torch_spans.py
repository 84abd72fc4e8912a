"""The port's spans and counters (``repro_torch.spans``) on the CPU.

A tiny training step of the reduced granite-20b through the kernels' ops
(their plain versions here), remat "full", AdamW with the clip: off, the
spans call no ``record_function`` and no CUDA function and record nothing;
on, they record calls and parents, leave the step's numbers bit for bit
as they were, and lie where the benchmark's readers need them on the
profiler's timeline."""

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_reduced
from repro_torch.models import lm_init
from repro_torch.optim import adamw, constant
from repro_torch.train import TrainState, make_train_step
from repro_torch.tree import tree_leaves

# the spans the benchmark's readers ask for: none may enclose a Taylor op
# or another of them
READ = ("optimizer", "head", "loss", "head.bwd", "attention.prep", "attention.post")
ALL = READ + ("train.forward", "train.backward", "optimizer.clip", "optimizer.update",
              "optimizer.apply")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean():
    spans.disable()
    spans.reset()
    yield
    spans.disable()
    spans.reset()


@pytest.fixture(scope="module")
def tiny():
    """(cfg, step, state, batch): layers of the reduced granite-20b through
    the kernels' ops, one step already taken so that set-up is behind."""
    cfg = get_reduced("granite-20b").replace(attn_impl="cuda", remat="full", max_seq=64)
    gen = torch.Generator().manual_seed(0)
    params = lm_init(gen, cfg, device="cpu")
    opt = adamw(constant(1e-3))
    state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
    step = make_train_step(cfg, opt)
    tok = torch.randint(0, cfg.vocab, (2, 33), generator=gen)
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    step(state, batch)
    return cfg, step, state, batch


def _raiser(name, calls):
    def fn(*args, **kwargs):
        calls.append(name)
        raise RuntimeError(f"{name} called")

    return fn


def test_off_path_calls_no_record_function_and_no_cuda(tiny, monkeypatch):
    _, step, state, batch = tiny
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function", _raiser("record_function", calls))
    for name, fn in list(vars(torch.cuda).items()):
        if isinstance(fn, types.FunctionType):
            monkeypatch.setattr(torch.cuda, name, _raiser(f"torch.cuda.{name}", calls))
    new, metrics = step(state, batch)
    assert calls == []
    assert torch.isfinite(metrics["loss"]) and int(new.step) == 1
    assert spans.snapshot() == {"spans": {}, "counters": {}}
    assert spans.span("optimizer") is spans.span("head") is spans.once("train.first_step")


def test_on_path_records_counts_and_parents(tiny):
    cfg, step, state, batch = tiny
    spans.enable()
    step(state, batch)
    step(state, batch)
    got = spans.snapshot()["spans"]
    n = cfg.n_layers
    assert set(got) == set(ALL)
    calls = {name: s["calls"] for name, s in got.items()}
    # remat "full" reruns each layer's forward in the backward: prep is the
    # LayerNorm and the layout in each forward, the layouts in the backward
    assert calls == dict({s: 2 for s in ALL}, **{"attention.prep": 2 * 5 * n,
                                                   "attention.post": 2 * 3 * n})
    parents = {name: s["parents"] for name, s in got.items()}
    assert parents["train.forward"] == parents["train.backward"] == {None: 2}
    assert parents["optimizer"] == {None: 2}
    for child in ("optimizer.clip", "optimizer.update", "optimizer.apply"):
        assert parents[child] == {"optimizer": 2}
    assert parents["head"] == parents["loss"] == {"train.forward": 2}
    assert parents["head.bwd"] == {"train.backward": 2}  # the CPU runs autograd here
    assert parents["attention.prep"] == {"train.forward": 4 * n, "train.backward": 6 * n}
    assert all(s["seconds"] > 0 for s in got.values())
    spans.disable()
    spans.reset()
    step(state, batch)
    assert spans.snapshot() == {"spans": {}, "counters": {}}


def test_once_spans_record_without_enable(tiny, monkeypatch):
    cfg, _, state, batch = tiny
    monkeypatch.setattr(spans, "_entered", set())  # as in a fresh process
    opt = adamw(constant(1e-3))
    step = make_train_step(cfg, opt)
    step(state, batch)
    step(state, batch)
    got = spans.snapshot()
    assert set(got["spans"]) == {"train.first_step"} and got["counters"] == {}
    first = got["spans"]["train.first_step"]
    assert first["calls"] == 1 and first["seconds"] > 0 and first["parents"] == {None: 1}
    with spans.once("a.build"):
        with spans.once("a.bind"):
            pass
    with spans.once("a.build"):
        pass
    got = spans.snapshot()["spans"]
    assert got["a.build"]["calls"] == 1 and got["a.bind"]["parents"] == {"a.build": 1}
    spans.reset()
    with spans.once("a.build"):
        pass
    assert spans.snapshot()["spans"] == {}


def _run(step, state, batch, mode):
    if mode == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            return step(state, batch)
    if mode == "enabled":
        spans.enable()
    return step(state, batch)


def test_recording_leaves_results_bitwise_equal(tiny):
    _, step, state, batch = tiny
    out = {}
    for mode in ("off", "enabled", "profiler"):
        s1, m1 = _run(step, state, batch, mode)
        s2, m2 = _run(step, s1, batch, mode)
        spans.disable()
        out[mode] = [m1["loss"], m2["loss"], m2["total_loss"],
                     *tree_leaves(s2.params), *tree_leaves(s2.opt_state)]
    for mode in ("enabled", "profiler"):
        assert all(torch.equal(a, b) for a, b in zip(out["off"], out[mode]))


def test_span_names_and_nesting_under_the_profiler(tiny):
    _, step, state, batch = tiny
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = list(prof.profiler.kineto_results.events())
    names = {e.name() for e in events}
    assert {"repro_torch." + s for s in ALL} <= names
    read = {"repro_torch." + s for s in READ}
    taylor = [e for e in events if e.name().startswith("repro_torch::taylor_")]
    assert {e.name() for e in taylor} == {"repro_torch::taylor_fwd",
                                         "repro_torch::taylor_bwd_dq",
                                         "repro_torch::taylor_bwd_dkv"}
    spans_read = [e for e in events if e.name() in read]
    for s in spans_read:
        for e in taylor + spans_read:
            if e is s or e.start_thread_id() != s.start_thread_id():
                continue
            inside = s.start_ns() <= e.start_ns() and e.end_ns() <= s.end_ns()
            assert not inside, f"{e.name()} inside {s.name()}"
    # the backward's head span runs on the thread that runs the head's backward
    bwd = next(e for e in events if e.name() == "repro_torch.head.bwd")
    grads = [e for e in events if e.name().startswith("autograd::engine::evaluate_function")
             and bwd.start_ns() <= e.start_ns() <= bwd.end_ns()]
    assert grads and all(e.start_thread_id() == bwd.start_thread_id() for e in grads)


def test_the_sharded_step_has_the_same_spans():
    """``make_sharded_train_step`` on a one-rank host mesh: the phase and
    optimizer spans as the single-device step's, numbers unchanged."""
    from repro_torch.distributed import api as dist_api
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import make_host_mesh

    cfg = get_reduced("granite-20b").replace(attn_impl="cuda", max_seq=64)
    mesh = make_host_mesh(1, 1, device="cpu")
    tok = torch.randint(0, cfg.vocab, (2, 33), generator=torch.Generator().manual_seed(2))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    shapes = {k: torch.empty_like(v, device="meta") for k, v in batch.items()}
    state, step, _, _ = launch.make_sharded_state_and_step(
        cfg, adamw(constant(1e-3)), mesh, dist_api.rules_for_mesh(mesh), shapes, seed=0,
        device="cpu")
    off_state, off = step(state, batch)
    spans.enable()
    on_state, on = step(state, batch)
    got = spans.snapshot()["spans"]
    assert set(ALL) <= set(got)
    assert got["optimizer"]["parents"] == {None: 1}
    assert got["optimizer.update"]["parents"] == {"optimizer": 1}
    assert got["head.bwd"]["parents"] == {"train.backward": 1}
    assert torch.equal(off["loss"], on["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(off_state.params),
                                                 tree_leaves(on_state.params)))


def test_allocator_counters_count_across_a_phase_span(monkeypatch):
    """On a card a phase span adds the caching allocator's deltas to its
    counters; the statistics are faked here, one retry per reading."""
    readings = []

    def memory_stats(device):
        readings.append(device)
        k = len(readings)
        return {"num_alloc_retries": k, "num_device_alloc": 10 * k, "num_device_free": 0}

    monkeypatch.setattr(torch.cuda, "memory_stats", memory_stats)
    card = torch.device("cuda", 0)
    with spans.span("optimizer", card):
        pass
    assert readings == [] and spans.snapshot()["counters"] == {}  # off: not read
    spans.enable()
    with spans.span("optimizer", card):
        with spans.span("optimizer.update"):
            pass
    with spans.span("train.forward", torch.device("cpu")):
        pass
    assert readings == [card, card]
    assert spans.snapshot()["counters"] == {"optimizer.num_alloc_retries": 1,
                                            "optimizer.num_device_alloc": 10,
                                            "optimizer.num_device_free": 0}
    spans.count("optimizer.num_alloc_retries", 2)
    assert spans.snapshot()["counters"]["optimizer.num_alloc_retries"] == 3


def test_a_backward_span_closes_on_its_thread_and_pairs_up():
    x = torch.randn(4, requires_grad=True)
    spans.enable()
    y = spans.backward_end(x * 2, "part.bwd")
    loss = spans.backward_begin((y * 3).sum(), "part.bwd")
    (g,) = torch.autograd.grad(loss, x)
    assert torch.equal(g, torch.full((4,), 6.0))
    got = spans.snapshot()["spans"]
    assert got["part.bwd"]["calls"] == 1
    # an end without its begin, or both under no_grad, records nothing
    spans.reset()
    torch.autograd.grad(spans.backward_end(x * 2, "part.bwd").sum(), x)
    with torch.no_grad():
        assert spans.backward_begin(x, "part.bwd") is x
    assert spans.snapshot()["spans"] == {}
    spans.disable()
    assert spans.backward_begin(x, "part.bwd") is x
