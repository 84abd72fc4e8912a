"""The readers of the program's spans and counters: on hand-made inputs,
nothing to read gives None and the arithmetic is a step's; on a real trace
of a tiny training step, the spans they ask for are found."""

import importlib.util
import sys

import pytest
import torch

from portbench import program_spans
from portbench.tests.tiny import REPO
from portbench.tracing import Tracer, summarise

NAMES = ("optimizer_ms.train", "head_ms.train", "attention_glue_ms.train",
         "alloc_retries.train", "kernel_first_call_s.train")


def _reader(name):
    path = REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("test_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = {name: _reader(name) for name in NAMES}


def _ctx(steps, calls):
    """``calls``: span name (without the prefix) -> device seconds of each call."""
    op_calls = {program_spans.PREFIX + name: [{"device_s": s} for s in secs]
                for name, secs in calls.items()}
    return {"layer": {"steps": steps}, "trace": {"op_calls": op_calls}}


def _snap(monkeypatch, spans=None, counters=None):
    snap = {"spans": spans or {}, "counters": counters or {}}
    for name in ("alloc_retries.train", "kernel_first_call_s.train"):
        monkeypatch.setattr(R[name], "snapshot", lambda: snap)


@pytest.mark.parametrize("name", NAMES[:3])
def test_device_time_readers_give_none_on_nothing(name):
    reader = R[name]
    assert reader.read({"layer": {}, "trace": None}) is None
    assert reader.read(_ctx(4, {})) is None
    zero = {span: [0.0] * 4 for span in reader.SPANS}  # a CPU trace: no device time
    assert reader.read(_ctx(4, zero)) is None
    assert reader.read(_ctx(0, {span: [1.0] for span in reader.SPANS})) is None
    assert reader.OPS == tuple("repro_torch." + s for s in reader.SPANS)


def test_optimizer_reads_a_step_and_wants_one_call_a_step():
    read = R["optimizer_ms.train"].read
    assert read(_ctx(4, {"optimizer": [0.1, 0.1, 0.12, 0.08]})) == pytest.approx(100.0)
    assert read(_ctx(4, {"optimizer": [0.1, 0.1, 0.1]})) is None
    assert read(_ctx(4, {"optimizer": [0.1] * 8})) is None


def test_head_and_glue_sum_their_spans_a_step():
    head = R["head_ms.train"].read
    calls = {"head": [0.05] * 2, "loss": [0.01] * 2, "head.bwd": [0.08] * 2}
    assert head(_ctx(2, calls)) == pytest.approx(140.0)
    assert head(_ctx(2, dict(calls, **{"head.bwd": []}))) is None
    glue = R["attention_glue_ms.train"].read
    # a step holds many calls of each: 5 and 3 a layer under remat "full"
    calls = {"attention.prep": [0.001] * 40, "attention.post": [0.0005] * 24}
    assert glue(_ctx(2, calls)) == pytest.approx(1e3 * (0.04 + 0.012) / 2)


def test_alloc_retries_sum_the_phases_over_the_steps(monkeypatch):
    read = R["alloc_retries.train"].read
    _snap(monkeypatch)
    assert read({"layer": {"steps": 4}}) is None
    _snap(monkeypatch, counters={"train.forward.num_alloc_retries": 0,
                                 "train.backward.num_alloc_retries": 2,
                                 "optimizer.num_alloc_retries": 6,
                                 "optimizer.num_device_free": 50})
    assert read({"layer": {"steps": 4}}) == pytest.approx(2.0)
    assert read({"layer": {"steps": 0}}) is None
    _snap(monkeypatch, counters={"optimizer.num_alloc_retries": 0})
    assert read({"layer": {"steps": 4}}) == 0.0


def test_first_call_sums_the_ops_first_calls(monkeypatch):
    read = R["kernel_first_call_s.train"].read
    _snap(monkeypatch, spans={"train.first_step": {"calls": 1, "seconds": 20.0}})
    assert read({}) is None
    _snap(monkeypatch, spans={
        "train.first_step": {"calls": 1, "seconds": 20.0},
        "kernels.first_call.taylor_fwd": {"calls": 1, "seconds": 6.0},
        "kernels.build.taylor_fwd": {"calls": 1, "seconds": 0.5},
        "kernels.first_call.taylor_bwd_dq": {"calls": 1, "seconds": 3.0},
        "kernels.first_call.taylor_bwd_dkv": {"calls": 1, "seconds": 0.25}})
    assert read({}) == pytest.approx(9.25)


def test_a_program_without_spans_gives_none(monkeypatch):
    """The parent of the change that added the spans has no
    ``repro_torch.spans``: its readers give None and do not raise."""
    monkeypatch.delitem(sys.modules, "repro_torch.spans", raising=False)
    assert program_spans.snapshot() is None
    assert R["alloc_retries.train"].read({"layer": {"steps": 4}}) is None
    assert R["kernel_first_call_s.train"].read({}) is None


def test_the_readers_find_their_spans_in_a_traced_step():
    """A tiny step traced as the harness traces its window: each span a
    device-time reader asks for has its calls in ``summarise``'s
    ``op_calls`` (with no device time on the CPU)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import lm_init
    from repro_torch.optim import adamw, constant
    from repro_torch.train import TrainState, make_train_step

    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = get_reduced("granite-20b").replace(attn_impl="cuda", remat="full", max_seq=64)
        gen = torch.Generator().manual_seed(1)
        params = lm_init(gen, cfg, device="cpu")
        opt = adamw(constant(1e-3))
        state = TrainState(torch.zeros((), dtype=torch.int32), params, opt.init(params))
        step = make_train_step(cfg, opt)
        tok = torch.randint(0, cfg.vocab, (1, 33), generator=gen)
        batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
        tracer = Tracer(True)
        with tracer.window():
            for _ in range(2):
                with tracer.span("train_step"):
                    state, _ = step(state, batch)
    finally:
        torch.set_num_threads(n_threads)
    ops = {op for name in NAMES[:3] for op in R[name].OPS}
    calls = summarise(tracer.prof, ops)["op_calls"]
    n = cfg.n_layers
    assert {op: len(c) for op, c in calls.items()} == {
        "repro_torch.optimizer": 2, "repro_torch.head": 2, "repro_torch.loss": 2,
        "repro_torch.head.bwd": 2, "repro_torch.attention.prep": 2 * 5 * n,
        "repro_torch.attention.post": 2 * 3 * n}
    assert all(c["device_s"] == 0.0 for cs in calls.values() for c in cs)
