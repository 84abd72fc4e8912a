"""The harness on the CPU at tiny sizes: it finds cells, configurations,
kinds and metrics by name, its traffic follows the seed, its result line
has the contract's keys, it refuses to run without a card, and a run whose
timed path is broken underneath comes out not correct."""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import traffic
from portbench.tests import tiny

CELLS = {
    "tiny.train": tiny.tiny_cell("train"),
    "tiny.ztrain": tiny.tiny_cell("train", "hybrid"),
    "tiny.serve": tiny.tiny_cell("serve"),
}
KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.make_copy(tmp_path_factory.mktemp("checkout"), CELLS)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is shown where there is none")


def _argv(cell, seed=3_000_000_019, seconds=1.0, trace=0):
    return ["--workload", cell, "--seed", str(seed), "--seconds", str(seconds),
            "--trace", str(trace)]


def _digests(root: Path) -> dict:
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_added_files_are_found_by_name(tmp_path):
    """A configuration, a cell, a traffic kind and a metric, each added as a
    file of its own with its entries in BENCHMARK.json, run with no file of
    the harness edited."""
    root = tiny.make_copy(tmp_path, {})
    bench_dir = root / "portbench"
    before = _digests(bench_dir)
    cfg = tiny.tiny_config("granite-20b-x4")
    cfg.update(name="tiny-other", n_groups=1)
    (bench_dir / "configs" / "tiny-other.json").write_text(json.dumps(cfg))
    (bench_dir / "kinds" / "train_again.py").write_text(
        "from portbench.kinds.train import run  # noqa: F401\n")
    cell = tiny.tiny_cell("train", "other")
    cell["traffic"]["kind"] = "train_again"
    (bench_dir / "workloads" / "tiny.other.json").write_text(json.dumps(cell))
    (bench_dir / "metrics" / "steps.other.py").write_text(
        "def read(ctx):\n    return float(ctx['layer']['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["end_to_end"][0]["workloads"].append("tiny.other")
    bench["per_layer"].append({"name": "steps.other", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "train step",
                               "moves": "train_tokens_per_s", "workloads": ["tiny.other"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code, result, err = tiny.run(root, _argv("tiny.other", trace=1))
    assert code == 0, err
    assert result["metrics"]["steps.other"]["value"] == result["attempted"]
    after = _digests(bench_dir)
    assert all(after[p] == d for p, d in before.items())


def test_traffic_follows_the_seed():
    tr = CELLS["tiny.serve"]["traffic"]
    a = traffic.open_loop(5, tr, 10.0, 128)
    b = traffic.open_loop(5, tr, 10.0, 128)
    c = traffic.open_loop(6, tr, 10.0, 128)
    key = lambda xs: [(x.due_s, x.max_new, x.prompt.tolist()) for x in xs]
    assert key(a) == key(b)
    assert key(a) != key(c)
    # another seed offers the same gaps and lengths in another order
    gaps = lambda xs: sorted(np.round(np.diff([0.0] + [x.due_s for x in xs]), 9))
    prompts = lambda xs: [len(x.prompt) for x in xs]
    outputs = lambda xs: [x.max_new for x in xs]
    assert gaps(a) == gaps(c)
    for lengths in (prompts, outputs):
        assert sorted(lengths(a)) == sorted(lengths(c)) and lengths(a) != lengths(c)
    assert len(a) == round(tr["rate_per_s"] * 10.0)
    assert all(0 < x.due_s < 10.0 for x in a + c)
    gaps = np.diff([0.0] + [x.due_s for x in a])
    assert gaps.mean() == pytest.approx(10.0 / len(a), rel=0.05)
    r1 = traffic.train_rows(5, 3, 16, 128, "cpu")
    assert torch.equal(r1, traffic.train_rows(5, 3, 16, 128, "cpu"))
    assert not torch.equal(r1, traffic.train_rows(6, 3, 16, 128, "cpu"))


@pytest.mark.parametrize("cell", sorted(CELLS))
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_has_the_contracts_keys(copy, cell, trace):
    code, result, err = tiny.run(copy, _argv(cell, trace=trace))
    assert code == 0, err
    assert set(result) == KEYS | ({"breakdown"} if trace else set())
    assert list(result)[-1] == "checks"
    assert result["correct"], err
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    kind = "per_layer" if trace else "end_to_end"
    for name, m in result["metrics"].items():
        entry = next(e for e in bench[kind] if e["name"] == name)
        assert m["unit"] == entry["unit"] and np.isfinite(m["value"])
    if not trace:
        assert "setup_s" in result["metrics"]
    else:
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        assert result["device"]["window_s"] > 0
    for name, c in result["checks"].items():
        assert f"portbench: {name} {c['value']!r} limit {c['limit']!r}" in err


def test_a_run_without_a_card_fails(copy, no_card):
    """The command as the driver runs it, in a fresh interpreter."""
    import subprocess
    import sys

    done = subprocess.run([sys.executable, str(copy / "portbench" / "run.py"), *_argv("tiny.train")],
                          cwd=copy, capture_output=True, text=True, timeout=120)
    assert done.returncode == 3, done.stderr
    assert done.stdout == ""


def test_a_run_that_loads_a_jax_package_prints_no_result(copy, monkeypatch):
    """A program that loads one of the JAX packages (here a stand-in named
    ``flax``, which nothing else in the tests loads) fails the run."""
    import sys
    import types

    import repro_torch.train as ptrain

    make = ptrain.make_train_step

    def make_loading(cfg, opt, *a, **k):
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
        return make(cfg, opt, *a, **k)

    monkeypatch.setattr(ptrain, "make_train_step", make_loading)
    code, result, err = tiny.run(copy, _argv("tiny.train"))
    assert code == 4 and result is None
    assert "loaded in the measuring process: flax" in err


# -- faults planted under the timed path ------------------------------------


def _broken_step(monkeypatch, fault):
    import repro_torch.train as ptrain

    make = ptrain.make_train_step

    def make_broken(cfg, opt, *a, **k):
        step = make(cfg, opt, *a, **k)

        def broken(state, batch):
            if fault == "unchanged":
                _, metrics = step(state, batch)
                return state, metrics
            half = batch["tokens"].shape[1] // 2
            return step(state, {k: v[:, :half] for k, v in batch.items()})

        return broken

    monkeypatch.setattr(ptrain, "make_train_step", make_broken)


@pytest.mark.parametrize("cell", ["tiny.train", "tiny.ztrain"])
@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(copy, monkeypatch, cell, fault):
    _broken_step(monkeypatch, fault)
    code, result, err = tiny.run(copy, _argv(cell))
    assert code == 0, err
    assert result["correct"] is False, result["checks"]


def _broken_decode(monkeypatch, fault):
    import repro_torch.serve.scheduler as sched

    scan = sched.decode_scan

    def broken(params, caches, *args, **kw):
        out = scan(params, caches, *args, **kw)
        if fault == "unchanged":
            return (caches,) + tuple(out[1:])
        toks = out[4].clone()
        toks[-1] = (toks[-1] + 1) % params["embed"]["w"].shape[0]
        return tuple(out[:4]) + (toks,) + tuple(out[5:])

    monkeypatch.setattr(sched, "decode_scan", broken)


@pytest.mark.parametrize("fault", ["unchanged", "token_altered"])
def test_a_broken_decode_is_not_correct(copy, monkeypatch, fault):
    _broken_decode(monkeypatch, fault)
    code, result, err = tiny.run(copy, _argv("tiny.serve", seconds=2.0))
    assert code == 0, err
    assert result["correct"] is False, result["checks"]


# -- BENCHMARK.json ----------------------------------------------------------

NAME = r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$"
UNIT = r"^[A-Za-z0-9_/%.-]{1,16}$"


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_benchmark_json_keeps_to_its_shape():
    import re

    bench = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"] and 1 <= bench["run_seconds"] <= 51
    assert all(_line(w) for w in bench["command"])
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert re.match(NAME, c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(re.match(NAME, k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        cfg = json.loads((tiny.REPO / c["file"]).read_text())
        assert cfg["name"] == c["name"] and all(k in cfg for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert re.match(NAME, w["name"]) and re.match(NAME, w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        cell = json.loads((tiny.REPO / "portbench" / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["chips"] == w["chips"]
    metrics = bench["end_to_end"] + bench["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert (tiny.REPO / "portbench" / "metrics" / f"{m['name']}.py").exists()
    for m in metrics:
        assert re.match(NAME, m["name"]) and re.match(UNIT, m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= set(cells)
    for name in cells:
        own = [m for m in metrics if name in m.get("workloads", [name])]
        assert {"setup_s"} < {m["name"] for m in own if m["name"] in e2e}
        assert any(m["name"] not in e2e for m in own)
