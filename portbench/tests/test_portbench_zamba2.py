"""The Zamba2 cell at a CPU's sizes: the port's training step against the
plain reference (``reference/zamba2.py``) at ``reduced()`` widths, three
planted wiring faults told apart, the weights' mapping and counts, the cell
through ``run.py`` (correct; a broken step not), the fp8 control and the
half-batch fault judged by the cell's limits, and the new readers."""

import importlib.util
import json

import pytest
import torch

from portbench import program_zamba2 as layout
from portbench import weights_zamba2 as zw
from portbench.counts import peaks, taylor
from portbench.counts import zamba2 as counts
from portbench.kinds import train_zamba2 as kind
from portbench.program import get
from portbench.reference import zamba2 as ref
from portbench.reference.adamw import AdamW
from portbench.run import Harness
from portbench.tests import tiny
from portbench.tracing import Tracer, summarise

CELL = "zamba2-7b-instruct-x27.train-4k"
F32 = {"dtype": "float32", "param_dtype": "float32", "remat": "full"}
OPT = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0)
NEW = ("taylor_attention.roofline", "hybrid_site_ms.train", "mamba_ms.train", "mfu.zamba2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def real_config() -> dict:
    return json.loads((tiny.REPO / "portbench" / "configs" / "zamba2-7b-instruct-x27.json")
                      .read_text())


def tiny_config() -> dict:
    """The cell's configuration at the widths of the port's ``reduced()``."""
    from repro_torch.configs.zamba2_7b_instruct import reduced

    r = reduced()
    cfg = real_config()
    cfg.update(name="tiny-zamba2", hidden_size=r.d_model, n_mamba_heads=2 * r.d_model // 16,
               mamba_headdim=r.ssm.head_dim, mamba_d_state=r.ssm.d_state,
               mamba_ngroups=r.ssm.n_groups, attention_hidden_size=2 * r.d_model,
               num_attention_heads=r.n_heads, num_key_value_heads=r.n_kv_heads,
               attention_head_dim=r.head_dim, n_heads=r.n_heads, n_kv_heads=r.n_kv_heads,
               head_dim=r.head_dim, intermediate_size=r.d_ff, ffn_hidden_size=r.d_ff,
               adapter_rank=r.sites.adapter_rank, vocab_size=r.vocab,
               num_hidden_layers=r.n_layers, hybrid_layer_ids=list(r.sites.layer_ids),
               chunk_size=r.attn_chunk, max_position_embeddings=r.max_seq)
    return cfg


def tiny_cell() -> dict:
    cell = json.loads((tiny.REPO / "portbench" / "workloads" / f"{CELL}.json").read_text())
    cell.update(config="tiny-zamba2", precision=dict(cell["precision"], **F32))
    cell["traffic"]["seq"] = 64
    return cell


def test_the_harness_config_is_the_ports_reduced_one():
    from repro_torch.configs.zamba2_7b_instruct import reduced

    mc = kind.model_config(tiny_config(), F32)
    assert mc == reduced().replace(name="tiny-zamba2", remat="full")
    assert mc.n_heads * mc.head_dim == mc.attention_width


def test_counts_of_the_stage_and_the_release():
    from repro_torch.models import count_params

    cfg = real_config()
    assert zw.n_params(cfg) == 2_968_362_608
    assert count_params(kind.model_config(cfg, F32)) == 2_968_362_608
    pub = dict(cfg, num_hidden_layers=81, hybrid_layer_ids=cfg["published"]["hybrid_layer_ids"])
    assert zw.n_params(pub) == 7_356_749_648
    # frozen model work: the sites' Taylor attention at its launch beside the matmuls
    hd = cfg["attention_head_dim"]
    att = taylor.fwd(32, 1, 4096, hd, hd, 2)[0] + taylor.bwd(32, 1, 4096, hd, hd, 2)["pair"][0]
    assert counts.train_step_flops(cfg, 1, 4096) == pytest.approx(
        6 * counts.matmul_params(cfg) * 4096 + 4 * att
        + 3 * 27 * counts.ssd_flops(cfg, 1, 4096))
    # each shared block's matrices twice (it runs at two sites), without the
    # mamba layers' norms, conv and SSD constants, the blocks' norms, the final norm
    shared_matrices = 3 * 7168 * 7168 + 7168 * 3584 + 3 * 3584 * 14336
    assert counts.matmul_params(cfg) == zw.n_params(cfg) + 2 * shared_matrices - (
        27 * (3584 + 4 * 7424 + 7424 + 3 * 112 + 7168) + 2 * (7168 + 3584) + 3584)


def _leaves_and_batch(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(0, cfg["vocab_size"], (2, 65), generator=g)
    return zw.draw(cfg, seed, "cpu"), {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def _program_grads(cfg, harness, batch):
    from repro_torch.train.step import loss_and_grads, make_loss_fn

    tree = layout.to_program(cfg, harness)
    loss, _, grads = loss_and_grads(make_loss_fn(kind.model_config(cfg, F32)), tree, batch)
    return float(loss), {key: get(grads, path) for key, path in layout.leaf_paths(cfg)}


def _reference_grads(cfg, harness, batch):
    keys = zw.leaf_names(cfg)
    leaves = [zw.unit_of(harness, u)[k].requires_grad_() for u, k in keys]
    loss = ref.loss(harness, batch["tokens"], batch["labels"], cfg)
    return float(loss.detach()), dict(zip(keys, torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("seed", [11, 12])
def test_the_training_step_matches_the_reference(seed):
    """The loss and every leaf's gradient, the shared blocks' summed over
    their two sites each, at ``reduced()`` widths in float32."""
    cfg = tiny_config()
    harness, batch = _leaves_and_batch(cfg, seed)
    got_loss, got = _program_grads(cfg, harness, batch)
    want_loss, want = _reference_grads(cfg, zw.draw(cfg, seed, "cpu"), batch)
    assert got_loss == pytest.approx(want_loss, rel=1e-5)
    assert {u for u, _ in want} >= {"shared0", "shared1", "site0", "site3", "layer9"}
    for key, g in want.items():
        assert float(g.abs().max()) > 0, key
        torch.testing.assert_close(got[key], g, rtol=1e-4, atol=1e-4 * float(g.abs().max()),
                                   msg=lambda m, key=key: f"gradient {key}: {m}")


def _fault(monkeypatch, name):
    """The port's sites wired wrongly: ``residual`` adds the site's output to
    the residual stream (``x + s + mamba(norm(x + s))``), ``no_x0`` feeds
    the stream in the embeddings' place, ``ungrouped`` takes the gate norm
    over all of d_inner."""
    from repro_torch.models import blocks, lm, ssm
    from repro_torch.models.layers import norm_apply

    if name == "residual":
        def hybrid(params, shared, site, x, x0, cfg, positions):
            s = blocks.site_apply(shared, site, x, x0, cfg, positions)
            h = norm_apply(params["norm1"], x + s, cfg.norm, cfg.norm_eps)
            return x + s + blocks._mamba(params["mamba"], h, cfg, positions), torch.zeros(())
        monkeypatch.setattr(lm, "hybrid_apply", hybrid)
    elif name == "no_x0":
        site = blocks.site_apply
        monkeypatch.setattr(blocks, "site_apply",
                            lambda sh, st, x, x0, cfg, pos: site(sh, st, x, x, cfg, pos))
    else:
        monkeypatch.setattr(ssm, "gate_norm",
                            lambda p, y, cfg: norm_apply(p, y, "rmsnorm", cfg.norm_eps))


@pytest.mark.parametrize("fault", ["residual", "no_x0", "ungrouped"])
def test_each_wiring_fault_is_told_apart(monkeypatch, fault):
    """The right wiring agrees with the reference to 1e-5; each fault puts
    the loss or a gradient past the test's tolerance of 1e-3."""
    cfg = tiny_config()
    harness, batch = _leaves_and_batch(cfg, 13)
    want_loss, want = _reference_grads(cfg, zw.draw(cfg, 13, "cpu"), batch)

    def gap():
        loss, got = _program_grads(cfg, zw.draw(cfg, 13, "cpu"), batch)
        worst = max(float((got[k] - g).abs().max() / g.abs().max()) for k, g in want.items())
        return max(abs(loss - want_loss) / want_loss, worst)

    assert gap() < 1e-5
    _fault(monkeypatch, fault)
    assert gap() > 1e-3


# -- the cell through the harness ---------------------------------------------


def _copy(root):
    """A checkout with the tiny cell ``tiny.zamba2`` listed wherever the real
    cell is."""
    root = tiny.make_copy(root, {})
    (root / "portbench" / "configs" / "tiny-zamba2.json").write_text(json.dumps(tiny_config()))
    (root / "portbench" / "workloads" / "tiny.zamba2.json").write_text(json.dumps(tiny_cell()))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny.zamba2")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return _copy(tmp_path_factory.mktemp("checkout"))


def _argv(trace=0, seed=3_000_000_019):
    return ["--workload", "tiny.zamba2", "--seed", str(seed), "--seconds", "1.0",
            "--trace", str(trace)]


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_runs_correct_through_run_py(copy, trace):
    code, result, err = tiny.run(copy, _argv(trace))
    assert code == 0, err
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"grad_gap", "delta_gap"}
    if trace:
        # on the CPU the device-time readers find no device time; mfu reads
        assert set(result["metrics"]) == {"mfu.zamba2", "device_idle.train"}
    else:
        assert set(result["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(copy, monkeypatch, fault):
    import repro_torch.train as ptrain

    make = ptrain.make_train_step

    def make_broken(cfg, opt, *a, **k):
        step = make(cfg, opt, *a, **{**k, "donate": False})

        def broken(state, batch):
            if fault == "unchanged":
                return state, step(state, batch)[1]
            half = batch["tokens"].shape[1] // 2
            return step(state, {key: v[:, :half] for key, v in batch.items()})

        return broken

    monkeypatch.setattr(ptrain, "make_train_step", make_broken)
    code, result, err = tiny.run(copy, _argv())
    assert code == 0, err
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("seed", [3_000_000_301, 3_000_000_302, 3_000_000_303])
def test_the_control_and_the_fault_are_not_correct(seed):
    """The reference in fp8 products, and the reference with the loss over
    half of each row, each put in the program's place, against the cell's
    own limits."""
    h = Harness(tiny_cell(), tiny_config(), seed, 1.0, torch.device("cpu"), Tracer(False))
    batch = kind._batches(h, h.cell["traffic"], h.config["vocab_size"])
    want = kind.reference(h, h.config, h.cell, batch)
    limits = h.cell["limits"]
    for planted in (dict(quant="fp8"), dict(half=True)):
        got = kind.numbers(kind.reference(h, h.config, h.cell, batch, **planted), want)
        assert any(v > limits[k] for k, v in got.items()), (planted, got)


def test_the_reference_steps_as_the_program_does():
    """One AdamW step of the reference moves every leaf as the program's
    donated step does."""
    from repro_torch import optim as popt
    from repro_torch import train as ptrain

    cfg = tiny_config()
    harness, batch = _leaves_and_batch(cfg, 17)
    tree = layout.to_program(cfg, harness)
    opt = popt.adamw(popt.constant(OPT["lr"]), b1=OPT["b1"], b2=OPT["b2"], eps=OPT["eps"],
                     weight_decay=OPT["weight_decay"], clip_norm=OPT["clip_norm"])
    state = ptrain.TrainState(torch.zeros((), dtype=torch.int32), tree, opt.init(tree))
    state, _ = ptrain.make_train_step(kind.model_config(cfg, F32), opt, donate=True)(state, batch)
    params = zw.draw(cfg, 17, "cpu")
    keys = zw.leaf_names(cfg)
    leaves = [zw.unit_of(params, u)[k].requires_grad_() for u, k in keys]
    adam = AdamW(leaves, **OPT)
    grads = adam.clip_grads(torch.autograd.grad(
        ref.loss(params, batch["tokens"], batch["labels"], cfg), leaves))
    adam.step(grads)
    for (key, path), leaf, grad in zip(layout.leaf_paths(cfg), leaves, grads):
        # the first step moves an element by lr·g/(|g| + eps), which two
        # float32 summation orders agree on only where |g| is well above eps
        sure = grad.abs() > 100 * OPT["eps"]
        torch.testing.assert_close(get(state.params, path)[sure], leaf.detach()[sure], rtol=0,
                                   atol=1e-3 * OPT["lr"], msg=lambda m, key=key: f"{key}: {m}")


# -- the new readers ------------------------------------------------------------


def _reader(name):
    path = tiny.REPO / "portbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("test_zmetric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R = {name: _reader(name) for name in NEW}


def _ctx(steps, calls, cfg=None):
    op_calls = {name: [{"device_s": s} for s in secs] for name, secs in calls.items()}
    return {"layer": {"steps": steps, "batch": 1, "seq": 4096, "window_s": 10.0},
            "trace": {"op_calls": op_calls}, "config": cfg or real_config(),
            "cell": {"precision": {"dtype": "bfloat16"}}}


def test_the_readers_give_none_on_nothing():
    for name in NEW[:3]:
        assert R[name].read(_ctx(4, {})) is None, name
        zero = {op: [0.0] * 4 for op in R[name].OPS}  # a CPU trace: no device time
        assert R[name].read(_ctx(4, zero)) is None, name
    assert R["mfu.zamba2"].read(_ctx(0, {})) is None


def test_the_readers_arithmetic():
    P = "repro_torch."
    ms = R["hybrid_site_ms.train"].read(_ctx(2, {P + "hybrid.pre": [0.01] * 16,
                                                 P + "hybrid.post": [0.02] * 16}))
    assert ms == pytest.approx(1e3 * 0.48 / 2)
    assert R["hybrid_site_ms.train"].read(_ctx(2, {P + "hybrid.pre": [0.01]})) is None
    assert R["mamba_ms.train"].read(_ctx(4, {P + "mamba": [0.02] * 216})) == pytest.approx(1080.0)
    # 4 sites a step: 8 forward calls (rerun included) and 4 backward calls
    fwd = peaks.least_seconds(*taylor.fwd(32, 1, 4096, 224, 224, 2))
    bwd = peaks.least_seconds(*taylor.bwd(32, 1, 4096, 224, 224, 2)["pair"])
    scan = {P + "attention.scan": [0.1] * 8, P + "attention.scan.bwd": [0.3] * 4}
    assert R["taylor_attention.roofline"].read(_ctx(1, scan)) == pytest.approx(
        100 * (8 * fwd + 4 * bwd) / 2.0)
    ops = {"repro_torch::taylor_fwd": [0.1] * 8, "repro_torch::taylor_bwd_dq": [0.1] * 4,
           "repro_torch::taylor_bwd_dkv": [0.2] * 4}
    assert R["taylor_attention.roofline"].read(_ctx(1, ops)) == pytest.approx(
        100 * (8 * fwd + 4 * bwd) / 2.0)
    mfu = R["mfu.zamba2"].read(_ctx(5, {}))
    assert mfu == pytest.approx(100 * counts.train_step_flops(real_config(), 1, 4096) * 5
                                / (10.0 * peaks.BF16_FLOPS))


def test_the_readers_find_their_spans_in_a_traced_step():
    """A tiny donated step traced as the harness traces its window."""
    from repro_torch import optim as popt
    from repro_torch import train as ptrain

    cfg = tiny_config()
    mc = kind.model_config(cfg, F32)
    harness, batch = _leaves_and_batch(cfg, 19)
    tree = layout.to_program(cfg, harness)
    opt = popt.adamw(popt.constant(1e-3))
    state = ptrain.TrainState(torch.zeros((), dtype=torch.int32), tree, opt.init(tree))
    step = ptrain.make_train_step(mc, opt, donate=True)
    tracer = Tracer(True)
    with tracer.window():
        for _ in range(2):
            with tracer.span("train_step"):
                state, _ = step(state, batch)
    ops = {op for name in NEW[:3] for op in R[name].OPS}
    calls = {op: len(c) for op, c in summarise(tracer.prof, ops)["op_calls"].items()}
    sites, layers = len(cfg["hybrid_layer_ids"]), cfg["num_hidden_layers"]
    assert calls == {
        "repro_torch.attention.scan": 2 * 2 * sites, "repro_torch.attention.scan.bwd": 2 * sites,
        "repro_torch.hybrid.pre": 2 * 2 * sites, "repro_torch.hybrid.post": 2 * 2 * sites,
        "repro_torch.mamba": 2 * 2 * layers, "repro_torch::taylor_fwd": 0,
        "repro_torch::taylor_bwd_dq": 0, "repro_torch::taylor_bwd_dkv": 0}


def test_a_program_without_sites_fails_the_cell_at_once(monkeypatch):
    """A program without hybrid sites (this cell's parent) raises in the
    kind's set-up, before any weight is drawn."""
    import repro_torch.models.config as config

    monkeypatch.delattr(config, "SiteConfig")
    with pytest.raises(ImportError):
        kind.model_config(real_config(), F32)
