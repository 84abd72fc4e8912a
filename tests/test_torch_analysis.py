"""The port's analysis layer (``repro_torch.analysis``) and the kernels'
``torch.library`` ops against the JAX package's ``repro.analysis``.

FLOP counts: ``count_fn`` traces on meta tensors and counts matmul FLOPs
with ``FlopCounterMode``; the reference walks a jaxpr.  On the same
programs the two agree exactly, except where the two autodiffs differ in
what they compute (said at the case).  Collective bytes and the roofline
terms follow the reference's ring model and formulas on the same inputs
(a synthetic HLO line against a ``collectives.Record`` of the same kind,
result bytes and group size).  ``report.py`` renders the same tables.  The
shapes registry equals the reference's for all ten archs at published
widths.  The kernels' fake implementations give their plain versions'
shapes and dtypes, their flop formulas the cost model, and the peak-memory
tracker a hand count, alike on real, fake and meta tensors.
"""

import json
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.checkpoint import checkpoint
from torch.utils.flop_counter import FlopCounterMode

import repro.analysis.report as jreport
from repro.analysis.flops import count_fn as jax_count_fn
from repro.analysis.roofline import TPUV5E as JTPUV5E
from repro.analysis.roofline import collective_bytes as jax_collective_bytes
from repro.analysis.roofline import roofline_report as jax_roofline_report
from repro.configs import SHAPES as JSHAPES
from repro.configs import applicable_shapes as j_applicable_shapes
from repro.configs import get_config as j_get_config
from repro.configs import get_reduced as j_get_reduced
from repro.configs import input_specs as j_input_specs
from repro.models import lm_apply as j_lm_apply
from repro.models import lm_init as j_lm_init
from repro_torch.analysis import report
from repro_torch.analysis.collectives import attribute, top_table
from repro_torch.analysis.flops import count_fn, trace
from repro_torch.analysis.memory import PeakMemory
from repro_torch.analysis.roofline import (
    COLLECTIVES,
    H100,
    H100_F32_FLOPS,
    H100_TF32_FLOPS,
    TPUV5E,
    bound_ms,
    collective_bytes,
    roofline_report,
)
from repro_torch.configs import ARCHS, SHAPES, TensorSpec, applicable_shapes, get_config
from repro_torch.configs import get_reduced, input_specs
from repro_torch.data import make_task
from repro_torch.device import card_trace
from repro_torch.distributed import api as dist_api
from repro_torch.distributed.collectives import Record
from repro_torch.kernels.taylor_attention import kernel as K
from repro_torch.kernels.taylor_attention.cost import taylor_bwd_cost, taylor_fwd_cost
from repro_torch.launch.dryrun import VARIANTS, rules_for, training_preset
from repro_torch.launch.mesh import AbstractMesh, abstract_production_mesh
from repro_torch.launch.train import make_sharded_state_and_step
from repro_torch.models import lm_apply, lm_init
from repro_torch.models.config import count_params
from repro_torch.models.lm import MetaDraws
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import make_train_step, train_state_init
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
F32 = torch.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _spec(shape, dtype=F32):
    return TensorSpec(tuple(shape), dtype)


# ---------------------------------------------------------------------------
# FLOPs: tests/test_roofline.py's cases against the jaxpr walker
# ---------------------------------------------------------------------------


def _matmul_jax(w, x):
    return x @ w


def _loop_jax(w, x):
    def body(h, _):
        return jnp.tanh(h @ w), None
    return jax.lax.scan(body, x, None, length=17)[0]


def _loop_torch(w, x):
    h = x
    for _ in range(17):
        h = torch.tanh(h @ w)
    return h


def _remat_jax(w, x):
    def loss(w, x):
        f = jax.checkpoint(lambda h: jnp.tanh(h @ w))
        return jnp.sum(jax.lax.scan(lambda h, _: (f(h), None), x, None, length=4)[0])
    return jax.grad(loss)(w, x)


def _remat_torch(w, x):
    w = w.requires_grad_()
    h = x
    for _ in range(4):
        h = checkpoint(lambda h: torch.tanh(h @ w), h, use_reentrant=False)
    return torch.autograd.grad(h.sum(), w)[0]


# (name, jax fn, torch fn, w shape, x shape, matmul FLOPs the reference counts
# that the port's program does not compute)
WALKER_CASES = [
    ("x@w", _matmul_jax, lambda w, x: x @ w, (64, 32), (16, 64), 0),
    ("loop17", _loop_jax, _loop_torch, (32, 32), (8, 32), 0),
    # The scan's transpose computes the carry's cotangent through all four
    # bodies, the first too, whose result (dL/dx) the gradient w.r.t. w
    # discards; torch's autograd does not compute an input gradient that
    # nothing asks for: one [8, 32] @ [32, 32] product fewer.  Forward (4),
    # recompute (4), dh (3 against 4), dw (4).
    ("grad+checkpoint", _remat_jax, _remat_torch, (32, 32), (8, 32), 2 * 8 * 32 * 32),
]


@pytest.mark.parametrize("case", WALKER_CASES, ids=[c[0] for c in WALKER_CASES])
def test_count_fn_matmul_flops_equal_the_jaxpr_walker(case):
    _, jfn, tfn, ws, xs, skipped = case
    want = jax_count_fn(jfn, jax.ShapeDtypeStruct(ws, "float32"),
                        jax.ShapeDtypeStruct(xs, "float32"))["matmul_flops"]
    got = count_fn(tfn, _spec(ws), _spec(xs))
    assert got["matmul_flops"] == want - skipped
    assert got["flops"] >= got["matmul_flops"] > 0 and got["bytes"] > 0


def test_reduced_lm_apply_matmul_flops_equal_the_reference():
    jcfg = j_get_reduced("smollm-135m").replace(attention="softmax")
    pshapes = jax.eval_shape(lambda k: j_lm_init(k, jcfg), jax.ShapeDtypeStruct((2,), "uint32"))
    want = jax_count_fn(lambda p, b: j_lm_apply(p, b, jcfg), pshapes,
                        {"tokens": jax.ShapeDtypeStruct((2, 32), "int32")})
    cfg = get_reduced("smollm-135m").replace(attention="softmax")
    params = lm_init(MetaDraws(), cfg, device="meta")
    got = count_fn(lambda p, b: lm_apply(p, b, cfg), params,
                   {"tokens": _spec((2, 32), torch.int32)})
    # every product decomposes alike: the projections, q·kᵀ and p·v, the
    # MLP and the tied unembedding
    assert got["matmul_flops"] == want["matmul_flops"] > 0
    assert got["elementwise_flops"] > 0


# ---------------------------------------------------------------------------
# Collectives and the roofline against the reference's HLO parser
# ---------------------------------------------------------------------------

_HLO_OP = {"all-gather": "all-gather(%a), dimensions={0}",
           "all-reduce": "all-reduce(%a), to_apply=%add",
           "reduce-scatter": "reduce-scatter(%a), dimensions={0}, to_apply=%add",
           "all-to-all": "all-to-all(%a), dimensions={0}",
           "collective-permute": "collective-permute(%a), source_target_pairs={{0,1}}"}


def _hlo(kind: str, rows: int, g: int, n: int = 16) -> str:
    groups = "" if kind == "collective-permute" else f", replica_groups=[{n // g},{g}]<=[{n}]"
    return (f"HloModule m, num_partitions={n}\n\n"
            f"ENTRY %main (a: f32[{rows},8]) -> f32[{rows},8] {{\n"
            f"  %a = f32[{rows},8]{{1,0}} parameter(0)\n"
            f"  ROOT %c = f32[{rows},8]{{1,0}} {_HLO_OP[kind]}{groups}\n"
            f"}}\n")


@pytest.mark.parametrize("g", [2, 4, 16])
@pytest.mark.parametrize("kind", COLLECTIVES)
def test_collective_bytes_equal_the_reference(kind, g):
    rows = 48
    want = jax_collective_bytes(_hlo(kind, rows, g))
    rec = Record(kind, rows * 8 * 4, g, "layer0/attn")
    assert collective_bytes([rec]) == want
    assert attribute([rec, rec]) == {(kind, "layer0/attn"): 2 * want[kind]["link_bytes"]}


def test_roofline_report_agrees_with_the_reference():
    n = 16
    counts = {"flops": 3.5e12, "bytes": 7.25e10, "matmul_flops": 3.4e12,
              "elementwise_flops": 1e11}
    records = [Record("all-gather", 48 * 8 * 4, 4, "a"), Record("all-reduce", 48 * 8 * 4, 4, "b")]
    hlo = (f"HloModule m, num_partitions={n}\n\nENTRY %main (a: f32[48,8]) -> f32[48,8] {{\n"
           "  %a = f32[48,8]{1,0} parameter(0)\n"
           "  %g = f32[48,8]{1,0} all-gather(%a), replica_groups=[4,4]<=[16], dimensions={0}\n"
           "  ROOT %r = f32[48,8]{1,0} all-reduce(%g), replica_groups=[4,4]<=[16], "
           "to_apply=%add\n}\n")
    # the reference reads per-partition XLA costs and a GLOBAL walker count;
    # the port's counts are the rank's own
    want = jax_roofline_report({"flops": counts["flops"], "bytes accessed": counts["bytes"]},
                               hlo, n, JTPUV5E, model_flops=2e13,
                               walker={k: v * n for k, v in counts.items()})
    got = roofline_report(counts, records, n, TPUV5E, model_flops=2e13)
    for key in ("compute_s", "memory_s", "collective_s", "dominant", "flops_per_chip",
                "bytes_per_chip", "collective_link_bytes_per_chip",
                "collective_operand_bytes_per_chip", "collective_breakdown", "n_chips",
                "t_lower_bound_s", "t_serial_s", "model_flops", "useful_flops_ratio",
                "roofline_fraction"):
        if isinstance(want[key], (dict, str)):
            assert got[key] == want[key], key
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
    assert (TPUV5E.peak_flops, TPUV5E.hbm_bw, TPUV5E.link_bw, TPUV5E.hbm_bytes) == (
        JTPUV5E.peak_flops, JTPUV5E.hbm_bw, JTPUV5E.link_bw, JTPUV5E.hbm_bytes)
    assert (H100.peak_flops, H100_TF32_FLOPS, H100_F32_FLOPS, H100.hbm_bw, H100.link_bw,
            H100.hbm_bytes) == (989e12, 495e12, 67e12, 3.35e12, 450e9, 80e9)


# PERF.md §6's bf16 bounds (ms) of phase 3's launches (b=4, hk=3, g=3,
# d=dv=64) at n = 2048 and at the training launch's n = 1024
MAIN_BOUNDS = {"taylor_fwd": (0.2415, 0.1207), "taylor_bwd_dq": (0.2466, 0.1233),
               "taylor_bwd_dkv": (0.2511, 0.1255)}


@pytest.mark.parametrize("i,n", [(0, 2048), (1, 1024)])
def test_kernel_bounds_keep_their_values(i, n):
    from repro_torch.kernels.taylor_attention.cost import BWD_TF32_PRODUCTS, FWD_TF32_PRODUCTS

    flops, tensor, nbytes = taylor_fwd_cost(12, 3, n, 64, 64, 128, 2)
    ms, by = bound_ms(flops, nbytes, tensor, FWD_TF32_PRODUCTS["bfloat16"])
    assert (round(ms, 4), by) == (MAIN_BOUNDS["taylor_fwd"][i], "operations")
    cost = taylor_bwd_cost(12, 3, n, 64, 64, K.BWD_CHUNK, 2)
    for name in ("taylor_bwd_dq", "taylor_bwd_dkv"):
        flops, tensor, nbytes = cost[name]
        ms, by = bound_ms(flops, nbytes, tensor, BWD_TF32_PRODUCTS["bfloat16"])
        assert round(ms, 4) == MAIN_BOUNDS[name][i], name


def _report_records():
    def rec(arch, shape, mesh, fits, variant=None, status="ok"):
        if status != "ok":
            return dict(arch=arch, shape=shape, mesh=mesh, status="error", error="ValueError: x")
        return dict(arch=arch, shape=shape, mesh=mesh, status=status, variant=variant,
                    backend="taylor", hbm_peak_bytes_per_chip=3.2e9 if fits else 9.1e10,
                    fits_hbm=fits, compile_s=4.2,
                    roofline=dict(compute_s=0.07, memory_s=0.29 if not variant else 0.11,
                                  collective_s=0.04, dominant="memory_s",
                                  flops_per_chip=6.9e13, collective_link_bytes_per_chip=1.7e10,
                                  useful_flops_ratio=0.047, roofline_fraction=0.0113))
    return [rec("smollm-135m", "train_4k", "16x16", True),
            rec("smollm-135m", "train_4k", "16x16", True, variant="dp_only"),
            rec("kimi-k2-1t-a32b", "train_4k", "16x16", False),
            rec("qwen2-1.5b", "decode_32k", "16x16", True),
            rec("gemma-7b", "long_500k", "16x16", True, status="error"),
            rec("mamba2-780m", "prefill_32k", "2x16x16", True)]


def test_report_renders_the_reference_tables():
    recs = _report_records()
    same = lambda s: s.replace("| fits 80 GB |", "| fits 16GB |")
    for mesh in ("16x16", "2x16x16"):
        assert same(report.dryrun_table(recs, mesh)) == jreport.dryrun_table(recs, mesh)
        assert report.roofline_table(recs, mesh) == jreport.roofline_table(recs, mesh)
    assert report.variant_table(recs) == jreport.variant_table(recs)
    assert (report.summarize(recs).replace("fits 80 GB HBM", "fits 16 GB HBM")
            == jreport.summarize(recs))
    assert "fits 80 GB" in report.dryrun_table(recs, "16x16")


# ---------------------------------------------------------------------------
# Shapes, presets and rules
# ---------------------------------------------------------------------------


def test_shapes_and_input_specs_equal_the_reference():
    assert {k: tuple(vars(v).values()) for k, v in SHAPES.items()} == {
        k: tuple(vars(v).values()) for k, v in JSHAPES.items()}
    for arch in ARCHS:
        cfg, jcfg = get_config(arch), j_get_config(arch)
        assert applicable_shapes(cfg) == j_applicable_shapes(jcfg), arch
        for shape in SHAPES:
            got, want = input_specs(cfg, shape), j_input_specs(jcfg, shape)
            assert list(got) == list(want), (arch, shape)
            for k in got:
                assert got[k].shape == tuple(want[k].shape), (arch, shape, k)
                assert str(got[k].dtype).removeprefix("torch.") == str(want[k].dtype)
    assert input_specs(get_config("whisper-medium"), "train_4k", 2)["audio_frames"].shape == (
        2, 1500, 1024)
    assert input_specs(get_config("smollm-135m"), "train_4k")["tokens"].empty().is_meta


_REF_PRESETS = r"""
import json, sys
import jax.numpy as jnp
from repro.launch import dryrun
from repro.launch.mesh import make_production_mesh
from repro.configs import ARCHS, get_config
from repro.models.config import count_params
out = {}
for multi in (False, True):
    mesh = make_production_mesh(multi_pod=multi)
    for arch in ARCHS:
        cfg = get_config(arch)
        n = count_params(cfg)
        pcfg, opt = dryrun.training_preset(cfg, n)
        st = opt.init({"w": jnp.zeros((4, 4))})
        no_momentum = list(st.m["w"].shape) == [1]
        for variant in (None, *dryrun.VARIANTS):
            rules = dryrun.rules_for(cfg, mesh, n, variant=variant)
            out[f"{multi}/{arch}/{variant}"] = [
                pcfg.param_dtype, type(st).__name__, no_momentum,
                {k: (list(v) if isinstance(v, tuple) else v) for k, v in rules.items()}]
print(json.dumps(out))
"""


def test_training_preset_and_rules_equal_the_reference():
    # the reference's dryrun sets XLA_FLAGS for 512 host devices on import:
    # it runs in a process of its own
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", _REF_PRESETS], capture_output=True, text=True,
                          env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    for multi in (False, True):
        mesh = abstract_production_mesh(multi_pod=multi)
        for arch in ARCHS:
            cfg = get_config(arch)
            n = count_params(cfg)
            pcfg, opt = training_preset(cfg, n)
            # the port's Adafactor keeps the model's stacked layout: a model tree
            st = opt.init(lm_init(MetaDraws(), pcfg, device="meta"))
            no_momentum = all(x.shape == (1,) for x in tree_leaves(st.m))
            for variant in (None, *VARIANTS):
                rules = rules_for(cfg, mesh, n, variant=variant)
                got = [pcfg.param_dtype, type(st).__name__, no_momentum,
                       {k: (list(v) if isinstance(v, tuple) else v) for k, v in rules.items()}]
                assert got == want[f"{multi}/{arch}/{variant}"], (multi, arch, variant)


# ---------------------------------------------------------------------------
# The kernels as ops: fake implementations and flop formulas
# ---------------------------------------------------------------------------


def _kernel_inputs(dtype, bk=2, g=3, n=128, d=16, dv=16, device="cpu"):
    gen = torch.Generator().manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=gen).to(dtype).to(device)
    q, k, v = mk(bk, g, n, d), mk(bk, n, d), mk(bk, n, dv)
    dout, out = mk(bk, g, n, dv), mk(bk, g, n, dv)
    return q, k, v, dout, out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_ops_fake_outputs_match_the_plain_versions(dtype):
    q, k, v, dout, out = _kernel_inputs(dtype)
    ops = torch.ops.repro_torch
    plain = {"fwd": ops.taylor_fwd(q, k, v, 3.0, 2),
             "dq": ops.taylor_bwd_dq(q, k, v, dout, out, 3.0, 2)}
    plain["dkv"] = ops.taylor_bwd_dkv(q, k, v, dout, plain["dq"][1], plain["dq"][2], 3.0, 2)
    m = [x.to("meta") for x in (q, k, v, dout, out)]
    before = (K.taylor_fwd.launches, K.taylor_bwd.dq_launches, K.taylor_bwd.dkv_launches)
    with card_trace():  # the wrappers take the CUDA branch; the ops their fakes
        fake = {"fwd": K.taylor_fwd(*m[:3], alpha=3.0),
                "dq": K.taylor_bwd_dq(*m, alpha=3.0)}
        fake["dkv"] = K.taylor_bwd_dkv(*m[:4], fake["dq"][1], fake["dq"][2], alpha=3.0)
    with FakeTensorMode():
        fq, fk, fv = (torch.empty(x.shape, dtype=x.dtype, device="cuda") for x in (q, k, v))
        fakefwd = ops.taylor_fwd(fq, fk, fv, 3.0, 2)
    assert (K.taylor_fwd.launches, K.taylor_bwd.dq_launches, K.taylor_bwd.dkv_launches) == before
    assert (fakefwd.shape, fakefwd.dtype, fakefwd.device.type) == (
        plain["fwd"].shape, plain["fwd"].dtype, "cuda")
    for name in plain:
        p = plain[name] if isinstance(plain[name], tuple) else (plain[name],)
        f = fake[name] if isinstance(fake[name], tuple) else (fake[name],)
        assert [(x.shape, x.dtype) for x in f] == [(x.shape, x.dtype) for x in p], name
        assert all(x.is_meta for x in f)
    with pytest.raises(ValueError, match="CPU or all-CUDA"):  # meta outside the trace
        K.taylor_fwd(*m[:3], alpha=3.0)


@pytest.mark.parametrize("order", [1, 2])
def test_flop_formulas_equal_the_cost_model(order):
    bk, g, n, d, dv = 2, 3, 128, 16, 16
    q, k, v, dout, out = _kernel_inputs(torch.float32, bk, g, n, d, dv)
    ops = torch.ops.repro_torch
    with FlopCounterMode(display=False) as fc:
        ops.taylor_fwd(q, k, v, 3.0, order)
    assert fc.get_total_flops() == round(taylor_fwd_cost(bk, g, n, d, dv, 128, 4, order)[0])
    cost = taylor_bwd_cost(bk, g, n, d, dv, K.BWD_CHUNK, 4, order)
    with FlopCounterMode(display=False) as fc:
        _, den, dden = ops.taylor_bwd_dq(q, k, v, dout, out, 3.0, order)
    assert fc.get_total_flops() == round(cost["taylor_bwd_dq"][0])
    with FlopCounterMode(display=False) as fc:
        ops.taylor_bwd_dkv(q, k, v, dout, den, dden, 3.0, order)
    assert fc.get_total_flops() == round(cost["taylor_bwd_dkv"][0])


# ---------------------------------------------------------------------------
# Peak live bytes
# ---------------------------------------------------------------------------


def _hand(x):
    a = x * 2          # 4000 bytes (x: 4000, live from the start)
    b = a + 1          # 4000; x, a, b live: 12000
    del a
    c = b.sum(0)       # 4 bytes; x, b, c: 8004
    d = torch.cat([b, b])  # 8000; x, b, c, d: 16004
    return c + d.sum()     # d.sum() and the result, 4 each: 16012 (the peak)


@pytest.mark.parametrize("kind", ["real", "fake", "meta"])
def test_peak_memory_equals_a_hand_count(kind):
    if kind == "fake":
        with FakeTensorMode():
            x = torch.empty(1000)
            with PeakMemory(x) as pm:
                _hand(x)
    else:
        x = torch.ones(1000, device="cpu" if kind == "real" else "meta")
        with PeakMemory(x) as pm:
            _hand(x)
    assert pm.peak == 16012


def test_reduced_training_step_is_predicted_exactly():
    # phase 20 (a) of chip_smoke.py at the reduced size: the step traced on a
    # 1×1 abstract mesh (meta, the kernels' route) against one real step on
    # the CPU through the same ops (attn_impl="cuda": on CPU tensors the
    # kernels' ops run their plain versions)
    cfg = get_reduced("smollm-135m").replace(remat="full", dtype="bfloat16", attn_impl="cuda")
    opt = adamw(cosine_warmup(1e-3, 2, 8))
    task = make_task("bigram", cfg.vocab, 64, 4, seed=0)
    batch = {k: torch.from_numpy(x) for k, x in task.batch_at(0).items()}
    shapes = {k: torch.empty_like(x, device="meta") for k, x in batch.items()}
    mesh = AbstractMesh((1, 1), ("data", "model"))
    state, step, _, _ = make_sharded_state_and_step(cfg, opt, mesh, dist_api.rules_for_mesh(mesh),
                                                    shapes, device="meta")
    pred = trace(step, state, shapes)
    real_state = train_state_init(torch.Generator().manual_seed(0), cfg, opt, device="cpu")
    with FlopCounterMode(display=False) as fc, PeakMemory(real_state, batch) as pm:
        make_train_step(cfg, opt)(real_state, batch)
    assert fc.get_total_flops() == pred.counts["matmul_flops"]
    names = {str(k) for k in fc.get_flop_counts()["Global"]}
    assert {"repro_torch.taylor_fwd", "repro_torch.taylor_bwd_dq",
            "repro_torch.taylor_bwd_dkv"} <= names
    assert pm.peak == pred.peak_bytes
    assert pred.records == []  # a 1×1 mesh moves nothing
    # the rank's counts make a roofline; the whole step's model FLOPs bound
    # the useful share
    rep = roofline_report(pred.counts, pred.records, 1, H100, model_flops=6.0 * 1e6 * 4 * 64)
    assert rep["dominant"] in ("compute_s", "memory_s") and rep["collective_s"] == 0.0
    assert math.isclose(rep["t_lower_bound_s"], max(rep["compute_s"], rep["memory_s"]))


def test_top_table_lists_the_heaviest_sites():
    recs = [Record("all-gather", 2**30, 2, "layer0/attn"),
            Record("reduce-scatter", 2**30, 2, "layer0/mlp/bwd")]
    table = top_table(recs).splitlines()
    assert "reduce-scatter" in table[2] and "layer0/mlp/bwd" in table[2]
    assert "0.50" in table[3] and "layer0/attn" in table[3]
