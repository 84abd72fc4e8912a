"""Multi-pod dry run: whether a configuration fits a card group, and what one
of its ranks computes and moves per step, without the cards.

The port's counterpart of the JAX package's ``launch/dryrun.py``.  The
reference lowers and compiles the step for 256 (512) forced host devices
and reads XLA's memory and cost analyses and the HLO's collectives.  The
port traces rank (0, …)'s program on an ``AbstractMesh`` of the production
topology (16×16 ``pod``, 2×16×16 ``multipod``) with meta tensors, as the
card would run it (``device.card_trace``: the Taylor kernels' route, their
ops' fake implementations), and counts it (``analysis.flops.trace``):

  * FLOPs and bytes, trip-exact (``count_fn``), with the kernels' own cost
    models;
  * the peak of live bytes (``analysis.memory.PeakMemory``): the rank's
    blocks of the state, its batch and every activation, against the H100's
    80 GB;
  * the collectives, one ``collectives.Record`` each (kind, result bytes,
    group size, site), whose link bytes make the roofline's third term.

The cells: ``train`` runs ``launch.train.make_sharded_state_and_step``'s
step, ``prefill`` ``lm_prefill`` and ``decode`` ``lm_decode_step`` (on
``lm_init_caches``' shapes cut by ``slot_cache_specs``), both in an
``spmd.region`` with the serve engine's layout (``serve_param_specs``, the
slotted batch over "data").  It needs no card and allocates no state.  One
JSON record per cell, with the reference's keys, goes under
artifacts/dryrun_torch/ (resumable: existing records are skipped unless
--force); ``analysis/report.py`` renders them.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k --mesh pod
  python -m repro_torch.launch.dryrun --all --mesh pod            # 40-cell sweep
  python -m repro_torch.launch.dryrun --all --mesh multipod       # 2×16×16
  python -m repro_torch.launch.dryrun --all --backend softmax     # arch baselines
  ... --save-records   # also the rank's collective records, one JSON line each
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

import torch

from repro_torch.analysis.flops import materialise, trace
from repro_torch.analysis.roofline import H100, roofline_report
from repro_torch.configs import ARCHS, SHAPES, applicable_shapes, get_config, input_specs
from repro_torch.distributed import api as dist
from repro_torch.distributed import spmd
from repro_torch.distributed.sharding import (
    Placements,
    distribute_tree,
    serve_param_specs,
    slot_cache_specs,
)
from repro_torch.launch.mesh import abstract_production_mesh
from repro_torch.launch.train import make_sharded_state_and_step
from repro_torch.models import lm_decode_step, lm_init, lm_init_caches, lm_prefill
from repro_torch.models.config import ModelConfig, count_active_params, count_params
from repro_torch.models.lm import init_generator, lm_state_bytes
from repro_torch.optim import adafactor, adamw, cosine_warmup

# <repo>/artifacts/dryrun_torch: listed in .gitignore
ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"
META = torch.device("meta")


def training_preset(cfg: ModelConfig, n_params: int):
    """Optimizer + numerics preset by scale (the reference's)."""
    sched = cosine_warmup(3e-4, 2000, 100000)
    if n_params > 100e9:
        # 1T-class: bf16 params + classic adafactor (no momentum, factored v)
        cfg = cfg.replace(param_dtype="bfloat16")
        return cfg, adafactor(sched, momentum=None, cfg=cfg)
    if n_params > 5e9:
        return cfg.replace(param_dtype="bfloat16"), adamw(sched)
    return cfg, adamw(sched)


def rules_for(cfg: ModelConfig, mesh, n_params: int, variant=None):
    """The reference's rules of a cell: ZeRO across pods for 1T-class models,
    and the variants' rules."""
    over = {}
    axes = dist.axis_names(mesh)
    if "pod" in axes and n_params > 100e9:
        over["fsdp"] = ("pod", "data")  # ZeRO across pods for 1T-class
    if variant == "dp_only":
        # sub-1B models waste the TP axis: pure DP over the whole mesh
        over = {"dp": axes, "fsdp": None, "tp": None, "ep": None, "sp": None}
    if variant == "fsdp_cp":
        # no TP: params fully sharded, sequence over the former TP axis,
        # attention by context parallelism, MLP token-local
        over = {"dp": "data" if "pod" not in axes else ("pod", "data"),
                "fsdp": axes, "tp": None, "ep": "model", "sp": "model"}
    return dist.rules_for_mesh(mesh, **over)


# --variant presets: config/rules deltas against the baselines
VARIANTS = {
    "dp_only": {},                       # rules change only (see rules_for)
    "cp_attn": {"attn_sharding": "cp"},  # CP taylor attention
    "moe_int8": {},                      # cf 1.0 + int8 a2a (applied below)
    "sym_state": {},                     # symmetric-compressed second moments
    "fsdp_cp": {"attn_sharding": "cp"},  # ZeRO-3 + CP attention, no TP
}


def cell_config(arch: str, backend=None, variant=None) -> ModelConfig:
    cfg = get_config(arch, **VARIANTS.get(variant, {}))
    if backend is not None and not cfg.is_attention_free:
        cfg = cfg.replace(attention=backend)
    if variant == "moe_int8" and cfg.moe is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=1.0,
                                                  a2a_quant="int8"))
    if variant == "sym_state":
        cfg = cfg.replace(taylor=dataclasses.replace(cfg.taylor, sym_state=True))
    return cfg


def _serve_params(cfg: ModelConfig, mesh, rules, device):
    """The rank's blocks of the serve engine's weights (seed 0) and their specs."""
    params = lm_init(init_generator(0, device), cfg, device=device)
    specs = serve_param_specs(params, cfg, mesh, rules)
    return distribute_tree(params, Placements(mesh, specs)), specs


def train_program(cfg: ModelConfig, opt, mesh, rules, shape: str):
    """``(step, (state, batch))`` on meta tensors: the sharded train step of
    ``shape``'s whole batch and this rank's state, from
    ``make_sharded_state_and_step``."""
    batch = materialise(input_specs(cfg, shape))
    state, step, _, _ = make_sharded_state_and_step(cfg, opt, mesh, rules, batch,
                                                    device=META)
    return step, (state, batch)


def prefill_program(cfg: ModelConfig, mesh, rules, shape: str):
    """``(fn, args)`` on meta tensors: ``lm_prefill`` of ``shape``'s whole
    batch in a serve region (this rank's rows of it over "data")."""
    spec = SHAPES[shape]
    params, pspecs = _serve_params(cfg, mesh, rules, META)
    lay = spmd.serve_layout(mesh, rules, spec.batch, slotted=True)

    def fn(params, batch):
        with spmd.region(lay, params, pspecs):
            return lm_prefill(params, {k: spmd.rows(v) for k, v in batch.items()}, cfg,
                              spec.seq)

    return fn, (params, materialise(input_specs(cfg, shape)))


def decode_program(cfg: ModelConfig, mesh, rules, b: int, n_max: int, device=META):
    """``(fn, args)``: one ``lm_decode_step`` of ``b`` slots of ``n_max``
    tokens in a serve region, as the engine's ``decode_scan`` runs it: this
    rank's blocks of the weights and of ``lm_init_caches``' slot cache
    (``slot_cache_specs``), its slots' rows of the whole token and position
    vectors, the logits gathered whole."""
    params, pspecs = _serve_params(cfg, mesh, rules, device)
    lay = spmd.serve_layout(mesh, rules, b, slotted=True)
    caches = lm_init_caches(cfg, b, n_max, device=device)
    caches = distribute_tree(caches, Placements(mesh, slot_cache_specs(cfg, b, n_max, mesh,
                                                                       rules)))
    token = torch.zeros((b,), dtype=torch.int32, device=device)
    pos = torch.zeros((b,), dtype=torch.int32, device=device)

    def fn(params, token, caches, pos):
        with spmd.region(lay, params, pspecs):
            logits, caches = lm_decode_step(params, spmd.rows(token), caches, spmd.rows(pos),
                                            cfg)
            return spmd.all_rows(logits), caches

    return fn, (params, token, caches, pos)


def lower_cell(arch: str, shape: str, mesh, backend=None, variant=None):
    """Trace one cell's rank program on ``mesh``.  Returns (record, records)."""
    cfg = cell_config(arch, backend, variant)
    if shape == "long_500k" and not cfg.supports_long_context:
        raise ValueError(
            "long_500k requires O(1)-state decode (registry state_kind != 'kv')"
        )
    n_params = count_params(cfg)
    n_active = count_active_params(cfg)
    spec = SHAPES[shape]
    rules = rules_for(cfg, mesh, n_params, variant=variant)
    decode_state_bytes = None

    t0 = time.monotonic()
    if spec.kind == "train":
        cfg, opt = training_preset(cfg, n_params)
        fn, args = train_program(cfg, opt, mesh, rules, shape)
        model_flops = 6.0 * n_active * spec.batch * spec.seq
    elif spec.kind == "prefill":
        fn, args = prefill_program(cfg, mesh, rules, shape)
        model_flops = 2.0 * n_active * spec.batch * spec.seq
    elif spec.kind == "decode":
        fn, args = decode_program(cfg, mesh, rules, spec.batch, spec.seq)
        model_flops = 2.0 * n_active * spec.batch
        # per-slot persistent state, summed per layer
        decode_state_bytes = lm_state_bytes(cfg, spec.batch, spec.seq)
    else:
        raise ValueError(spec.kind)
    t_lower = time.monotonic() - t0

    t0 = time.monotonic()
    traced = trace(fn, *args)
    t_trace = time.monotonic() - t0
    n_chips = mesh.size()
    report = roofline_report(traced.counts, traced.records, n_chips, H100,
                             model_flops=model_flops)
    print(f"[dryrun] peak live bytes {traced.peak_bytes:.4e}; flops={traced.counts['flops']:.3e} "
          f"bytes={traced.counts['bytes']:.3e}; {len(traced.records)} collectives")
    record = {
        "arch": arch,
        "shape": shape,
        # per-layer description under a hybrid schedule ("taylor+softmax_window")
        "backend": cfg.backend_desc if not cfg.is_attention_free else "ssm",
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_chips": n_chips,
        "n_params": n_params,
        "n_active_params": n_active,
        "memory": {"peak_live_bytes": traced.peak_bytes},
        "hbm_peak_bytes_per_chip": traced.peak_bytes,
        "fits_hbm": bool(traced.peak_bytes <= H100.hbm_bytes),
        "cost": traced.counts,
        "roofline": report,
        "lower_s": t_lower,    # building the rank's state (meta)
        "compile_s": t_trace,  # tracing its program (nothing compiles)
        "n_collectives": len(traced.records),
    }
    if decode_state_bytes is not None:
        record["decode_state_bytes"] = decode_state_bytes
    return record, traced.records


def cell_path(arch, shape, mesh_name, backend, variant=None):
    tag = f"_{backend}" if backend else ""
    if variant:
        tag += f"_{variant}"
    return ARTIFACT_DIR / f"{arch}_{shape}_{mesh_name}{tag}.json"


def _save_records(path: Path, records) -> str:
    out = path.with_suffix(".records.jsonl")
    with open(out, "w") as f:
        for r in records:
            f.write(json.dumps(list(r)) + "\n")
    return str(out)


def run_cell(arch, shape, mesh, backend=None, force=False, save_records=False, variant=None):
    mesh_name = "x".join(str(s) for s in mesh.shape)
    path = cell_path(arch, shape, mesh_name, backend, variant)
    if path.exists() and not force:
        print(f"[dryrun] skip (exists): {path}")
        with open(path) as f:
            return json.load(f)
    print(f"[dryrun] === {arch} × {shape} × mesh {mesh_name}"
          + (f" × {backend}" if backend else "")
          + (f" × {variant}" if variant else "") + " ===")
    try:
        record, records = lower_cell(arch, shape, mesh, backend=backend, variant=variant)
        record["status"] = "ok"
        record["variant"] = variant
    except Exception as e:  # a cell that fails is recorded, and the sweep goes on
        record = {
            "arch": arch, "shape": shape, "mesh": mesh_name, "backend": backend,
            "status": "error", "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        }
        records = None
        print(f"[dryrun] FAILED: {record['error']}")
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    if save_records and records is not None:
        record["records_path"] = _save_records(path, records)
    with open(path, "w") as f:
        json.dump(record, f, indent=2, default=str)
    if record["status"] == "ok":
        r = record["roofline"]
        print(f"[dryrun] {arch}×{shape}: compute={r['compute_s']:.4f}s "
              f"memory={r['memory_s']:.4f}s collective={r['collective_s']:.4f}s "
              f"dominant={r['dominant']} fits_hbm={record['fits_hbm']} "
              f"(trace {record['compile_s']:.1f}s)")
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=("pod", "multipod"), default="pod")
    ap.add_argument("--backend", choices=("softmax", "taylor", "linear_elu"))
    ap.add_argument("--all", action="store_true", help="sweep all applicable cells")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--save-records", action="store_true",
                    help="write the rank's collective records beside each cell's JSON")
    ap.add_argument("--variant", choices=list(VARIANTS))
    args = ap.parse_args(argv)

    mesh = abstract_production_mesh(multi_pod=(args.mesh == "multipod"))
    print(f"[dryrun] mesh {mesh.shape} axes {mesh.mesh_dim_names} ({mesh.size()} ranks; "
          f"tracing rank {mesh.coords})")

    if args.all:
        ok = failed = 0
        for arch in ARCHS:
            for shape in applicable_shapes(cell_config(arch, args.backend)):
                rec = run_cell(arch, shape, mesh, backend=args.backend, force=args.force,
                               save_records=args.save_records)
                ok += rec["status"] == "ok"
                failed += rec["status"] != "ok"
        print(f"[dryrun] sweep done: {ok} ok, {failed} failed")
        raise SystemExit(1 if failed else 0)

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all)")
    rec = run_cell(args.arch, args.shape, mesh, backend=args.backend, force=args.force,
                   save_records=args.save_records, variant=args.variant)
    raise SystemExit(0 if rec["status"] == "ok" else 1)


if __name__ == "__main__":
    main()
