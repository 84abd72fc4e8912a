"""A copy of the benchmark with tiny cells, for the CPU tests: the same
harness files, a configuration of each architecture at a few dozen widths,
and cells whose traffic and limits fit a CPU run of seconds."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TRAIN = "granite-20b-x4.train-4k"

# tiny sizes of each configuration; "base" names the configuration file a
# tiny one starts from where it has none of its own.  "hybrid" is the
# port's zamba2-7b layout (Mamba2 blocks beside one shared attention
# block), which no cell runs yet: its reference is held to the port here.
TINY = {
    "granite-20b-x4": dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128,
                           vocab=128, n_groups=2, attn_chunk=16, context=256),
    "hybrid": dict(base="granite-20b-x4", d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
                   d_ff=128, vocab=128, n_groups=2, attn_chunk=16, context=256, act="silu",
                   norm="rmsnorm", norm_eps=1e-6, pos="rope", rope_theta=10000.0,
                   pattern=["mamba", "mamba", "shared_attn"], tail=["mamba"],
                   ssm=dict(d_state=8, expand=2, head_dim=16, conv_width=4, n_groups=1)),
}

# an open-loop serving cell at a CPU's sizes (the kind ``serve_open``, which
# no cell of BENCHMARK.json runs yet) and the metrics such a cell reports;
# its limit is the one PERF.md gives for granite-20b-x4 served
SERVE = {
    "chips": 1, "why": "tiny open-loop serving",
    "traffic": {"kind": "serve_open", "arrivals": "poisson", "rate_per_s": 4.0,
                "prompt": {"dist": "loguniform", "lo": 8, "hi": 96},
                "output": {"dist": "uniform", "lo": 2, "hi": 12},
                "slots": 4, "decode_block": 4, "n_max": 256, "drain_s": 60, "sample": 3},
    "precision": {"dtype": "bfloat16", "param_dtype": "bfloat16"},
    "limits": {"logit_gap": 0.08},
}
SERVE_METRICS = {
    "end_to_end": [
        {"name": "ttft_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock"},
        {"name": "tpot_p95_ms", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock"},
        {"name": "output_tokens_per_s", "unit": "tokens/s", "better": "higher", "bound": 0.05,
         "source": "host_clock"},
    ],
    "per_layer": [
        {"name": "prefill_tokens_per_s.serve", "unit": "tokens/s", "better": "higher",
         "source": "program_counter", "layer": "admission and prefill", "moves": "ttft_p95_ms"},
        {"name": "decode_block_ms.serve", "unit": "ms", "better": "lower",
         "source": "program_span", "layer": "decode loop", "moves": "tpot_p95_ms"},
        {"name": "device_idle.serve", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "tpot_p95_ms"},
    ],
}


def tiny_config(name: str) -> dict:
    over = dict(TINY[name])
    base = over.pop("base", name)
    cfg = json.loads((REPO / "portbench" / "configs" / f"{base}.json").read_text())
    cfg.update(over, name=f"tiny-{name}")
    return cfg


def make_copy(root: Path, cells: dict) -> Path:
    """A checkout under ``root`` with the harness, ``src`` linked, and the
    tiny ``cells`` ({cell name: cell dict}) beside tiny configurations;
    ``BENCHMARK.json`` lists each cell under every metric of its kind."""
    shutil.copytree(REPO / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "src").symlink_to(REPO / "src")
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for name in TINY:
        cfg = tiny_config(name)
        (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    for cell_name, cell in cells.items():
        (root / "portbench" / "workloads" / f"{cell_name}.json").write_text(json.dumps(cell))
        if cell["traffic"]["kind"] == "serve_open":
            for kind, entries in SERVE_METRICS.items():
                bench[kind] += [dict(m, workloads=[cell_name]) for m in entries]
            continue
        for m in bench["end_to_end"] + bench["per_layer"]:
            if TRAIN in m.get("workloads", []):
                m["workloads"].append(cell_name)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def tiny_cell(kind: str, config: str = "granite-20b-x4", **over) -> dict:
    """A tiny cell of traffic ``kind`` ("train": the benchmark's training
    cell; "serve": ``SERVE``) on the tiny ``config``, with its limits.  It
    runs in float32, where a sound run reads far under them (at a few dozen
    widths bf16's rounding does not average out as it does at the cells'
    widths), so that only a planted fault crosses them."""
    if kind == "train":
        cell = json.loads((REPO / "portbench" / "workloads" / f"{TRAIN}.json").read_text())
        cell["traffic"].update(seq=64)
    else:
        cell = json.loads(json.dumps(SERVE))
    cell["config"] = f"tiny-{config}"
    cell["precision"] = dict(cell["precision"], dtype="float32", param_dtype="float32")
    cell.update(over)
    return cell


def run(copy: Path, argv: list):
    """Runs the copy's run.py in this process on the CPU: (exit code, the
    result line as a dict or None, standard error).  A test worker may hold
    modules that other test files loaded, so the run's check of the
    packages it must not load looks only at those the run itself added."""
    spec_name = f"portbench_run_{abs(hash(str(copy)))}"
    import importlib.util

    spec = importlib.util.spec_from_file_location(spec_name, copy / "portbench" / "run.py")
    mod = importlib.util.module_from_spec(spec)
    out, err = io.StringIO(), io.StringIO()
    saved = list(sys.path)
    held = {name.split(".")[0] for name in sys.modules}
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            spec.loader.exec_module(mod)
            mod.forbidden_modules = lambda: sorted(
                {name.split(".")[0] for name in sys.modules} - held & set(mod.FORBIDDEN))
            code = mod.main(argv, device="cpu")
    finally:
        sys.path[:] = saved
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if code == 0 and lines else None
    return code, result, err.getvalue()
