"""Runs one cell of the port's benchmark once and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is ``portbench/workloads/<cell>.json``; it names its configuration
(``portbench/configs/<config>.json``) and its traffic kind, whose driver is
``portbench/kinds/<kind>.py``.  The kind sets up, warms up, measures for
``--seconds`` and runs the check; this file turns what it returns into the
result.  With ``--trace 0`` the metrics are the cell's end-to-end metrics
of ``BENCHMARK.json``; with ``--trace 1`` the window runs under the profiler
and the metrics are the cell's per-layer metrics, each read by its reader
``portbench/metrics/<metric>.py`` (a reader that finds nothing to read
returns None, and the metric is left out; a reader's ``OPS`` names the
dispatcher ops whose calls it reads).

The last lines on standard error are each compared number beside its limit;
the last line on standard output is the result::

    {"correct", "attempted", "failed", "metrics", "device"[, "breakdown"], "checks"}

It needs CUDA cards (as many as the cell's ``chips``) and exits 3 without
them, printing no result.  It exits 4 if ``jax``, ``jaxlib``, ``flax`` or
the JAX package ``repro`` is loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# run as a script, Python puts this folder first on the path, where its
# modules would shadow the standard library's; the checkout's root serves
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != BENCH]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class Harness:
    """What a kind's ``run(h)`` reads: the cell, its configuration, the
    run's arguments, the device, the tracer and the process's start."""

    def __init__(self, cell, config, seed, seconds, device, tracer):
        self.cell, self.config = cell, config
        self.seed, self.seconds = seed, seconds
        self.device, self.tracer = device, tracer
        self.t0 = T0


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, traced: bool) -> list:
    """The metric entries of ``BENCHMARK.json`` that this cell reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None, device=None) -> int:
    """``device`` (a test's "cpu") skips the look for cards."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = _load_json(BENCH / "workloads" / f"{args.workload}.json")
    config = _load_json(BENCH / "configs" / f"{cell['config']}.json")
    bench = _load_json(ROOT / "BENCHMARK.json")
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from portbench.tracing import Tracer, summarise

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: the cell needs {cell['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
        device = "cuda"
    device = torch.device(device)
    torch.set_num_threads(min(4, torch.get_num_threads()))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    name = cell["traffic"]["kind"]
    kind = _load_module(BENCH / "kinds" / f"{name}.py", f"portbench_kind_{name}")
    wanted = cell_metrics(bench, args.workload, bool(args.trace))
    readers = {m["name"]: _load_module(BENCH / "metrics" / f"{m['name']}.py",
                                       "portbench_metric_" + m["name"].replace(".", "_"))
               for m in wanted} if args.trace else {}
    ops = {op for r in readers.values() for op in getattr(r, "OPS", ())}
    tracer = Tracer(bool(args.trace))
    out = kind.run(Harness(cell, config, args.seed, args.seconds, device, tracer))
    t_run = time.perf_counter()

    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in the measuring process: {', '.join(found)}",
              file=sys.stderr)
        return 4

    summary = summarise(tracer.prof, ops) if args.trace else None
    values = dict(out["e2e"], setup_s=out["setup_s"])
    ctx = {"cell": cell, "config": config, "layer": out["layer"], "trace": summary}
    metrics = {}
    for m in wanted:
        value = readers[m["name"]].read(ctx) if args.trace else values.get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = cell["limits"]
    checks = {name: {"value": v, "limit": limits[name]} for name, v in out["numbers"].items()}
    correct = out["failed"] == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev.update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    print(f"portbench: seconds from start: run {t_run - T0:.1f}, trace read "
          f"{time.perf_counter() - t_run:.1f}", file=sys.stderr)
    print(f"portbench: failed {out['failed']} of {out['attempted']} (limit 0)", file=sys.stderr)
    for name, c in checks.items():
        print(f"portbench: {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
