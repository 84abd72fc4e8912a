"""Readings that the Zamba2 cell's limits are set from, many seeds in one
process (``calibrate.py`` for the kind ``train_zamba2``).

    python3 portbench/tools/calibrate_zamba2.py --seeds S1 S2 ... \
        [--control-seeds C1 C2 C3] [--workload <cell>]

For every seed it prints one JSON line with the compared numbers of the
program against the plain reference, with the leaf that sets each leaf
gap.  For each control seed it adds the control's numbers (the reference in
fp8 products put in the program's place) and the half-batch fault's (the
reference with the loss over half of each row put in the program's place).
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _worst(got: dict, want: dict, keep=None) -> str:
    keys = list(want if keep is None else keep)
    median = statistics.median(want[k] for k in keys)
    key = max(keys, key=lambda k: abs(got[k] - want[k]) / max(want[k], median, 1e-30))
    return "/".join(key)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="zamba2-7b-instruct-x27.train-4k")
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from portbench import compare
    from portbench.kinds import train_zamba2 as kind
    from portbench.run import Harness
    from portbench.tracing import Tracer

    cell = json.loads((ROOT / "portbench" / "workloads" / f"{args.workload}.json").read_text())
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{cell['config']}.json").read_text())
    if not torch.cuda.is_available():
        print("calibrate_zamba2: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")

    def judged(got, want):
        out = kind.train.numbers(got, want)  # the loss gap too, which the cell leaves out
        out["worst_grad"] = _worst(got[1], want[1])
        out["worst_delta"] = _worst(got[2], want[2], compare.moved_leaves(want[1]))
        return out

    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t = time.perf_counter()
        h = Harness(cell, cfg, seed, 0.0, dev, Tracer(False))
        line = {"seed": seed}
        state, step, batch, got = kind.prepare(h)
        line["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        del state, step
        kind.free(dev)
        want = kind.reference(h, cfg, cell, batch)
        if seed in args.seeds:
            line["program"] = judged(got, want)
        if seed in args.control_seeds:
            line["control"] = judged(kind.reference(h, cfg, cell, batch, "fp8"), want)
            line["half_batch"] = judged(kind.reference(h, cfg, cell, batch, half=True), want)
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
