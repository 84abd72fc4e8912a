"""Readings that a cell's limits are set from, many seeds in one process.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds S1 S2 ... \
        [--control-seeds C1 C2 C3] [--seconds 20]

For every seed it prints one JSON line with the compared numbers of the
program against the plain reference (the lower readings).  For each control
seed it adds the control's numbers, the reference computed in the precision
below the cell's (fp8) put in the program's place, and those of the faults
the cell can have, planted in the reference put in the program's place: a
training cell's loss taken over half of each batch, a serving cell's served
token altered where it is produced.  A training step that returns its state
unchanged reads 1 by the leaf-gap measure and needs no run.

A training cell runs its checked steps with no window; a serving cell runs
a window of ``--seconds`` at its own load, drains it, and compares the
sample a run compares.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != Path(__file__).resolve().parent]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import numpy as np
    import torch

    from portbench.run import Harness
    from portbench.tracing import Tracer

    cell = json.loads((ROOT / "portbench" / "workloads" / f"{args.workload}.json").read_text())
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{cell['config']}.json").read_text())
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    kind = cell["traffic"]["kind"]
    for seed in args.seeds + [s for s in args.control_seeds if s not in args.seeds]:
        t = time.perf_counter()
        h = Harness(cell, cfg, seed, args.seconds, dev, Tracer(False))
        line = {"seed": seed}
        if kind == "train":
            from portbench.kinds import train

            state, step, batch, got = train.prepare(h)
            del state, step
            train.free(dev)
            want = train.reference(h, cfg, cell, batch)
            if seed in args.seeds:
                line["program"] = train.numbers(got, want)
            if seed in args.control_seeds:
                line["control"] = train.numbers(train.reference(h, cfg, cell, batch, "fp8"), want)
                line["half_batch"] = train.numbers(
                    train.reference(h, cfg, cell, batch, half=True), want)
        else:
            from portbench.kinds import serve_open as serve

            out = serve.serve(h)
            picked = serve.sample(seed, out["done"], cell["traffic"]["sample"])
            line["failed"] = sum(np.isinf(out["ttft"]))
            line["served_tokens_compared"] = int(sum(len(t) for _, t in picked))
            if seed in args.seeds:
                line["program"] = {"logit_gap": serve.reference_gap(h, cfg, picked, out["dtype"])}
            if seed in args.control_seeds:
                line["control"] = {"logit_gap": serve.reference_gap(
                    h, cfg, picked, out["dtype"], quant="fp8")}
                rng = np.random.default_rng(seed)
                altered = []
                for a, toks in picked:
                    toks = toks.copy()
                    i = int(rng.integers(len(toks)))
                    toks[i] = (toks[i] + 1 + int(rng.integers(cfg["vocab"] - 1))) % cfg["vocab"]
                    altered.append((a, toks))
                line["token_altered"] = {"logit_gap": serve.reference_gap(
                    h, cfg, altered, out["dtype"])}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
