"""Finds a serving cell's knee: the highest offered rate whose backlog does
not grow, by one open-loop window per rate on one engine.

    python3 portbench/tools/sweep.py --workload <cell> --seed S --rates 1 2 3 --seconds 40

For each rate it prints one JSON line: the requests offered, the queue left
at the window's close, the ttft p50/p95 of the first and the second half of
the requests (a backlog that grows shows as a second half far slower than
the first), the tpot p95, the output tokens finished in the window per
second, and the seconds the drain took.  Needs a CUDA card.
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
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    args = ap.parse_args(argv)
    import os

    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    from portbench import traffic
    from portbench.kinds import serve_open as serve
    from portbench.run import Harness
    from portbench.tracing import Tracer

    cell = json.loads((ROOT / "portbench" / "workloads" / f"{args.workload}.json").read_text())
    cfg = json.loads((ROOT / "portbench" / "configs" / f"{cell['config']}.json").read_text())
    if not torch.cuda.is_available():
        print("sweep: needs a CUDA card", file=sys.stderr)
        return 3
    h = Harness(cell, cfg, args.seed, args.seconds, torch.device("cuda"), Tracer(False))
    engine, _ = serve.build(h)
    for rate in args.rates:
        tr = dict(cell["traffic"], rate_per_s=rate)
        arrivals = traffic.open_loop(args.seed, tr, args.seconds, cfg["vocab"])
        t = time.perf_counter()
        out = serve.window(h, engine, arrivals)
        drain = time.perf_counter() - t - args.seconds
        half = len(out["ttft"]) // 2
        first, second = out["ttft"][:half], out["ttft"][half:]
        print(json.dumps({
            "rate_per_s": rate, "offered": len(arrivals), "queue_at_close": out["queue_at_close"],
            "ttft_p50_ms": [traffic.percentile(first, 50), traffic.percentile(second, 50)],
            "ttft_p95_ms": [traffic.percentile(first, 95), traffic.percentile(second, 95)],
            "tpot_p95_ms": traffic.percentile(out["tpot"], 95),
            "output_tokens_per_s": out["served"] / args.seconds, "drain_s": drain,
            "missing": sum(x == float("inf") for x in out["ttft"]),
            "decode_block_ms": 1e3 * out["stats"]["decode_seconds"]
            / max(1, out["stats"]["decode_dispatches"]),
            "prefill_tokens_per_s": out["stats"]["prefill_tokens"]
            / max(1e-9, out["stats"]["prefill_seconds"]),
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
