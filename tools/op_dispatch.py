#!/usr/bin/env python3
"""Times the Taylor kernels' op route against their direct launches on one NVIDIA GPU.

Each kernel is a ``torch.library`` custom op (``repro_torch::taylor_fwd``,
``taylor_bwd_dq``, ``taylor_bwd_dkv``) whose CUDA implementation calls its
ctypes launcher (``kernel.launch_fwd``, ``launch_bwd_dq``,
``launch_bwd_dkv``).  At each shape this script times three routes to each
kernel on the same inputs:

    wrapper  ``kernel.taylor_fwd`` etc.: the checks, then the op
    op       ``torch.ops.repro_torch.taylor_fwd`` etc.
    launch   the launcher itself, as the wrappers called it before the ops

in turns (wrapper, op, launch, launch, op, wrapper; ``--rounds`` times),
each timing ``--iters`` calls back to back: the device's ms per call from
CUDA events (a call the host issues faster than the card runs it costs
the card's time; one it issues slower, the host's) and the host's µs per
call to issue them.  The shapes are chip_smoke.py's: phase 3's main launch
(``MAIN``, bf16, ~2 ms a kernel) and phase 12's reduced qwen2-1.5b launch
(``ZOO_ATTN["qwen2-1.5b reduced"]``, bf16, tens of µs a kernel), where a
host cost would show first.  Prints the card's name and power limit first,
then a line per (shape, kernel, round), the medians, and a JSON line of
the medians last.  Exits 1 if the op and the launch disagree beyond
chip_smoke.py's tolerances.

    python3 tools/op_dispatch.py --rounds 5 --iters 200
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SHAPES = {"phase 3 main": cs.MAIN, "reduced qwen2-1.5b": cs.ZOO_ATTN["qwen2-1.5b reduced"]}
ROUTES = ("wrapper", "op", "launch")
ALPHA, ORDER = 3.0, 2


def routes(torch, K, m, gen, ln):
    """{kernel: {route: call}} at shape ``m`` in bf16, all on one set of
    inputs (pass 2 on pass 1's rows)."""
    q, k, v, dout = cs.bwd_inputs(torch, m, torch.bfloat16, gen, ln)
    fwd_lib, bwd_lib = (K.bind(path, name) for name, path in K.build().items())
    ops = torch.ops.repro_torch
    out = K.taylor_fwd(q, k, v, alpha=ALPHA, order=ORDER)
    _, den, dden = K.taylor_bwd_dq(q, k, v, dout, out, alpha=ALPHA, order=ORDER)
    return {
        "taylor_fwd": {
            "wrapper": lambda: K.taylor_fwd(q, k, v, alpha=ALPHA, order=ORDER),
            "op": lambda: ops.taylor_fwd(q, k, v, ALPHA, ORDER),
            "launch": lambda: K.launch_fwd(fwd_lib, q, k, v, ALPHA, ORDER)},
        "taylor_bwd_dq": {
            "wrapper": lambda: K.taylor_bwd_dq(q, k, v, dout, out, alpha=ALPHA, order=ORDER),
            "op": lambda: ops.taylor_bwd_dq(q, k, v, dout, out, ALPHA, ORDER),
            "launch": lambda: K.launch_bwd_dq(bwd_lib, q, k, v, dout, out, ALPHA, ORDER)},
        "taylor_bwd_dkv": {
            "wrapper": lambda: K.taylor_bwd_dkv(q, k, v, dout, den, dden, alpha=ALPHA,
                                                order=ORDER),
            "op": lambda: ops.taylor_bwd_dkv(q, k, v, dout, den, dden, ALPHA, ORDER),
            "launch": lambda: K.launch_bwd_dkv(bwd_lib, q, k, v, dout, den, dden, ALPHA,
                                               ORDER)},
    }


def disagreement(torch, a, b) -> float:
    """Max over outputs of max |a - b| / max |b|."""
    a, b = (x if isinstance(x, tuple) else (x,) for x in (a, b))
    return max(float((x.float() - y.float()).abs().max() / y.float().abs().max())
               for x, y in zip(a, b))


def timed(torch, fn, iters: int):
    """(device ms per call, host µs per call) over ``iters`` calls, warm."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host_us = (time.perf_counter() - t0) / iters * 1e6
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, host_us


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=5, help="turns of the six timings")
    ap.add_argument("--iters", type=int, default=200, help="calls per timing")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("op_dispatch: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.feature_map import layernorm_no_affine as ln
    from repro_torch.kernels.taylor_attention import kernel as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    K.build()
    print(f"built {', '.join(K.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok, summary = True, {}
    for sname, m in SHAPES.items():
        for kname, calls in routes(torch, K, m, gen, ln).items():
            # the forward is deterministic; the backward adds with f32 atomics
            err = disagreement(torch, calls["op"](), calls["launch"]())
            tol = 0.0 if kname == "taylor_fwd" else cs.BWD_TOL
            if not err <= tol:
                print(f"{sname} {kname}: op and launch disagree by {err:.3e} (tol {tol})")
                ok = False
            got = {r: {"ms": [], "host_us": []} for r in ROUTES}
            for i in range(args.rounds):
                for route in ROUTES + ROUTES[::-1]:
                    ms, host_us = timed(torch, calls[route], args.iters)
                    got[route]["ms"].append(ms)
                    got[route]["host_us"].append(host_us)
                print(f"{sname} {kname} round {i}: " + "  ".join(
                    f"{r} {statistics.mean(got[r]['ms'][-2:]):.4f} ms "
                    f"({statistics.mean(got[r]['host_us'][-2:]):.1f} µs host)"
                    for r in ROUTES))
            med = {r: {k_: statistics.median(v_) for k_, v_ in got[r].items()} for r in ROUTES}
            print(f"{sname} {kname} {m} median of {2 * args.rounds} × {args.iters} calls: "
                  + "  ".join(f"{r} {med[r]['ms']:.4f} ms ({med[r]['host_us']:.1f} µs host)"
                              for r in ROUTES)
                  + f"  op - launch {(med['op']['ms'] - med['launch']['ms']) * 1e3:+.1f} µs "
                  f"device, {med['op']['host_us'] - med['launch']['host_us']:+.1f} µs host"
                  f"  (op/launch disagree {err:.1e})")
            summary[f"{sname}/{kname}"] = med
    print(json.dumps({"op_dispatch": summary}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
