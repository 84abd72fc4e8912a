#!/usr/bin/env python3
"""Times builds of the Taylor forward kernel source against each other on one
NVIDIA GPU.

Compiles each given ``taylor_fwd.cu`` with the package's nvcc flags (one nvcc
per source, all started together) into ``build/ab/``, loads each through the
package's own binding (``kernel.bind``, ``kernel.launch_fwd``), holds each
against the plain PyTorch version at chip_smoke.py's phase 3 cases with its
checks (``FWD_CASES``, ``fwd_errors``), and times them in turns (A B … B A,
``--rounds`` times) with CUDA events on one card.  Prints the card's name and
power limit first.  For comparing a change with its parent:

    git show HEAD:src/repro_torch/kernels/taylor_attention/csrc/taylor_fwd.cu \\
        > build/parent_taylor_fwd.cu
    python3 tools/ab_taylor_fwd.py build/parent_taylor_fwd.cu \\
        src/repro_torch/kernels/taylor_attention/csrc/taylor_fwd.cu
"""

from __future__ import annotations

import argparse
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def build(K, sources):
    """One library per source, compiled in parallel and bound by
    ``K.bind``; prints ptxas's d = 64 summary of each."""
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        key = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:12]
        lib = out_dir / f"{i}_{Path(src).stem}_{key}.so"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib, src))
    libs = []
    for proc, lib, src in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
        for line in cs.ptxas_summary(log):
            print(f"[build] {src}: {line}")
        libs.append(K.bind(lib, "taylor_fwd"))
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", help="taylor_fwd.cu files to compare")
    ap.add_argument("--rounds", type=int, default=2, help="A B … B A rounds")
    ap.add_argument("--iters", type=int, default=10, help="launches per timing")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_taylor_fwd: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.feature_map import layernorm_no_affine as ln
    from repro_torch.kernels.taylor_attention import kernel as K
    from repro_torch.kernels.taylor_attention.ref import taylor_attention_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    libs = build(K, args.sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    ok = True
    for m, dname in cs.FWD_CASES:
        q, k, v = cs.fwd_inputs(torch, m, getattr(torch, dname), gen, ln)
        ref32 = taylor_attention_ref(q.float()[None], k.float()[None], v.float()[None],
                                     alpha=3.0)[0]
        run = lambda lib: K.launch_fwd(lib, q, k, v, 3.0, 2)
        checks = []
        for lib in libs:
            errs, bad = cs.fwd_errors(torch, run(lib), ref32)
            checks.append(" ".join(f"{k_}_err={e_:.3e}" for k_, e_ in errs.items())
                          + (f" FAILED {bad}" if bad else ""))
            ok &= not bad
        order = (list(range(len(libs))) + list(reversed(range(len(libs))))) * args.rounds
        times = {i: [] for i in range(len(libs))}
        for i in order:
            times[i].append(cs.cuda_ms(torch, lambda: run(libs[i]), args.iters))
        for i, src in enumerate(args.sources):
            t = times[i]
            print(f"[ab] {dname} n={m['n']} {src}: {checks[i]} "
                  f"ms mean={sum(t) / len(t):.4f} min={min(t):.4f} max={max(t):.4f} "
                  f"samples={' '.join(f'{x:.4f}' for x in t)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
