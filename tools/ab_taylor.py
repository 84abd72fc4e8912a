#!/usr/bin/env python3
"""Times builds of a Taylor kernel source against each other on one NVIDIA GPU.

Compiles each given ``taylor_fwd.cu`` or ``taylor_bwd.cu`` with the package's
nvcc flags and ``csrc/`` on the include path (one nvcc per source, all
started together) into ``build/ab/``, tells forward from backward builds by
the symbols they export, and loads each through the package's own binding
(``kernel.bind``).  Holds each against the plain PyTorch versions with
chip_smoke.py's checks at its cases (forward: phase 3's ``FWD_CASES`` and
``fwd_errors``; backward: phase 3b's ``BWD_CASES`` and ``bwd_check``, every
gradient within ``BWD_TOL`` of the float64 plain version; then phase 12's
zoo launches, ``ZOO_CASES``, zamba2's head dim 112 padded to 128 as the
wrapper pads it), and times each
kernel of each build in turns (A B … B A, ``--rounds`` times) with CUDA
events on one card.  Prints the
card's name and power limit first; exits 1 if a build fails a check.  For
comparing a change with its parent:

    git show HEAD:src/repro_torch/kernels/taylor_attention/csrc/taylor_bwd.cu \\
        > build/parent_taylor_bwd.cu
    python3 tools/ab_taylor.py build/parent_taylor_bwd.cu \\
        src/repro_torch/kernels/taylor_attention/csrc/taylor_bwd.cu
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def build(K, sources):
    """(kind, libraries): one library per source, compiled in parallel and
    bound by ``K.bind`` as ``taylor_bwd`` if it exports the backward's
    launchers, else as ``taylor_fwd``; prints ptxas's d = 64 summary of
    each.  All sources must be of one kind."""
    out_dir = ROOT / "build" / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for i, src in enumerate(sources):
        key = hashlib.sha256(Path(src).read_bytes()).hexdigest()[:12]
        lib = out_dir / f"{i}_{Path(src).stem}_{key}.so"
        cmd = [K._nvcc(), *K.NVCC_FLAGS, "-I", str(K.CSRC), "-o", str(lib), str(src)]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True), lib, src))
    paths = []
    for proc, lib, src in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {src}:\n{log}")
        for line in cs.ptxas_summary(log):
            print(f"[build] {src}: {line}")
        paths.append(lib)
    kinds = {"taylor_bwd" if hasattr(ctypes.CDLL(str(p)), "taylor_bwd_dq_launch")
             else "taylor_fwd" for p in paths}
    if len(kinds) != 1:
        raise SystemExit("give forward sources or backward sources, not both")
    kind = kinds.pop()
    return kind, [K.bind(p, kind) for p in paths]


def fwd_case(torch, K, ref_mod, ln, libs, m, dname, gen):
    """Phase 3's check of each library at one case: [(errors, failures,
    {kernel: launch})]."""
    q, k, v = cs.fwd_inputs(torch, m, getattr(torch, dname), gen, ln)
    qp, kp, alpha = cs.padded_qk(torch, K, q, k)
    ref32 = ref_mod.taylor_attention_ref(q.float()[None], k.float()[None], v.float()[None],
                                         alpha=3.0)[0]
    results = []
    for lib in libs:
        run = lambda lib=lib: K.launch_fwd(lib, qp, kp, v, alpha, 2)
        errs, bad = cs.fwd_errors(torch, run(), ref32)
        results.append((errs, bad, {"fwd": run}))
    return results


def bwd_case(torch, K, ref_mod, ln, libs, m, dname, gen):
    """Phase 3b's check of each library at one case, as ``fwd_case``: pass 2
    runs on the library's own pass-1 rows."""
    q, k, v, dout = cs.bwd_inputs(torch, m, getattr(torch, dname), gen, ln)
    qp, kp, alpha = cs.padded_qk(torch, K, q, k)
    d = q.shape[-1]
    out = K.taylor_fwd(qp, kp, v, alpha=alpha)
    results = []
    for lib in libs:
        # padded q and k in; dq and dk sliced back to the true head dim
        def dq_fn(q, k, v, dout, out, lib=lib):
            dq, den, dden = K.launch_bwd_dq(lib, *cs.padded_qk(torch, K, q, k)[:2], v, dout,
                                            out, alpha, 2)
            return dq[..., :d], den, dden

        def dkv_fn(q, k, v, dout, den, dden, lib=lib):
            dk, dv = K.launch_bwd_dkv(lib, *cs.padded_qk(torch, K, q, k)[:2], v, dout, den,
                                      dden, alpha, 2)
            return dk[..., :d], dv

        errs, _, bad, rows = cs.bwd_check(torch, ref_mod, q, k, v, dout, out, dq_fn, dkv_fn)
        results.append((errs, bad, {
            "dq": lambda lib=lib: K.launch_bwd_dq(lib, qp, kp, v, dout, out, alpha, 2),
            "dkv": lambda lib=lib, r=rows: K.launch_bwd_dkv(lib, qp, kp, v, dout, *r, alpha,
                                                            2)}))
    return results


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+",
                    help="taylor_fwd.cu or taylor_bwd.cu files to compare")
    ap.add_argument("--rounds", type=int, default=2, help="A B … B A rounds")
    ap.add_argument("--iters", type=int, default=10, help="launches per timing")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ab_taylor: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.core.feature_map import layernorm_no_affine as ln
    from repro_torch.kernels.taylor_attention import kernel as K
    from repro_torch.kernels.taylor_attention import ref as ref_mod

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    kind, libs = build(K, args.sources)
    cases, check, seed = ((cs.BWD_CASES, bwd_case, 1) if kind == "taylor_bwd"
                          else (cs.FWD_CASES, fwd_case, 0))
    cases += cs.ZOO_CASES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    ok = True
    for m, dname in cases:
        results = check(torch, K, ref_mod, ln, libs, m, dname, gen)
        order = (list(range(len(libs))) + list(reversed(range(len(libs))))) * args.rounds
        times = {i: {kname: [] for kname in results[i][2]} for i in range(len(libs))}
        for i in order:
            for kname, run in results[i][2].items():
                times[i][kname].append(cs.cuda_ms(torch, run, args.iters))
        for i, src in enumerate(args.sources):
            errs, bad, _ = results[i]
            ok &= not bad
            stats = " ".join(
                f"{kname}_ms mean={sum(t) / len(t):.4f} min={min(t):.4f} max={max(t):.4f} "
                f"samples={' '.join(f'{x:.4f}' for x in t)};"
                for kname, t in times[i].items())
            print(f"[ab] {kind} {cs.case_name(m, dname)} {src}: "
                  + " ".join(f"{k_}_err={e_:.3e}" for k_, e_ in errs.items())
                  + (f" FAILED {bad}" if bad else "") + f" {stats}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
