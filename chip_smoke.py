#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout (one nvcc per
source, in parallel), holds each against its plain PyTorch version, drives
smollm-135m's full-width inference forward, its serving engine and its
training step (random weights from a seed), cross-checks them, runs the
same model on the paper's baselines (softmax, sliding-window softmax,
elu+1 linear, Taylor order 1), then the Based-style hybrid (taylor and
sliding-window layers interleaved) and the Taylor variants (sym_state,
decay, non-causal), then serving under load (phase 10: chunked prefill,
the SLO scheduler with a preemption, the standard fault trace, a replayed
Poisson trace and the health sweep's price), and prints one JSON line
describing every ported kernel followed by the device line.
Any failed phase exits non-zero.  Needs a CUDA device.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# Published peaks of one H100 SXM (dense): f32 on the CUDA cores, TF32 on the
# tensor cores, HBM bandwidth.
F32_FLOPS = 67e12
TF32_FLOPS = 495e12
HBM_BYTES = 3.35e12
# TF32 products per operation of each tensor-core contraction of
# csrc/taylor_fwd.cu, as it issues them: the f32 operand is split in two, and
# bf16 q and k are exact in TF32, so the z2 update of bf16 keys takes one.
FWD_TF32_PRODUCTS = {
    "bfloat16": {"s2_read": 2, "z2_read": 2, "s2_update": 2, "z2_update": 1},
    "float32": {"s2_read": 3, "z2_read": 3, "s2_update": 3, "z2_update": 3},
}

# The same for the backward's contractions (csrc/taylor_bwd.cu): pass 1's S2
# and z2 reads and its state update, pass 2's carry read (one product for dk
# and dv), dz2 read and carry update.  Only pass 1's z2 update takes one
# product for bf16 inputs (A = k_e is exact); pass 2's dz2 update has
# A = dden·q_e, which is not.
BWD_TF32_PRODUCTS = {
    "bfloat16": {"s2_read": 2, "z2_read": 2, "s2_update": 2, "z2_update": 1,
                 "carry_read": 2, "dz2_read": 2, "ds2_update": 2, "dz2_update": 2},
    "float32": dict.fromkeys(("s2_read", "z2_read", "s2_update", "z2_update", "carry_read",
                              "dz2_read", "ds2_update", "dz2_update"), 3),
}

MAIN = dict(b=4, hk=3, g=3, n=2048, d=64, dv=64)  # phase 3's main-path launch
TRAIN_ATTN = dict(MAIN, n=1024)  # each layer's attention launch in phase 7's step
FWD_CASES = ((MAIN, "float32"), (MAIN, "bfloat16"),  # phase 3's forward checks
             (TRAIN_ATTN, "bfloat16"), (TRAIN_ATTN, "float32"))
# Phase 3b's backward checks: the main path's shapes, then every other head
# dim the kernels instantiate (d = 16 and 32: several value blocks per tile;
# d = 128: one value column per tile, atomics straight into dq and dk), in
# both dtypes, all held to BWD_TOL.
BWD_CASES = ((MAIN, "float32"), (MAIN, "bfloat16"), (TRAIN_ATTN, "bfloat16"),
             *((dict(b=1, hk=2, g=3, n=256, d=d, dv=d), dname)
               for d in (16, 32, 128) for dname in ("float32", "bfloat16")))
EDGE = [  # (b, h, hk, n, d, dv, order): the JAX kernel tests' sweep + order 1
    (1, 2, 1, 256, 128, 128, 2),
    (2, 4, 2, 256, 64, 64, 2),
    (1, 3, 3, 384, 112, 112, 2),   # d=112 padded to 128
    (1, 2, 1, 300, 128, 128, 2),   # sequence padding
    (1, 8, 1, 128, 128, 128, 2),   # MQA, G=8
    (1, 2, 2, 256, 64, 256, 2),    # dv=256: 32 value tiles
    (1, 2, 2, 256, 64, 64, 1),     # order 1
    (1, 2, 1, 256, 16, 16, 2),     # d=16: 2 value blocks of 8
    (1, 4, 2, 256, 32, 32, 2),     # d=32: 4 value blocks of 8
]
GRAD_EDGE = [  # (order, b, h, hk, n, d, dv): tests/test_kernels.py's GRAD_SWEEP
    (1, 1, 2, 1, 256, 64, 64),
    (2, 2, 4, 2, 256, 64, 64),     # GQA g=2
    (2, 1, 8, 1, 128, 128, 128),   # MQA, G=8
    (2, 1, 2, 1, 300, 64, 64),     # sequence padding 300 -> 384
    (1, 1, 2, 1, 200, 48, 80),     # d 48 -> 64, sequence padding
    (2, 1, 2, 1, 256, 16, 16),     # d=16: 2 value blocks of 8
    (2, 1, 4, 2, 256, 32, 32),     # d=32: 4 value blocks of 8
]
TRAIN = dict(b=4, n=1024, steps=8, lr=2e-3, warmup=2)  # phase 7
BASELINE_STEPS = 4  # phase 8's training steps per backend, on phase 7's batch
FLASH_N = 4096  # phase 8's softmax forward on the flash path (n > 2048)
FLASH_TOL = 1e-4
PROMPT_LENS = (100, 256, 300, 384, 512, 700)
MAX_NEW = 32
N_MAX = 1024  # the serving engine's per-slot token capacity
F32_TOL = 1e-4
# The backward kernels write f32 gradients, and their plain versions compute
# in f32 from the same bf16 values, so bf16 inputs answer to the same limit as
# f32 ones.  Sound kernels read <= 3.4e-6 at phase 3b's shapes in either dtype;
# a copy of csrc/taylor_bwd.cu whose dS2 carry update drops its a_lo·b_hi
# product reads 2.8e-5 to 3.5e-5 in dk, which 1e-4 would let through.  Hence
# 1e-5, the next power of ten above the sound readings.
BWD_TOL = 1e-5
# The forward's bf16 output against the plain version's, also rounded to bf16:
# a sound kernel reads <= 6.8e-4 here (one-ulp rounding flips), a kernel that
# drops its z2 and S1 updates 8.1e-3.
FWD_BF16_TOL = 2e-3
NEAR_TIE = 1e-3
# Phase 9: the hybrid (taylor at pattern position 0, the sliding window at 1,
# 15 groups: smollm-135m's 30 layers) and the variants.
HYBRID = dict(pattern=("attn", "attn"), n_groups=15, attention_schedule={1: "softmax_window"})
HYBRID_STEPS = 4
DECAY = 0.95
DECAY_STEPS = 2
DECAY_TOL = 1e-5  # f32 forward vs the model's own prefill + decode, decayed
DECODE_CHECK = (896, 8)  # chunked prefill of 7 chunks, then decode steps
SYM_S2_SHARE = 0.55  # sym_state's per-slot S2 against the full state's
# Phase 10: serving under load (smollm-135m order 2, f32, 4 slots, N_MAX).
CHUNK_TOL = 2e-3  # chunked vs whole prefill, atol = rtol (tests/test_serve_sharded.py)
CHUNK_CASES = ((700, 256), (300, 128))  # (prompt, chunk): order 2, then the hybrid
SLO_SCHED = dict(priority_admission=True, decode_per_prefill=2, fat_chunk_depth=3,
                 preemption=True)
URGENT = ((64, 600), 16)  # priority-0 prompts submitted after the first step, new tokens
REPLAY = dict(seed=0, n=12, prompt_len=(100, 700), new_tokens=(8, 32),
              mean_interarrival_s=0.02, priorities=(0, 1))
LOAD_CHUNK = 256  # the engine's prefill_chunk in (b) and (d)
FAULT_MAX_QUEUE = 8  # (c): the standard trace's flood overflows this queue


def ptxas_summary(log: str, head_dim: int = 64):
    """ptxas's resource lines for the kernels instantiated at ``head_dim``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(taylor_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                      r"I(\S+?)EEEv", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>" if f"Li{head_dim}E" in m.group(2) else None
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def ptxas_spills(log: str):
    """(kernel instantiations compiled, ptxas's lines for those that spill)."""
    count, spills, name = 0, [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(taylor_\w+?_kernel)I(\S+?)EEEv", line)
        if m:
            name, count = f"{m.group(1)}<{m.group(2)}>", count + 1
        elif name and re.search(r"[1-9]\d* bytes spill", line):
            spills.append(f"{name}: {line.strip()}")
    return count, spills


def case_name(m, dname: str) -> str:
    """A check's name: its dtype, then n and d where they differ from MAIN's."""
    return dname + "".join(f" {k_}={m[k_]}" for k_ in ("n", "d") if m[k_] != MAIN[k_])


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def taylor_fwd_cost(bk, g, n, d, dv, chunk, itemsize, order=2):
    """(operations, {contraction: operations}, bytes) of one forward:
    intra-chunk tiles (the causal triangle only: (chunk + 1) / 2 keys per
    row, for n a multiple of chunk), state reads and state updates; each
    input read once and the output written once.  The contractions are those
    that csrc/taylor_fwd.cu runs on the tensor cores (keys of
    FWD_TF32_PRODUCTS), counted once each, and are part of the operations."""
    sq, cube = (2 * d * d, 2 * d * d * dv) if order >= 2 else (0, 0)
    lin = 2 * d * dv + 2 * d
    tri = (chunk + 1) / 2                        # keys j <= i per row of a chunk
    tensor = {"s2_read": bk * g * n * cube, "z2_read": bk * g * n * sq,
              "s2_update": bk * n * cube, "z2_update": bk * n * sq}
    ops = bk * (g * n * tri * 2 * (d + dv) + (g + 1) * n * lin) + sum(tensor.values())
    nbytes = itemsize * (bk * g * n * d + bk * n * d + bk * n * dv + bk * g * n * dv)
    return ops, tensor, nbytes


def taylor_bwd_cost(bk, g, n, d, dv, chunk, itemsize, order=2):
    """{kernel: (operations, {contraction: operations}, bytes)} of the
    backward pair, from the loops of csrc/taylor_bwd.cu (chunk = its C),
    counting every term once (not once per value tile): the causal triangle
    of the C×C intra tiles ((C + 1) / 2 pairs per row, for n a multiple of
    C), the den/dden rows, the first moments and the folds of the
    contractions.  The contractions are those that csrc/taylor_bwd.cu runs
    on the tensor cores (keys of BWD_TF32_PRODUCTS), counted once each (one
    z2 product serves den and dq, one carry product dk and dv), and are part
    of the operations.  Bytes: each input read once, each output written
    once; den/dden are pass 1's outputs and pass 2's inputs, and not the
    pair's."""
    sq = 2 * d * d if order >= 2 else 0           # one d×d contraction
    cube = 2 * d * d * dv if order >= 2 else 0    # one d×d×dv contraction
    fold = 2 * d * dv if order >= 2 else 0        # one fold of a d×dv product
    lin = 2 * d * dv
    rows = g * n
    tri = (chunk + 1) / 2                         # pairs j <= i per row of a chunk
    dq_tensor = {"s2_read": bk * rows * cube, "z2_read": bk * rows * sq,
                 "s2_update": bk * n * cube, "z2_update": bk * n * sq}
    dq_ops = bk * (
        rows * tri * (2 * d + 2 * dv + 2 * d)      # scores, dp, ds·K
        + rows * (2 * d + 2 * dv)                  # den's q·z1, Σ dout·out
        + rows * (lin + 2 * d)                     # dq: S1, z1 terms
        + rows * (fold + (4 * d if order >= 2 else 0))  # folds: S2 read; z2 read (den, dq)
        + n * (lin + d)                            # S1, z1 update
    ) + sum(dq_tensor.values())
    dkv_tensor = {"carry_read": bk * n * cube, "dz2_read": bk * n * sq,
                  "ds2_update": bk * rows * cube, "dz2_update": bk * rows * sq}
    dkv_ops = bk * (
        n * (2 * lin + 2 * fold)                   # dS1 terms of dk, dv; the carry read's folds
        + rows * tri * (2 * d + 2 * dv + 2 * dv + 2 * d)  # scores, Pᵀdnum, dp, dsᵀQ
        + rows * (lin + 2 * d + dv)                # dS1, dz1, dS0 update
    ) + sum(dkv_tensor.values())
    f32 = 4
    inputs = itemsize * bk * (g * n * d + n * d + n * dv + g * n * dv)  # q, k, v, dout
    out_b = itemsize * bk * g * n * dv
    rows_b = 2 * f32 * bk * g * n                                       # den, dden
    dq_b = f32 * bk * g * n * d
    dkdv_b = f32 * bk * n * (d + dv)
    return {
        "taylor_bwd_dq": (dq_ops, dq_tensor, inputs + out_b + dq_b + rows_b),
        "taylor_bwd_dkv": (dkv_ops, dkv_tensor, inputs + rows_b + dkdv_b),
        "pair": (dq_ops + dkv_ops, {**dq_tensor, **dkv_tensor},
                 inputs + out_b + dq_b + dkdv_b),
    }


def bound_ms(flops, nbytes, tensor=None, products=None):
    """(least ms on the card, what bounds it): the operations at their type's
    peak against the bytes at HBM's rate.  The operations run at the f32
    CUDA-core peak, except the ``tensor`` contractions ({name: operations}),
    which take ``products[name]`` TF32 products each at the tensor-core peak."""
    tensor = tensor or {}
    t_ops = ((flops - sum(tensor.values())) / F32_FLOPS
             + sum(f * products[k] for k, f in tensor.items()) / TF32_FLOPS)
    t_bytes = nbytes / HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def rel_err(torch, out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


def fwd_inputs(torch, m, dtype, gen, ln):
    """Phase 3's forward inputs at shape ``m``: normalised q, k and plain v."""
    bk = m["b"] * m["hk"]
    q = ln(torch.randn(bk, m["g"], m["n"], m["d"], device="cuda", generator=gen)).to(dtype)
    k = ln(torch.randn(bk, m["n"], m["d"], device="cuda", generator=gen)).to(dtype)
    v = torch.randn(bk, m["n"], m["dv"], device="cuda", generator=gen).to(dtype)
    return q, k, v


def fwd_errors(torch, out, ref32):
    """Checks a forward output against the plain version's float32 output on
    the same inputs, ``ref32``.  Returns (errors, failures): ``rel`` against
    ``ref32`` rounded to out's dtype (tolerance F32_TOL, or FWD_BF16_TOL for
    bf16) and, for bf16, ``excess``: the error beyond half a bf16 ulp, the
    rounding of the output itself, relative to max |ref32| (held to F32_TOL,
    so the bf16 instantiation answers to the f32 tolerance)."""
    bf16 = out.dtype == torch.bfloat16
    errs = {"rel": rel_err(torch, out, ref32.to(out.dtype))}
    tols = {"rel": FWD_BF16_TOL if bf16 else F32_TOL}
    if bf16:
        o = out.float()
        _, e = torch.frexp(torch.maximum(o.abs(), ref32.abs()))
        half_ulp = torch.ldexp(torch.ones_like(o), e - 9)  # bf16: 8 significant bits
        errs["excess"] = float(((o - ref32).abs() - half_ulp).clamp(min=0).max()
                               / ref32.abs().max())
        tols["excess"] = F32_TOL
    return errs, {k_: (e_, tols[k_]) for k_, e_ in errs.items() if not e_ < tols[k_]}


def phase_kernel(torch, K, ops, ref_mod, ln):
    """Phase 3: the kernel against its plain version on the card, at phase 3's
    shape and at the training step's own launch, in f32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for m, dname in FWD_CASES:
        dtype = getattr(torch, dname)
        bk = m["b"] * m["hk"]
        q, k, v = fwd_inputs(torch, m, dtype, gen, ln)
        out = K.taylor_fwd(q, k, v, alpha=3.0)
        ref32 = ref_mod.taylor_attention_ref(q.float()[None], k.float()[None],
                                             v.float()[None], alpha=3.0)[0]
        torch.cuda.synchronize()
        errs, bad = fwd_errors(torch, out, ref32)
        abs_err = float((out.float() - ref32.to(dtype).float()).abs().max())
        kernel_ms = cuda_ms(torch, lambda: K.taylor_fwd(q, k, v, alpha=3.0), 10)
        plain_ms = cuda_ms(
            torch, lambda: ref_mod.taylor_attention_ref(q[None], k[None], v[None]), 3
        )
        flops, tensor, nbytes = taylor_fwd_cost(
            bk, m["g"], m["n"], m["d"], m["dv"], K.TILES[m["d"]][1], q.element_size())
        products = FWD_TF32_PRODUCTS[dname]
        f32_ms, _ = bound_ms(flops, nbytes)
        tensor_ms, by = bound_ms(flops, nbytes, tensor, products)
        name = case_name(m, dname)
        print(f"[3] taylor_fwd {name} {m}: "
              + " ".join(f"{k_}_err={e_:.3e}" for k_, e_ in errs.items())
              + (f" (tol {FWD_BF16_TOL}, excess {F32_TOL})" if "excess" in errs
                 else f" (tol {F32_TOL})")
              + f" max_abs_err={abs_err:.3e} kernel_ms={kernel_ms:.4f} "
              f"plain_ms={plain_ms:.4f} bound_ms={tensor_ms:.4f} ({by}; tensor cores, "
              f"TF32 products {products}; bound/kernel {tensor_ms / kernel_ms:.1%}) "
              f"bound_ms(f32 cores)={f32_ms:.4f} (bound/kernel {f32_ms / kernel_ms:.1%}) "
              f"gflop={flops / 1e9:.2f} "
              f"(tensor-core share {sum(tensor.values()) / flops:.3f}) "
              f"achieved_tflops={flops / kernel_ms / 1e9:.2f}")
        if bad:
            fail(f"taylor_fwd {name} disagrees with its plain version: {bad}")
        rows[name] = dict(
            max_abs_err=abs_err, rel_err=errs["rel"], ms=kernel_ms, plain_ms=plain_ms,
            bound_ms=tensor_ms, bound_by=by, bound_f32_cores_ms=f32_ms,
        )
    for b, h, hk, n, d, dv, order in EDGE:
        q = torch.randn(b, h, n, d, device="cuda", generator=gen)
        k = torch.randn(b, hk, n, d, device="cuda", generator=gen)
        v = torch.randn(b, hk, n, dv, device="cuda", generator=gen)
        with torch.no_grad():
            out = ops.taylor_attention_kernel_trainable(q, k, v, ops.TaylorConfig(order=order))
        ref = ref_mod.taylor_attention_ref(
            ln(q).reshape(b, hk, h // hk, n, d), ln(k), v, order=order
        ).reshape(b, h, n, dv)
        torch.cuda.synchronize()
        err = rel_err(torch, out, ref)
        print(f"[3] edge (b,h,hk,n,d,dv,order)={(b, h, hk, n, d, dv, order)} "
              f"f32 rel_err={err:.3e}")
        if not err < F32_TOL:
            fail(f"edge case {(b, h, hk, n, d, dv, order)} rel err {err}")
    return rows


def bwd_inputs(torch, m, dtype, gen, ln):
    """Phase 3b's backward inputs at shape ``m``: the forward's and dout."""
    q, k, v = fwd_inputs(torch, m, dtype, gen, ln)
    dout = torch.randn(m["b"] * m["hk"], m["g"], m["n"], m["dv"], device="cuda",
                       generator=gen).to(dtype)
    return q, k, v, dout


def bwd_check(torch, ref_mod, q, k, v, dout, out, dq_fn, dkv_fn):
    """Runs pass 1 (``dq_fn``) and pass 2 (``dkv_fn``, on pass 1's den and
    dden) and their plain versions on the same inputs.  Returns (rel errors,
    max abs errors by kernel, failures, (den, dden)).  Every rel error
    answers to BWD_TOL, for bf16 inputs too: the gradients are f32 either
    way."""
    dq, den, dden = dq_fn(q, k, v, dout, out)
    dk, dv = dkv_fn(q, k, v, dout, den, dden)
    b = lambda *x: [t[None] for t in x]
    want = [t[0] for t in ref_mod.taylor_bwd_dq_ref(*b(q, k, v, dout, out))]
    # pass 2 against its plain version on the SAME inputs (pass 1's rows)
    want += [t[0] for t in ref_mod.taylor_bwd_dkv_ref(*b(q, k, v, dout, den, dden))]
    torch.cuda.synchronize()
    got = (dq, den, dden, dk, dv)
    errs = {n_: rel_err(torch, a_, w_) for n_, a_, w_ in
            zip(("dq", "den", "dden", "dk", "dv"), got, want)}
    abs_err = {"taylor_bwd_dq": float((dq - want[0]).abs().max()),
               "taylor_bwd_dkv": max(float((dk - want[3]).abs().max()),
                                     float((dv - want[4]).abs().max()))}
    bad = {k_: (e_, BWD_TOL) for k_, e_ in errs.items() if not e_ < BWD_TOL}
    return errs, abs_err, bad, (den, dden)


def phase_backward(torch, K, ops, ref_mod, ln):
    """Phase 3b: the backward kernels against their plain versions on the
    card (``BWD_CASES``: phase 3's shape in f32 and bf16, the training
    step's in bf16, n = 256 at d = 16, 32 and 128 in both), then the
    trainable wrapper against autograd of the plain forward, and the padded
    rows and columns of the raw gradients, which must be 0."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}
    dq_fn = lambda q, k, v, dout, out: K.taylor_bwd_dq(q, k, v, dout, out, alpha=3.0)
    dkv_fn = lambda q, k, v, dout, den, dden: K.taylor_bwd_dkv(q, k, v, dout, den, dden,
                                                               alpha=3.0)
    for m, dname in BWD_CASES:
        bk = m["b"] * m["hk"]
        q, k, v, dout = bwd_inputs(torch, m, getattr(torch, dname), gen, ln)
        out = K.taylor_fwd(q, k, v, alpha=3.0)
        errs, abs_err, bad, (den, dden) = bwd_check(torch, ref_mod, q, k, v, dout, out,
                                                    dq_fn, dkv_fn)
        b = lambda *x: [t[None] for t in x]
        ms = {
            "taylor_bwd_dq": cuda_ms(torch, lambda: dq_fn(q, k, v, dout, out), 10),
            "taylor_bwd_dkv": cuda_ms(torch, lambda: dkv_fn(q, k, v, dout, den, dden), 10),
            "pair": cuda_ms(torch, lambda: K.taylor_bwd(q, k, v, dout, out, alpha=3.0), 10),
        }
        plain = {
            "taylor_bwd_dq": cuda_ms(torch, lambda: ref_mod.taylor_bwd_dq_ref(
                *b(q, k, v, dout, out)), 3),
            "taylor_bwd_dkv": cuda_ms(torch, lambda: ref_mod.taylor_bwd_dkv_ref(
                *b(q, k, v, dout, den, dden)), 3),
            "pair": cuda_ms(torch, lambda: ref_mod.taylor_attention_bwd_ref(
                *b(q, k, v, dout, out)), 3),
        }
        cost = taylor_bwd_cost(bk, m["g"], m["n"], m["d"], m["dv"], K.BWD_CHUNK,
                               q.element_size())
        products = BWD_TF32_PRODUCTS[dname]
        name = case_name(m, dname)
        print(f"[3b] taylor_bwd {name} {m}: rel_err " +
              " ".join(f"{k_}={e:.3e}" for k_, e in errs.items()) + f" (tol {BWD_TOL})")
        rows[name] = {}
        for kname in ("taylor_bwd_dq", "taylor_bwd_dkv", "pair"):
            flops, tensor, nbytes = cost[kname]
            f32_ms, _ = bound_ms(flops, nbytes)
            bms, by = bound_ms(flops, nbytes, tensor, products)
            print(f"[3b]   {kname} {name}: kernel_ms={ms[kname]:.4f} "
                  f"plain_ms={plain[kname]:.4f} bound_ms={bms:.4f} ({by}; tensor cores; "
                  f"bound/kernel {bms / ms[kname]:.1%}) bound_ms(f32 cores)={f32_ms:.4f} "
                  f"(bound/kernel {f32_ms / ms[kname]:.1%}) gflop={flops / 1e9:.2f} "
                  f"(tensor-core share {sum(tensor.values()) / flops:.3f}) "
                  f"mb={nbytes / 1e6:.1f} achieved_tflops={flops / ms[kname] / 1e9:.2f}")
            rows[name][kname] = dict(ms=ms[kname], plain_ms=plain[kname], bound_ms=bms,
                                     bound_by=by, bound_f32_cores_ms=f32_ms,
                                     max_abs_err=abs_err.get(kname))
        if bad:
            fail(f"taylor_bwd {name} disagrees with its plain version: {bad}")
    for order, b, h, hk, n, d, dv in GRAD_EDGE:
        q = torch.randn(b, h, n, d, device="cuda", generator=gen, requires_grad=True)
        k = torch.randn(b, hk, n, d, device="cuda", generator=gen, requires_grad=True)
        v = torch.randn(b, hk, n, dv, device="cuda", generator=gen, requires_grad=True)
        t = torch.randn(b, h, n, dv, device="cuda", generator=gen)
        cfg = ops.TaylorConfig(order=order)
        before = K.taylor_bwd.dq_launches
        o = ops.taylor_attention_kernel_trainable(q, k, v, cfg, backward="cuda")
        got = torch.autograd.grad((o * t).sum(), (q, k, v))
        ref = ref_mod.taylor_attention_ref(
            ln(q).reshape(b, hk, h // hk, n, d), ln(k), v, order=order
        ).reshape(b, h, n, dv)
        want = torch.autograd.grad((ref * t).sum(), (q, k, v))
        torch.cuda.synchronize()
        errs = [rel_err(torch, a, w) for a, w in zip(got, want)]
        print(f"[3b] trainable wrapper (order,b,h,hk,n,d,dv)={(order, b, h, hk, n, d, dv)} "
              f"f32 grad rel_err dq,dk,dv = {', '.join(f'{e:.3e}' for e in errs)}")
        if K.taylor_bwd.dq_launches != before + 1:
            fail("the trainable wrapper did not launch the backward kernels")
        if not max(errs) < F32_TOL:
            fail(f"trainable wrapper gradients disagree at {(order, b, h, hk, n, d, dv)}")
        qp, kp, vp, dims = ops._kernel_layout(ln(q.detach()), ln(k.detach()), v.detach())
        if (dims.n_pad, dims.d_pad, dims.dv_pad) == (n, d, dv):
            continue
        alpha = ops._effective_alpha(3.0, dims)
        doutp = ops._grouped_value_layout(t, dims)
        outp = K.taylor_fwd(qp, kp, vp, alpha=alpha, order=order)
        gq, gk, gv = K.taylor_bwd(qp, kp, vp, doutp, outp, alpha=alpha, order=order)
        pads = [gq[..., n:, :], gq[..., d:], gk[:, n:], gk[..., d:], gv[:, n:], gv[..., dv:]]
        nonzero = sum(int(torch.count_nonzero(x)) for x in pads)
        print(f"[3b] padded layout (n,d,dv) {(n, d, dv)} -> "
              f"{(dims.n_pad, dims.d_pad, dims.dv_pad)}: {sum(x.numel() for x in pads)} "
              f"padded gradient entries, {nonzero} nonzero")
        if nonzero:
            fail(f"padded gradient rows/columns are not exactly zero at {(n, d, dv)}")
    return rows


def taylor_counters(K):
    """The three kernels' launch counts: (fwd, dq, dkv)."""
    return K.taylor_fwd.launches, K.taylor_bwd.dq_launches, K.taylor_bwd.dkv_launches


def kernel_layers(torch, cfg):
    """The layers whose attention runs the Taylor kernels on the card: the
    taylor layers (per ``attention_schedule``) when their config is inside
    the kernels' envelope (no decay, no sym_state) and the impl allows."""
    from repro_torch.backends import get_backend
    from repro_torch.models.config import schedule_runs

    lcfg = cfg.layer_cfg("taylor")
    if get_backend("taylor").resolve_impl(lcfg, torch.device("cuda")) != "cuda":
        return 0
    per_group = sum(rl for _, bk, rl in schedule_runs(cfg) if bk == "taylor")
    return per_group * cfg.n_groups + (len(cfg.tail) if cfg.attention == "taylor" else 0)


def kernel_launches_per_step(torch, cfg):
    """(fwd, dq, dkv) launches of one training step: one forward per kernel
    layer, two under remat "full"; one dq and one dkv."""
    n = kernel_layers(torch, cfg)
    return (2 if cfg.remat == "full" else 1) * n, n, n


def train_steps(torch, K, cfg, init_state, step, batch, steps, tag):
    """Runs ``steps`` training steps from ``init_state()`` with the kernels'
    counts set to 0 just before, printing each step; fails unless every step
    launches ``kernel_launches_per_step`` and has a finite loss.  Only
    this frame holds the state, so each step's input state is freed as the
    next is made.  Returns (state, losses, host seconds per step, launches
    over the run, peak bytes)."""
    expect = kernel_launches_per_step(torch, cfg)
    state = init_state()
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(steps):
        c0 = taylor_counters(K)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = tuple(a - b for a, b in zip(taylor_counters(K), c0))
        losses.append(loss)
        print(f"{tag} step {i + 1}: loss={loss:.4f} {times[-1] * 1e3:.1f} ms "
              f"launches fwd,dq,dkv={got}")
        if got != expect:
            fail(f"{tag} training step launched (fwd, dq, dkv) = {got}, expected {expect}")
        if not math.isfinite(loss):
            fail(f"{tag} loss is not finite at step {i + 1}")
    launches = dict(zip(("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv"), taylor_counters(K)))
    return state, losses, times, launches, torch.cuda.max_memory_allocated()


def bigram_batch(torch, make_task, cfg):
    """Phase 7's fixed training batch: ``make_task("bigram", vocab, n, b)``'s
    step 0, on the card."""
    task = make_task("bigram", cfg.vocab, TRAIN["n"], TRAIN["b"], seed=0)
    return {k_: torch.from_numpy(x).cuda() for k_, x in task.batch_at(0).items()}


def phase_train(torch, K, cfg, make_task, adamw, cosine_warmup, train_state_init,
                make_train_step, make_loss_fn, loss_and_grads, tree_leaves):
    """Phase 7: full-width training steps on one fixed batch, through the
    kernels; then the kernel gradients against the torch recompute's."""
    tr = TRAIN
    batch = bigram_batch(torch, make_task, cfg)
    opt = adamw(cosine_warmup(tr["lr"], tr["warmup"], tr["steps"]))
    step = make_train_step(cfg, opt)
    counters = lambda: taylor_counters(K)
    state, losses, times, launches, peak = train_steps(
        torch, K, cfg, lambda: train_state_init(torch.Generator().manual_seed(0), cfg, opt),
        step, batch, tr["steps"], "[7]")
    steady = sum(times[1:]) / (len(times) - 1)
    tokens = tr["b"] * tr["n"]
    print(f"[7] smollm-135m training {cfg.dtype} remat={cfg.remat} b={tr['b']} n={tr['n']}: "
          f"{tr['steps']} steps on one batch, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"first step {times[0] * 1e3:.1f} ms, then {steady * 1e3:.1f} ms/step = "
          f"{tokens / steady:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} -> {losses[-1]}")

    tcfg = cfg.replace(attn_impl="torch")
    tstep = make_train_step(tcfg, opt)
    tstep(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tm = tstep(state, batch)
    float(tm["loss"])
    torch.cuda.synchronize()
    torch_step = time.perf_counter() - t0
    print(f"[7] one training step with attn_impl='torch' (chunked torch forward + "
          f"torch recompute backward): {torch_step * 1e3:.1f} ms vs {steady * 1e3:.1f} ms "
          f"through the kernels")

    cfg32 = cfg.replace(dtype="float32")
    c0 = counters()
    _, _, g_cuda = loss_and_grads(make_loss_fn(cfg32.replace(attn_impl="cuda")),
                                  state.params, batch)
    if counters()[1] == c0[1]:
        fail("the float32 gradient check did not run the backward kernels")
    _, _, g_torch = loss_and_grads(make_loss_fn(cfg32.replace(attn_impl="torch")),
                                   state.params, batch)
    errs = [rel_err(torch, a, b) for a, b in zip(tree_leaves(g_cuda), tree_leaves(g_torch))]
    worst = max(errs)
    print(f"[7] float32 gradients, kernels vs torch recompute, over {len(errs)} leaves: "
          f"max rel_err {worst:.3e}, median {sorted(errs)[len(errs) // 2]:.3e} (tol 1e-3)")
    if not worst < 1e-3:
        fail(f"kernel gradients disagree with the torch recompute: {worst}")
    return dict(launches=launches, losses=losses, step_ms=steady * 1e3,
                first_step_ms=times[0] * 1e3, tokens_per_s=tokens / steady,
                peak_gib=peak / 2**30, torch_step_ms=torch_step * 1e3, grad_rel_err=worst)


def serve_requests(torch, ServeEngine, Request, params, cfg):
    """Phase 5/6 traffic: 6 greedy requests on 4 slots.  Returns (prompts,
    outputs, engine stats, wall seconds, the slotted cache's facts: its
    runs' state types, bytes per slot and S2 bytes per slot).  The engine,
    which holds the weights and the cache, is freed on return."""
    from repro_torch.serve import slots

    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen) for n in PROMPT_LENS]
    eng = ServeEngine(params, cfg, max_slots=4, n_max=N_MAX, decode_block=16)
    rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW)) for p in prompts]
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid, p in zip(rids, prompts):
        if rid not in outs or len(outs[rid]) != MAX_NEW:
            fail(f"request of prompt {len(p)} did not finish with {MAX_NEW} tokens")
    check_no_faults(eng.stats(), f"serving {cfg.attention} ({cfg.dtype})")
    cache = dict(runs=[type(x).__name__ for x in eng.caches["group"]],
                 slot_bytes=slots.slot_bytes(eng.caches, eng.max_slots),
                 s2_bytes=s2_bytes_per_slot(eng.caches, eng.max_slots))
    return prompts, [outs[r] for r in rids], eng.stats(), wall, cache


def check_no_faults(st, what):
    """Serving runs through the engine's resilience boundary, which turns an
    exception in a decode dispatch into retries and FAILED requests: a run
    without an injected fault must have caught none and quarantined none."""
    if st.get("dispatch_failures", 0) or st.get("quarantined", 0):
        fail(f"{what}: dispatch_failures={st.get('dispatch_failures', 0)} "
             f"quarantined={st.get('quarantined', 0)} without an injected fault")


def cross_check(torch, lm_apply, params, cfg, prompts, outs):
    """Phase 6: each engine token against the argmax of ``lm_apply`` (through
    the kernel) over prompt + output.  Returns (mismatches that are not
    near-ties, positions whose top-2 logit gap is below NEAR_TIE)."""
    near_ties = mismatches = 0
    for p, o in zip(prompts, outs):
        seq = torch.cat([p, torch.as_tensor(o[:-1])]).cuda()[None]
        lg, _ = lm_apply(params, {"tokens": seq}, cfg)
        lg = lg[0, len(p) - 1:]
        top2 = lg.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu()
        pred = lg.argmax(-1).cpu().numpy()
        for t in range(MAX_NEW):
            tie = float(gap[t]) < NEAR_TIE
            near_ties += tie
            if pred[t] != o[t] and not tie:
                mismatches += 1
    return mismatches, near_ties


def cross_check_decode(torch, lm_prefill, lm_decode_step, slots, params, cfg, prompts, outs):
    """Each engine token against the argmax of the model's own serving path
    with the engine's tokens fed back: every request prefilled alone into a
    slot of one cache, then all decoded together.  For ``linear_elu``, whose
    decode reads its KV cache with the exact softmax (as the JAX package's
    does) while ``lm_apply`` runs elu linear attention, this is the oracle
    past the first token.  Returns (mismatches that are not near-ties,
    near-ties)."""
    n_max = max(len(p) for p in prompts) + MAX_NEW
    caches = slots.init_slot_caches(cfg, len(prompts), n_max)
    first = []
    for j, p in enumerate(prompts):
        lg, c = lm_prefill(params, {"tokens": p.cuda()[None]}, cfg, n_max)
        caches = slots.write_slot(caches, c, j)
        first.append(lg[0])
    logits = [torch.stack(first)]
    toks = torch.stack([torch.as_tensor(o) for o in outs]).cuda()  # [requests, MAX_NEW]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=toks.device)
    for t in range(MAX_NEW - 1):
        lg, caches = lm_decode_step(params, toks[:, t], caches, pos + t, cfg)
        logits.append(lg)
    lg = torch.stack(logits, dim=1)  # [requests, MAX_NEW, vocab]
    top2 = lg.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    wrong = lg.argmax(-1) != toks
    return int((wrong & ~tie).sum()), int(tie.sum())


def phase_baselines(torch, K, infer, serve_fn, cross_fn):
    """Phase 8: the paper's baselines at full width — smollm-135m on the
    softmax, softmax_window and linear_elu backends, and taylor order 1
    through the kernels.  For each: the forward, serving in f32 with every
    engine token checked, then (with the inference weights freed, so that
    peak memory compares with phase 7's) training steps whose loss must
    fall.  For softmax also the flash path (n = 4096) against the forced
    dense path; for order 1 its f32 logits against attn_impl="torch"."""
    from repro_torch.backends import softmax as softmax_backend
    from repro_torch.configs import get_config
    from repro_torch.core import TaylorConfig
    from repro_torch.data import make_task
    from repro_torch.models import lm_decode_step, lm_init, lm_prefill
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.serve import slots
    from repro_torch.train import make_train_step, train_state_init

    variants = {
        "softmax": get_config("smollm-135m", backend="softmax"),
        "softmax_window": get_config("smollm-135m", backend="softmax_window"),
        "linear_elu": get_config("smollm-135m", backend="linear_elu"),
        "taylor-1": get_config("smollm-135m", taylor=TaylorConfig(order=1)),
    }
    params = lm_init(torch.Generator().manual_seed(0), variants["softmax"])
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, variants["softmax"].vocab, (4, 1024), generator=gen).cuda()
    summary, launches = {}, {}
    for name, cfg in variants.items():
        tag = f"[8] {name}"
        cfg32 = cfg.replace(dtype="float32")
        # -- forward --
        K.taylor_fwd.launches = 0
        logits, _ = infer(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        fwd_launches = K.taylor_fwd.launches
        if fwd_launches != kernel_layers(torch, cfg):
            fail(f"{tag} lm_apply launched taylor_fwd {fwd_launches} times")
        if logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all():
            fail(f"{tag} lm_apply logits have the wrong shape or are not finite")
        del logits
        fwd_ms = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 3)
        print(f"{tag} lm_apply b={tokens.shape[0]} n={tokens.shape[1]} {cfg.dtype}: "
              f"forward_ms={fwd_ms:.2f} "
              f"taylor_fwd launches={fwd_launches}")
        if name == "taylor-1":
            launches["lm_apply"] = fwd_launches
            err = rel_err(torch, infer(params, {"tokens": tokens}, cfg32)[0],
                          infer(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
            print(f"{tag} float32 logits rel_err kernel vs torch = {err:.3e} (tol 1e-3)")
            if not err < 1e-3:
                fail(f"{tag} float32 kernel forward disagrees with the torch forward: {err}")
        if name == "softmax":
            long = torch.randint(0, cfg.vocab, (1, FLASH_N), generator=gen).cuda()
            flash, calls = softmax_backend.flash_softmax_attention, []
            softmax_backend.flash_softmax_attention = (
                lambda *a, **kw: calls.append(1) or flash(*a, **kw))
            try:
                t0 = time.perf_counter()
                flash_logits = infer(params, {"tokens": long}, cfg32)[0]
                torch.cuda.synchronize()
                flash_s = time.perf_counter() - t0
            finally:
                softmax_backend.flash_softmax_attention = flash
            min_seq = softmax_backend._FLASH_MIN_SEQ
            softmax_backend._FLASH_MIN_SEQ = FLASH_N  # forces the dense path
            try:
                t0 = time.perf_counter()
                dense_logits = infer(params, {"tokens": long}, cfg32)[0]
                torch.cuda.synchronize()
                dense_s = time.perf_counter() - t0
            finally:
                softmax_backend._FLASH_MIN_SEQ = min_seq
            err = rel_err(torch, flash_logits, dense_logits)
            del flash_logits, dense_logits
            print(f"{tag} flash path b=1 n={FLASH_N} float32: {len(calls)} flash calls, "
                  f"logits rel_err vs dense = {err:.3e} (tol {FLASH_TOL}); "
                  f"lm_apply {flash_s * 1e3:.1f} ms flash, {dense_s * 1e3:.1f} ms dense "
                  f"(host clock, one call each)")
            if len(calls) != cfg.n_layers:
                fail(f"{tag} the n={FLASH_N} forward took the flash path {len(calls)} times")
            if not err < FLASH_TOL:
                fail(f"{tag} flash logits disagree with the dense path: {err}")
        # -- serving (f32) --
        K.taylor_fwd.launches = 0
        prompts, outs, st, wall, _ = serve_fn(params, cfg32)
        if name == "linear_elu":
            mismatches, near_ties = cross_check_decode(
                torch, lm_prefill, lm_decode_step, slots, params, cfg32, prompts, outs)
            oracle = "its prefill + decode path (softmax KV read)"
        else:
            mismatches, near_ties = cross_fn(params, cfg32, prompts, outs)
            oracle = "lm_apply argmax"
        decode_tps = st["decode_tokens"] / st["decode_seconds"]
        print(f"{tag} served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
              f"prefill {st['prefill_seconds']:.3f} s, decode {st['decode_tokens']} tokens in "
              f"{st['decode_seconds']:.3f} s = {decode_tps:.1f} tokens/s; engine tokens vs "
              f"{oracle}: mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}")
        if mismatches:
            fail(f"{tag} {mismatches} engine tokens differ from {oracle}")
        summary[name] = dict(forward_ms=fwd_ms, decode_tokens_per_s=decode_tps)
    del params
    batch = bigram_batch(torch, make_task, variants["softmax"])
    for name, cfg in variants.items():
        tag = f"[8] {name}"
        opt = adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], BASELINE_STEPS))
        state, losses, times, tl, peak = train_steps(
            torch, K, cfg, lambda: train_state_init(torch.Generator().manual_seed(0), cfg, opt),
            make_train_step(cfg, opt), batch, BASELINE_STEPS, tag)
        del state  # before the next backend's run, whose peak would count it
        steady = sum(times[1:]) / (len(times) - 1)
        tps = TRAIN["b"] * TRAIN["n"] / steady
        print(f"{tag} training {cfg.dtype} remat={cfg.remat} b={TRAIN['b']} n={TRAIN['n']}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; first step {times[0] * 1e3:.1f} ms, "
              f"then {steady * 1e3:.1f} ms/step = {tps:.0f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {tl}")
        if not losses[-1] < losses[0]:
            fail(f"{tag} loss did not fall: {losses[0]} -> {losses[-1]}")
        if name == "taylor-1":
            launches["train"] = tl
        summary[name].update(train_ms_per_step=steady * 1e3, train_tokens_per_s=tps,
                             peak_gib=peak / 2**30)
    print("[8] summary (smollm-135m full width; forward b=4 n=1024 bf16, training b=4 "
          "n=1024 bf16 remat full, decode f32 on 4 slots): " + "; ".join(
              f"{n_}: forward {r['forward_ms']:.2f} ms, train {r['train_ms_per_step']:.1f} "
              f"ms/step, decode {r['decode_tokens_per_s']:.1f} tokens/s"
              for n_, r in summary.items()))
    return summary, launches


def diverging_requests(torch, infer, params, cfg, prompts, want, got):
    """Requests whose tokens ``got`` differ from ``want`` (both greedy, the
    same prompts).  Past the first position where they differ the two
    continue from other prefixes, so that position alone is judged: ``cfg``'s
    ``lm_apply`` over prompt + ``want``'s tokens before it must put the two
    tokens' logits within NEAR_TIE.  Returns (requests that differ, of those
    at a near-tie, of those not)."""
    differ = ties = 0
    for p, w, g in zip(prompts, want, got):
        diff = (torch.as_tensor(w) != torch.as_tensor(g)).nonzero()
        if not len(diff):
            continue
        differ += 1
        t = int(diff[0, 0])
        seq = torch.cat([p, torch.as_tensor(w[:t])]).cuda()[None]
        lg = infer(params, {"tokens": seq}, cfg)[0][0, -1]
        ties += float(lg[int(w[t])] - lg[int(g[t])]) < NEAR_TIE
    return differ, ties, differ - ties


def s2_bytes_per_slot(caches, slots: int) -> int:
    """Bytes of the S2 moments of a slotted cache, per slot."""
    return sum(st.s2.numel() * st.s2.element_size()
               for st in caches["group"] if hasattr(st, "s2") and st.s2 is not None) // slots


def phase_hybrid(torch, K, infer, serve_fn, cross_fn, full_f32):
    """Phase 9: the Based-style hybrid at smollm-135m's full width (taylor
    order 2 at pattern position 0, the 128-token sliding window at 1, 15
    groups) — the forward, f32 serving from a per-run cache of two state
    types, and training through the kernels — then smollm-135m with
    sym_state (f32 serving against phase 6's full-state tokens,
    ``full_f32`` = (prompts, outputs, stats)), with decay (f32 forward
    against its own prefill + decode, training on the torch paths, f32
    serving against its own prefill + decode path), and the non-causal
    form against the explicit feature map."""
    from repro_torch.configs import get_config
    from repro_torch.core import TaylorConfig, linear_attention, taylor_attention
    from repro_torch.core import taylor_features
    from repro_torch.data import make_task
    from repro_torch.models import lm_decode_step, lm_init, lm_prefill, lm_state_bytes
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.serve import slots
    from repro_torch.train import make_train_step, train_state_init

    cfg = get_config("smollm-135m").replace(**HYBRID)
    cfg32 = cfg.replace(dtype="float32")
    n_kernel = kernel_layers(torch, cfg)
    out = dict(cfg=dict(HYBRID, taylor_layers=n_kernel))
    # block weights do not depend on the backend: the same seed gives phase 4's
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen).cuda()

    # -- hybrid forward --
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    logits, _ = infer(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    out["lm_apply_launches"] = dict(zip(("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv"),
                                        taylor_counters(K)))
    if n_kernel != cfg.n_layers // 2 or taylor_counters(K) != (n_kernel, 0, 0):
        fail(f"[9] hybrid lm_apply launched (fwd, dq, dkv) = {taylor_counters(K)}, "
             f"expected ({cfg.n_layers // 2}, 0, 0)")
    if logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all():
        fail("[9] hybrid lm_apply logits have the wrong shape or are not finite")
    del logits
    out["forward_ms"] = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 3)
    err32 = rel_err(torch, infer(params, {"tokens": tokens}, cfg32)[0],
                    infer(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
    print(f"[9] hybrid lm_apply b=4 n=1024 {cfg.dtype}: forward_ms={out['forward_ms']:.2f} "
          f"launches={out['lm_apply_launches']}; float32 logits rel_err kernel vs "
          f"torch = {err32:.3e} (tol 1e-3)")
    if not err32 < 1e-3:
        fail(f"[9] hybrid float32 kernel forward disagrees with the torch forward: {err32}")

    # -- hybrid serving (f32) --
    prompts, outs, st, wall, cache = serve_fn(params, cfg32)
    mismatches, near_ties = cross_fn(params, cfg32, prompts, outs)
    kinds, per_slot = cache["runs"], cache["slot_bytes"]
    want = lm_state_bytes(cfg32, 1, N_MAX)
    pure = lm_state_bytes(get_config("smollm-135m", dtype="float32"), 1, N_MAX)
    out.update(decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
               prefill_s=st["prefill_seconds"], slot_bytes=per_slot, taylor_slot_bytes=pure)
    print(f"[9] hybrid served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
          f"prefill {st['prefill_seconds']:.3f} s over {st['prefill_dispatches']} dispatches, "
          f"decode {out['decode_tokens_per_s']:.1f} tokens/s; engine tokens vs lm_apply argmax: "
          f"mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}; cache runs {kinds}; "
          f"slot_bytes={per_slot} (lm_state_bytes(cfg, 1, n_max)={want}; pure taylor "
          f"{pure}, {per_slot / pure:.3f} of it)")
    if mismatches:
        fail(f"[9] {mismatches} hybrid engine tokens differ from the lm_apply argmax")
    if kinds != ["TaylorState", "KVCache"]:
        fail(f"[9] the hybrid's slotted cache has runs {kinds}")
    if per_slot != want:
        fail(f"[9] hybrid slot_bytes {per_slot} != lm_state_bytes {want}")

    # -- sym_state serving (f32), against phase 6's full-state tokens --
    sym32 = get_config("smollm-135m", taylor=TaylorConfig(sym_state=True), dtype="float32")
    full32 = sym32.replace(taylor=TaylorConfig())
    f_prompts, f_outs, f_st = full_f32
    prompts, outs, st, wall, cache = serve_fn(params, sym32)
    s2_sym, sym_slot = cache["s2_bytes"], cache["slot_bytes"]
    s2_full = s2_bytes_per_slot(slots.init_slot_caches(full32, 1, N_MAX, device="meta"), 1)
    full_slot = lm_state_bytes(full32, 1, N_MAX)
    if any(not torch.equal(a, b) for a, b in zip(prompts, f_prompts)):
        fail("[9] sym_state served other prompts than phase 6")
    differ, ties, bad = diverging_requests(torch, infer, params, full32, prompts, f_outs, outs)
    out["sym_state"] = dict(
        decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
        full_decode_tokens_per_s=f_st["decode_tokens"] / f_st["decode_seconds"],
        slot_bytes=sym_slot, full_slot_bytes=full_slot, s2_bytes=s2_sym,
        full_s2_bytes=s2_full, requests_differ=differ, near_ties=ties)
    print(f"[9] sym_state served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
          f"decode {out['sym_state']['decode_tokens_per_s']:.1f} tokens/s (full state, phase 6: "
          f"{out['sym_state']['full_decode_tokens_per_s']:.1f}); per slot {sym_slot} bytes, S2 "
          f"{s2_sym} (full state {full_slot}, S2 {s2_full}: {s2_sym / s2_full:.4f}); tokens vs "
          f"the full state's: {differ} requests differ, {ties} at a near-tie "
          f"(gap<{NEAR_TIE}), {bad} not")
    if bad:
        fail(f"[9] sym_state tokens differ from the full state's in {bad} requests")
    if not s2_sym < SYM_S2_SHARE * s2_full:
        fail(f"[9] sym_state S2 per slot {s2_sym} is not under {SYM_S2_SHARE} of {s2_full}")

    # -- decay: forward vs its own prefill + decode (f32), serving (f32) --
    dec = get_config("smollm-135m", taylor=TaylorConfig(decay=DECAY))
    dec32 = dec.replace(dtype="float32")
    errs = []
    for n_pre, steps in ((tokens.shape[1] - 1, 1), DECODE_CHECK):
        seq = tokens[:, :n_pre + steps]
        full = infer(params, {"tokens": seq}, dec32)[0][:, n_pre:]
        lg, caches = lm_prefill(params, {"tokens": seq[:, :n_pre]}, dec32, n_pre + steps)
        got = []
        for t in range(steps):
            lg, caches = lm_decode_step(params, seq[:, n_pre + t], caches, n_pre + t, dec32)
            got.append(lg)
        errs.append(rel_err(torch, torch.stack(got, dim=1), full))
        del caches, full
    print(f"[9] decay={DECAY} float32 lm_apply vs its prefill + decode: rel_err "
          f"{errs[0]:.3e} at the last of {tokens.shape[1]} positions (parallel prefill of "
          f"{tokens.shape[1] - 1}), {errs[1]:.3e} over {DECODE_CHECK[1]} steps after a chunked "
          f"prefill of {DECODE_CHECK[0]} (tol {DECAY_TOL})")
    if not max(errs) < DECAY_TOL:
        fail(f"[9] decayed forward and prefill + decode disagree: {errs}")
    prompts, outs, st, wall, _ = serve_fn(params, dec32)
    mismatches, near_ties = cross_check_decode(torch, lm_prefill, lm_decode_step, slots,
                                               params, dec32, prompts, outs)
    out["decay"] = dict(decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
                        forward_vs_decode_rel_err=max(errs))
    print(f"[9] decay served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
          f"decode {out['decay']['decode_tokens_per_s']:.1f} tokens/s; engine tokens vs its "
          f"prefill + decode path: mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}")
    if mismatches:
        fail(f"[9] {mismatches} decayed engine tokens differ from its prefill + decode path")
    del params

    # -- training: the hybrid through the kernels, decay on the torch paths --
    batch = bigram_batch(torch, make_task, cfg)
    for name, tcfg, steps in (("hybrid", cfg, HYBRID_STEPS), ("decay", dec, DECAY_STEPS)):
        tag = f"[9] {name}"
        opt = adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], steps))
        state, losses, times, tl, peak = train_steps(
            torch, K, tcfg, lambda: train_state_init(torch.Generator().manual_seed(0), tcfg, opt),
            make_train_step(tcfg, opt), batch, steps, tag)
        del state
        steady = sum(times[1:]) / (len(times) - 1)
        tps = TRAIN["b"] * TRAIN["n"] / steady
        print(f"{tag} training {tcfg.dtype} remat={tcfg.remat} b={TRAIN['b']} n={TRAIN['n']}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; first step {times[0] * 1e3:.1f} ms, "
              f"then {steady * 1e3:.1f} ms/step = {tps:.0f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {tl}")
        if not losses[-1] < losses[0]:
            fail(f"{tag} loss did not fall: {losses[0]} -> {losses[-1]}")
        rec = out if name == "hybrid" else out["decay"]
        rec.update(train_ms_per_step=steady * 1e3, train_tokens_per_s=tps,
                   peak_gib=peak / 2**30, train_launches=tl, losses=losses)

    # -- non-causal: taylor_attention(causal=False) vs the explicit feature map --
    tc = TaylorConfig()
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, hk, n, d = 4, cfg.n_heads, cfg.n_kv_heads, 1024, cfg.resolved_head_dim
    phi = lambda x: taylor_features(x, tc)
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        q = torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(b, hk, n, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        with torch.no_grad():
            got = taylor_attention(q, k, v, tc, causal=False)
            # the same bf16 q, k (normalised, then rounded as the Taylor path
            # rounds them) and float32 v: a float32 explicit-feature output
            ref32 = linear_attention(q, k, v.float(), phi=phi, causal=False, normalize_qk=True)
            ms = cuda_ms(torch, lambda: taylor_attention(q, k, v, tc, causal=False), 5)
            ref_ms = cuda_ms(torch, lambda: linear_attention(q, k, v, phi=phi, causal=False,
                                                             normalize_qk=True), 3)
        torch.cuda.synchronize()
        errs, _ = fwd_errors(torch, got, ref32)
        # bf16 answers to the f32 tolerance beyond its own rounding
        # (``excess``); its ``rel`` counts one-ulp rounding flips, up to
        # 2^-7 of max |ref|, and is only reported
        judged = "excess" if "excess" in errs else "rel"
        bad = not errs[judged] < F32_TOL
        out.setdefault("noncausal", {})[dname] = dict(ms=ms, features_ms=ref_ms, **errs)
        print(f"[9] non-causal taylor_attention b={b} h={h} hk={hk} n={n} d={d} {dname}: "
              + " ".join(f"{k_}_err={e_:.3e}" for k_, e_ in errs.items())
              + f" against the explicit feature map (tol {F32_TOL}"
              + (" on excess)" if "excess" in errs else ")")
              + f"; {ms:.3f} ms, explicit features {ref_ms:.3f} ms")
        if bad:
            fail(f"[9] non-causal {dname} disagrees with the explicit feature map: "
                 f"{judged} error {errs[judged]}")
    return out


def host_ms(torch, fn, iters: int) -> float:
    """Median host-clock ms of ``fn`` followed by a device synchronize (warm)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def tol_ratio(torch, got, want, tol):
    """(max |got - want|, max |got - want| / (tol + tol |want|)): the second
    is <= 1 exactly when ``torch.allclose(got, want, rtol=tol, atol=tol)``."""
    diff = (got.double() - want.double()).abs()
    return float(diff.max()), float((diff / (tol + tol * want.double().abs())).max())


@contextlib.contextmanager
def captured_kv(backend_cls):
    """Record the ``(k, v)`` that ``backend_cls.prefill`` and
    ``.prefill_chunk`` are given, call by call, while the block runs."""
    whole, chunks = [], []
    prefill_fn, chunk_fn = backend_cls.prefill, backend_cls.prefill_chunk

    def prefill(self, q, k, v, cfg, n_max):
        whole.append((k.clone(), v.clone()))
        return prefill_fn(self, q, k, v, cfg, n_max)

    def prefill_chunk(self, cache, q, k, v, cfg, pos):
        chunks.append((k.clone(), v.clone()))
        return chunk_fn(self, cache, q, k, v, cfg, pos)

    backend_cls.prefill, backend_cls.prefill_chunk = prefill, prefill_chunk
    try:
        yield whole, chunks
    finally:
        backend_cls.prefill, backend_cls.prefill_chunk = prefill_fn, chunk_fn


def state_gap_origin(torch, cfg, whole, chunked, kv_whole, kv_chunked):
    """Where chunked and whole prefill's Taylor states differ most, and why.

    Finds the state entry (layer, leaf, index) with the worst
    ``|chunked - whole| / (atol + rtol |whole|)`` and recomputes it in
    float64 from each path's own keys and values (``kv_*``: per layer, the
    ``(k, v)`` the backend was given).  Returns a dict: both f32 values, both
    float64 sums, and ``sum_abs``, the sum of the entry's terms' magnitudes,
    against which f32 rounding is measured (unit roundoff 2^-24), and
    ``sum_abs_delta``, the sum of the magnitudes of the terms' differences
    between the two paths' inputs, which bounds how far the layer's
    inputs alone move the float64 sum."""
    import numpy as np

    from repro_torch.models.lm import _split_caches

    worst = None
    for layer, (ws, cs) in enumerate(zip(_split_caches(whole, cfg), _split_caches(chunked, cfg))):
        for name, w, c in zip(ws._fields, ws, cs):
            if w is None:
                continue
            ratio = (c.double() - w.double()).abs() / (CHUNK_TOL + CHUNK_TOL * w.double().abs())
            r = float(ratio.max())
            if worst is None or r > worst[0]:
                idx = tuple(int(i) for i in np.unravel_index(int(ratio.argmax()), tuple(w.shape)))
                worst = (r, layer, name, idx, float(w[idx]), float(c[idx]))
    ratio, layer, name, idx, w32, c32 = worst

    def terms(k, v):
        k, v = k.double(), v.double()
        if cfg.taylor.normalize_qk:  # the backend's layernorm_no_affine, in float64
            mu = k.mean(dim=-1, keepdim=True)
            k = (k - mu) * torch.rsqrt((k - mu).square().mean(dim=-1, keepdim=True) + 1e-6)
        b, h, *rest = idx
        kt, vt = k[b, h], v[b, h]  # [n, d], [n, dv]
        return {
            "n0": lambda: torch.ones_like(kt[:, 0]),
            "s0": lambda: vt[:, rest[0]],
            "z1": lambda: kt[:, rest[0]],
            "s1": lambda: kt[:, rest[0]] * vt[:, rest[-1]],
            "z2": lambda: kt[:, rest[0]] * kt[:, rest[1]],
            "s2": lambda: kt[:, rest[0]] * kt[:, rest[1]] * vt[:, rest[2]],
        }[name]()

    t_whole, t_chunked = terms(*kv_whole[layer]), terms(*kv_chunked[layer])
    return dict(ratio=ratio, layer=layer, leaf=name, index=idx, whole_f32=w32, chunked_f32=c32,
                whole_f64=float(t_whole.sum()), chunked_f64=float(t_chunked.sum()),
                sum_abs=float(t_whole.abs().sum()),
                sum_abs_delta=float((t_whole - t_chunked).abs().sum()))


def counting_plan(faults, plan):
    """``plan`` as a FaultPlan that counts the dispatch failures it injects,
    so that every failure the engine caught can be told to be an injected
    one."""

    class Counting(faults.FaultPlan):
        injected = 0

        def check_dispatch(self, block):
            try:
                super().check_dispatch(block)
            except faults.InjectedDispatchError:
                self.injected += 1
                raise

    return Counting(plan.events, seed=plan.seed)


def phase_serving_load(torch, K, infer, full_f32):
    """Phase 10: serving under load at smollm-135m's full width (order 2, f32,
    4 slots, n_max N_MAX): (a) chunked against whole prefill, order 2 and
    the hybrid, with order 2's worst state entry recomputed in float64 from
    each path's keys and values (``state_gap_origin``); (b) chunked admission under the SLO policy, with a
    preemption, against FIFO whole-prompt admission; (c) the standard fault
    trace; (d) a Poisson trace replayed under the virtual clock; (e) the
    price of the health sweep and of a preemption's state handoff.
    ``full_f32`` = phase 6's (prompts, outputs, stats): the fault-free
    tokens.  Serving reaches no kernel (the JAX package's prefill and
    decode reach no Pallas kernel either): taylor_fwd launches are counted
    over every serving run and must be 0."""
    import numpy as np

    from repro_torch.backends.taylor import TaylorBackend
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init
    from repro_torch.serve import (Request, ResiliencePolicy, SchedulerPolicy, ServeEngine,
                                   Status, faults, poisson_trace, prefill, prefill_chunked,
                                   run_trace, slots)
    from repro_torch.tree import tree_leaves

    cfg32 = get_config("smollm-135m", dtype="float32")
    hybrid32 = cfg32.replace(**HYBRID)
    params = lm_init(torch.Generator().manual_seed(0), cfg32)  # phase 4's weights
    f_prompts, f_outs, _ = full_f32
    out = {}
    launches = 0

    def engine(**kw):
        return ServeEngine(params, cfg32, max_slots=4, n_max=N_MAX, decode_block=16, **kw)

    # -- (a) chunked against whole prefill --
    gen = torch.Generator().manual_seed(3)
    for (n, chunk), cfg in zip(CHUNK_CASES, (cfg32, hybrid32)):
        tag = "hybrid" if cfg is hybrid32 else "order2"
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, n), generator=gen).cuda()}
        K.taylor_fwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wl, wc = prefill(params, batch, cfg, N_MAX)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cl, cc = prefill_chunked(params, batch, cfg, N_MAX, chunk)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if tag == "order2":  # again, untimed, keeping each layer's keys and values
            with captured_kv(TaylorBackend) as (kv_whole, kv_chunks):
                prefill(params, batch, cfg, N_MAX)
                prefill_chunked(params, batch, cfg, N_MAX, chunk)
            n_layers = len(kv_whole)
            kv_chunked = [tuple(torch.cat(part, dim=2) for part in zip(*kv_chunks[i::n_layers]))
                          for i in range(n_layers)]
            origin = state_gap_origin(torch, cfg, wc, cc, kv_whole, kv_chunked)
        launches += K.taylor_fwd.launches
        logit_err, logit_ratio = tol_ratio(torch, cl, wl, CHUNK_TOL)
        pairs = list(zip(tree_leaves(cc), tree_leaves(wc)))
        if len(pairs) != len(tree_leaves(wc)) or any(a.shape != b.shape for a, b in pairs):
            fail(f"[10a] {tag}: chunked prefill's cache has another structure than prefill's")
        errs = [tol_ratio(torch, a, b, CHUNK_TOL) for a, b in pairs if a.is_floating_point()]
        ints_equal = all(torch.equal(a, b) for a, b in pairs if not a.is_floating_point())
        state_err, state_ratio = max(e for e, _ in errs), max(r for _, r in errs)
        out[f"chunked_{tag}"] = dict(prompt=n, chunk=chunk, logit_err=logit_err,
                                     state_err=state_err, whole_s=t1 - t0, chunked_s=t2 - t1)
        print(f"[10a] {tag} f32 prompt {n}: prefill_chunked(chunk={chunk}) vs prefill: logits "
              f"max_abs_err={logit_err:.3e}, {len(errs)} state leaves max_abs_err={state_err:.3e}, "
              f"max err/(atol + rtol|ref|) = {max(logit_ratio, state_ratio):.3f} (atol = rtol = "
              f"{CHUNK_TOL}); int leaves equal: {ints_equal}; whole {(t1 - t0) * 1e3:.1f} ms, "
              f"chunked {(t2 - t1) * 1e3:.1f} ms (host clock, one call each)")
        if tag == "order2":
            o = origin
            u32 = 2.0 ** -24
            print(f"[10a] order2 worst state entry: layer {o['layer']} leaf {o['leaf']} index "
                  f"{o['index']} (err/(atol + rtol|ref|) {o['ratio']:.3f}): whole f32 "
                  f"{o['whole_f32']:.9g}, chunked f32 {o['chunked_f32']:.9g}; float64 from "
                  f"whole's k/v {o['whole_f64']:.9g}, from chunked's k/v {o['chunked_f64']:.9g}; "
                  f"|whole - f64| {abs(o['whole_f32'] - o['whole_f64']):.3e}, |chunked - f64| "
                  f"{abs(o['chunked_f32'] - o['chunked_f64']):.3e}; sum of |terms| "
                  f"{o['sum_abs']:.6g} (x 2^-24 = {o['sum_abs'] * u32:.3e}), of their "
                  f"differences between the paths' inputs {o['sum_abs_delta']:.3e}")
            out["chunked_order2"]["origin"] = o
        if not (logit_ratio <= 1 and state_ratio <= 1 and ints_equal):
            fail(f"[10a] {tag}: chunked prefill disagrees with whole prefill")
        del wc, cc

    # -- (b) chunked admission under the SLO policy, against FIFO --
    u_gen = torch.Generator().manual_seed(4)
    urgent = [torch.randint(0, cfg32.vocab, (n,), generator=u_gen) for n in URGENT[0]]
    runs = {}
    for name, kw in (("fifo", {}), ("slo", dict(prefill_chunk=LOAD_CHUNK,
                                                  sched=SchedulerPolicy(**SLO_SCHED)))):
        eng = engine(**kw)
        K.taylor_fwd.launches = 0
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW, priority=1))
                for p in f_prompts]
        eng.step()
        rids += [eng.submit(Request(tokens=u.numpy(), max_new_tokens=URGENT[1], priority=0))
                 for u in urgent]
        res = eng.run(return_results=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += K.taylor_fwd.launches
        st = eng.stats()
        del eng
        if any(res[r].status is not Status.OK for r in rids):
            fail(f"[10b] {name}: statuses {[res[r].status.value for r in rids]}")
        check_no_faults(st, f"[10b] {name}")
        ttft = [res[r].first_token_at - res[r].submitted_at for r in rids]
        runs[name] = dict(tokens=[res[r].tokens.astype(np.int64) for r in rids], ttft=ttft,
                          stats=st, wall=wall)
        print(f"[10b] {name}: {len(rids)} requests in {wall:.2f} s; TTFT of the priority-0 "
              f"{URGENT[0][0]}-token request {ttft[-2] * 1e3:.1f} ms, of the "
              f"{URGENT[0][1]}-token one {ttft[-1] * 1e3:.1f} ms; prefill "
              f"{st['prefill_dispatches']} dispatches {st['prefill_seconds']:.3f} s, decode "
              f"{st['decode_tokens']} tokens in {st['decode_seconds']:.3f} s = "
              f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s; preemptions "
              f"{st.get('preemptions', 0)} resumes {st.get('resumes', 0)}")
    st = runs["slo"]["stats"]
    if not (st.get("preemptions", 0) >= 1 and st.get("resumes", 0) == st["preemptions"]):
        fail(f"[10b] SLO policy: preemptions {st.get('preemptions', 0)}, "
             f"resumes {st.get('resumes', 0)}")
    differ, ties, bad = diverging_requests(torch, infer, params, cfg32, f_prompts + urgent,
                                           runs["fifo"]["tokens"], runs["slo"]["tokens"])
    print(f"[10b] SLO-policy tokens vs FIFO whole-prompt tokens: {differ} of "
          f"{len(f_prompts) + len(urgent)} requests differ, {ties} at a near-tie "
          f"(gap<{NEAR_TIE}), {bad} not")
    if bad:
        fail(f"[10b] {bad} requests' tokens differ between the SLO and FIFO engines")
    out["ttft_ms"] = {k: r["ttft"][-2] * 1e3 for k, r in runs.items()}
    out["slo_preemptions"] = st["preemptions"]

    # -- (c) the standard fault trace --
    plan = counting_plan(faults, faults.standard_trace(slot=0))
    eng = engine(fault_plan=plan, policy=ResiliencePolicy(max_queue=FAULT_MAX_QUEUE))
    K.taylor_fwd.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW)) for p in f_prompts]
    res = eng.run(return_results=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches += K.taylor_fwd.launches
    st = eng.stats()
    del eng
    terminal = sum(st.get(k, 0) for k in ("ok", "degraded", "timed_out", "failed", "rejected"))
    statuses = {s.value: sum(r.status is s for r in res.values()) for s in Status}
    print(f"[10c] standard fault trace (flood of 6 at block 1, a dispatch failure at 2, NaN in "
          f"slot 0 at 3; max_queue {FAULT_MAX_QUEUE}) on {len(rids)} requests in {wall:.2f} s: "
          f"{st['submitted']} submitted, terminal {statuses}; dispatch_failures "
          f"{st.get('dispatch_failures', 0)} (injected {plan.injected}), dispatch_retries "
          f"{st.get('dispatch_retries', 0)}, corruptions {st.get('corruptions_injected', 0)}, "
          f"quarantined {st.get('quarantined', 0)}, retries {st.get('retries', 0)}, shed "
          f"{st.get('shed', 0)}, cache_rebuilds {st.get('cache_rebuilds', 0)}, health_checks "
          f"{st.get('health_checks', 0)}")
    if sorted(res) != list(range(st["submitted"])) or terminal != st["submitted"]:
        fail(f"[10c] {st['submitted']} submitted, {len(res)} results, {terminal} terminal")
    if any(res[r].status is not Status.OK for r in rids):
        fail(f"[10c] statuses {[res[r].status.value for r in rids]}")
    if not (plan.injected == 1 and st.get("dispatch_failures", 0) == plan.injected):
        fail(f"[10c] {st.get('dispatch_failures', 0)} dispatch failures caught, "
             f"{plan.injected} injected")
    if st.get("quarantined", 0) < 1 or st.get("cache_rebuilds", 0) != 0:
        fail(f"[10c] quarantined {st.get('quarantined', 0)} (>= 1), cache_rebuilds "
             f"{st.get('cache_rebuilds', 0)} (0: one failure is retried in place)")
    differ, ties, bad = diverging_requests(torch, infer, params, cfg32, f_prompts, f_outs,
                                           [res[r].tokens.astype(np.int64) for r in rids])
    print(f"[10c] tokens vs the fault-free run (phase 6): {differ} requests differ, {ties} at "
          f"a near-tie, {bad} not")
    if bad:
        fail(f"[10c] {bad} requests' tokens differ from the fault-free run")

    # -- (d) a replayed Poisson trace under the virtual clock --
    trace = poisson_trace(vocab=cfg32.vocab, **REPLAY)
    held = []

    def factory(clock):
        held.append(engine(prefill_chunk=LOAD_CHUNK, sched=SchedulerPolicy(**SLO_SCHED),
                           clock=clock))
        return held[-1]

    K.taylor_fwd.launches = 0
    t0 = time.perf_counter()
    report = run_trace(factory, trace, "slo")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches += K.taylor_fwd.launches
    st = held.pop().stats()
    check_no_faults(st, "[10d]")
    delivered = report.metrics["n_delivered"]
    print(f"[10d] LoadReport {report.to_json()}")
    print(f"[10d] replay of poisson_trace({REPLAY}) at full width: {len(trace)} requests, "
          f"{delivered} delivered, in {wall:.2f} s wall; decode {st['decode_tokens']} tokens "
          f"in {st['decode_seconds']:.3f} s = {st['decode_tokens'] / st['decode_seconds']:.1f} "
          f"tokens/s; prefill {st['prefill_dispatches']} dispatches {st['prefill_seconds']:.3f} s")
    if delivered != len(trace):
        fail(f"[10d] {delivered} of {len(trace)} requests delivered")
    out["replay"] = dict(wall_s=wall, decode_tokens_per_s=st["decode_tokens"]
                         / st["decode_seconds"], metrics=report.metrics)

    # -- (e) the price of the health sweep and of a preemption's state handoff --
    sweep = {}
    for every in (0, 1):
        eng = engine(policy=ResiliencePolicy(health_check_every=every))
        K.taylor_fwd.launches = 0
        t0 = time.perf_counter()
        for p in f_prompts:
            eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW))
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += K.taylor_fwd.launches
        st = eng.stats()
        check_no_faults(st, f"[10e] health_check_every={every}")
        sweep[every] = dict(wall=wall, checks=st.get("health_checks", 0),
                            tps=st["decode_tokens"] / (wall - st["prefill_seconds"]),
                            decode_tps=st["decode_tokens"] / st["decode_seconds"])
        if every:
            health_ms = host_ms(torch, lambda: slots.slot_health(eng.caches, cfg32).cpu(), 5)
            one = slots.read_slot(eng.caches, 1)
            handoff_ms = host_ms(torch, lambda: slots.write_slot(
                eng.caches, slots.read_slot(eng.caches, 1), 1), 5)
            slot_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(one))
        del eng
    print(f"[10e] phase 6's requests with health_check_every=0 / 1: wall {sweep[0]['wall']:.2f} / "
          f"{sweep[1]['wall']:.2f} s, {sweep[0]['checks']} / {sweep[1]['checks']} sweeps; decode "
          f"tokens over (wall - prefill) {sweep[0]['tps']:.1f} / {sweep[1]['tps']:.1f} tokens/s "
          f"(over decode_seconds {sweep[0]['decode_tps']:.1f} / {sweep[1]['decode_tps']:.1f}); "
          f"one slot_health sweep of the 4-slot cache {health_ms:.3f} ms; a preemption's "
          f"read_slot + write_slot of one {slot_bytes}-byte slot {handoff_ms:.3f} ms "
          f"(host clock with sync, median of 5)")
    out.update(sweep=sweep, health_ms=health_ms, handoff_ms=handoff_ms, slot_bytes=slot_bytes)

    print(f"[10] taylor_fwd launches over phase 10's serving runs: {launches} (chunked and "
          f"whole prefill and decode run the torch moment-state paths)")
    if launches:
        fail(f"[10] serving launched taylor_fwd {launches} times")
    out["launches"] = launches
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core.feature_map import layernorm_no_affine
    from repro_torch.kernels.taylor_attention import kernel as K
    from repro_torch.kernels.taylor_attention import ops
    from repro_torch.kernels.taylor_attention import ref as ref_mod
    from repro_torch.data import make_task
    from repro_torch.models import lm_apply, lm_decode_step, lm_init, lm_init_caches
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import loss_and_grads, make_loss_fn, make_train_step
    from repro_torch.train import train_state_init
    from repro_torch.tree import tree_leaves

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build (one nvcc per source, in parallel) ----
    t0 = time.perf_counter()
    K.build()
    print(f"[2] built {', '.join(K.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(K.build_log):
        print(f"[2] {line}")
    count, spills = ptxas_spills(K.build_log)
    print(f"[2] ptxas: {count} kernel instantiations (every d and order), "
          f"{len(spills)} with spills" + "".join(f"\n[2]   {x}" for x in spills))

    # ---- 3. kernels against their plain versions ----
    ln = layernorm_no_affine
    krows = phase_kernel(torch, K, ops, ref_mod, ln)
    brows = phase_backward(torch, K, ops, ref_mod, ln)

    # ---- 4. full-width forward through the kernel ----
    cfg = get_config("smollm-135m")
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen).cuda()
    K.taylor_fwd.launches = 0
    with torch.no_grad():
        logits, _ = lm_apply(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    launches = K.taylor_fwd.launches
    print(f"[4] lm_apply smollm-135m b=4 n=1024 {cfg.dtype}: taylor_fwd launches={launches}")
    if launches != cfg.n_layers:
        fail(f"lm_apply launched taylor_fwd {launches} times, expected {cfg.n_layers}")
    if logits.shape != (4, 1024, cfg.vocab) or not torch.isfinite(logits).all():
        fail("lm_apply logits have the wrong shape or are not finite")
    infer = torch.no_grad()(lm_apply)
    ref_logits, _ = infer(params, {"tokens": tokens}, cfg.replace(attn_impl="torch"))
    fwd_err = rel_err(torch, logits, ref_logits)
    agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    fwd_ms = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 3)
    ref_ms = cuda_ms(
        torch, lambda: infer(params, {"tokens": tokens}, cfg.replace(attn_impl="torch")), 3
    )
    print(f"[4] logits vs attn_impl='torch': rel_err={fwd_err:.3e} argmax_agree={agree:.4f} "
          f"forward_ms={fwd_ms:.2f} forward_ms(torch attention)={ref_ms:.2f}")
    # bf16 activations: both paths round each layer's attention output to bf16
    # after float32 sums taken in different orders; over 30 layers that moves
    # logits by a few bf16 ulps of their range.  (argmax agreement is only
    # reported: random weights give many near-tied logits.)
    if not fwd_err < 5e-2:
        fail(f"kernel forward disagrees with the torch forward: rel err {fwd_err}")
    cfg32 = cfg.replace(dtype="float32")
    err32 = rel_err(torch, infer(params, {"tokens": tokens}, cfg32)[0],
                    infer(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
    print(f"[4] float32 activations: logits rel_err kernel vs torch = {err32:.3e} (tol 1e-3)")
    if not err32 < 1e-3:
        fail(f"float32 kernel forward disagrees with the torch forward: {err32}")
    qa = torch.randn(4, cfg.n_heads, 1024, 64, device="cuda", dtype=torch.bfloat16)
    ka, va = (torch.randn(4, cfg.n_kv_heads, 1024, 64, device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    with torch.no_grad():
        layer_ms = cuda_ms(torch, lambda: ops.taylor_attention_kernel_trainable(qa, ka, va), 5)
    del logits, ref_logits
    print(f"[4] one layer's taylor_attention_kernel_trainable at b=4 n=1024 bf16 (with layout and "
          f"LayerNorm): {layer_ms:.4f} ms; x{cfg.n_layers} layers = "
          f"{cfg.n_layers * layer_ms:.2f} ms of the {fwd_ms:.2f} ms forward")

    # ---- 5. serving ----
    K.taylor_fwd.launches = 0
    prompts, outs, st, wall, _ = serve_requests(torch, ServeEngine, Request, params, cfg)
    print(f"[5] served {len(outs)} requests x {MAX_NEW} tokens on 4 slots in {wall:.2f} s: "
          f"prefill {st['prefill_seconds']:.3f} s over {st['prefill_dispatches']} dispatches "
          f"({st['prefill_tokens']} tokens), decode {st['decode_tokens']} tokens in "
          f"{st['decode_seconds']:.3f} s = {st['decode_tokens'] / st['decode_seconds']:.1f} "
          f"tokens/s, taylor_fwd launches {K.taylor_fwd.launches}")

    # one decode step of 4 slots: host time to enqueue it vs time to finish it
    caches = lm_init_caches(cfg, 4, 1024)
    tok = torch.zeros(4, dtype=torch.int64, device="cuda")
    pos = torch.full((4,), 100, dtype=torch.int32, device="cuda")
    lm_decode_step(params, tok, caches, pos, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm_decode_step(params, tok, caches, pos, cfg)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    print(f"[5] one decode step (4 slots, 30 layers): host enqueue {enqueue_ms:.2f} ms, "
          f"finished after {step_ms:.2f} ms")

    # ---- 6. cross-check in float32: engine tokens vs lm_apply argmax ----
    prompts, outs, st, _, _ = serve_requests(torch, ServeEngine, Request, params, cfg32)
    mismatches, near_ties = cross_check(torch, infer, params, cfg32, prompts, outs)
    print(f"[6] f32 engine tokens vs lm_apply argmax over {len(outs) * MAX_NEW} positions: "
          f"mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}; f32 decode "
          f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s")
    if mismatches:
        fail(f"{mismatches} engine tokens differ from the kernel forward's argmax")

    # ---- 7. full-width training through the kernels ----
    del params
    train = phase_train(torch, K, cfg, make_task, adamw, cosine_warmup, train_state_init,
                        make_train_step, make_loss_fn, loss_and_grads, tree_leaves)

    # ---- 8. the baselines at full width ----
    serve_fn = lambda p_, c_: serve_requests(torch, ServeEngine, Request, p_, c_)
    cross_fn = lambda p_, c_, prompts_, outs_: cross_check(torch, infer, p_, c_, prompts_, outs_)
    _, base_launches = phase_baselines(torch, K, infer, serve_fn, cross_fn)

    # ---- 9. the hybrid schedule and the Taylor variants at full width ----
    hybrid = phase_hybrid(torch, K, infer, serve_fn, cross_fn, (prompts, outs, st))
    print("[9] summary (smollm-135m full width; forward b=4 n=1024 bf16, training b=4 n=1024 "
          "bf16 remat full, decode f32 on 4 slots): "
          f"hybrid: forward {hybrid['forward_ms']:.2f} ms, train "
          f"{hybrid['train_ms_per_step']:.1f} ms/step ({hybrid['train_tokens_per_s']:.0f} "
          f"tokens/s, peak {hybrid['peak_gib']:.2f} GiB), decode "
          f"{hybrid['decode_tokens_per_s']:.1f} tokens/s, prefill {hybrid['prefill_s']:.3f} s, "
          f"{hybrid['slot_bytes']} bytes per slot (order-2 taylor {hybrid['taylor_slot_bytes']}); "
          f"sym_state: decode {hybrid['sym_state']['decode_tokens_per_s']:.1f} tokens/s "
          f"(full {hybrid['sym_state']['full_decode_tokens_per_s']:.1f}), "
          f"{hybrid['sym_state']['slot_bytes']} bytes per slot "
          f"(full {hybrid['sym_state']['full_slot_bytes']}); decay {DECAY}: train "
          f"{hybrid['decay']['train_ms_per_step']:.1f} ms/step, decode "
          f"{hybrid['decay']['decode_tokens_per_s']:.1f} tokens/s")

    # ---- 10. serving under load at full width ----
    load = phase_serving_load(torch, K, infer, (prompts, outs, st))
    print("[10] summary (smollm-135m full width, order 2, f32, 4 slots): chunked prefill "
          f"{load['chunked_order2']['chunked_s'] * 1e3:.1f} ms vs whole "
          f"{load['chunked_order2']['whole_s'] * 1e3:.1f} ms at {CHUNK_CASES[0][0]} tokens; "
          f"TTFT of the urgent {URGENT[0][0]}-token request {load['ttft_ms']['slo']:.1f} ms "
          f"(SLO) vs {load['ttft_ms']['fifo']:.1f} ms (FIFO); replay "
          f"{load['replay']['wall_s']:.2f} s wall, decode "
          f"{load['replay']['decode_tokens_per_s']:.1f} tokens/s; sweep "
          f"{load['health_ms']:.3f} ms per block")

    # ---- 11. kernels line ----
    row = krows["bfloat16"]
    shape = dict(MAIN, dtype="bfloat16")
    src = "src/repro_torch/kernels/taylor_attention/"
    kernels = [{
        "name": "taylor_fwd",
        "route": "cuda",
        "source": src + "csrc/taylor_fwd.cu",
        "replaces": "src/repro/kernels/taylor_attention/kernel.py:107",
        "launches": train["launches"]["taylor_fwd"],
        "launches_by_path": {
            "lm_apply": launches, "train_8_steps": train["launches"]["taylor_fwd"],
            "order1_lm_apply": base_launches["lm_apply"],
            f"order1_train_{BASELINE_STEPS}_steps": base_launches["train"]["taylor_fwd"],
            "hybrid_lm_apply": hybrid["lm_apply_launches"]["taylor_fwd"],
            f"hybrid_train_{HYBRID_STEPS}_steps": hybrid["train_launches"]["taylor_fwd"]},
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],  # tensor cores: the products as the kernel issues them
        "bound_by": row["bound_by"],
        "library_ms": None,
        "bound_f32_cores_ms": row["bound_f32_cores_ms"],
        "ms_train_shape": krows[case_name(TRAIN_ATTN, "bfloat16")]["ms"],
        "plain_ms_train_shape": krows[case_name(TRAIN_ATTN, "bfloat16")]["plain_ms"],
        "shape": shape,
    }]
    for name, line in (("taylor_bwd_dq", 55), ("taylor_bwd_dkv", 158)):
        b = brows["bfloat16"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "csrc/taylor_bwd.cu",
            "replaces": f"src/repro/kernels/taylor_attention/kernel_bwd.py:{line}",
            "launches": train["launches"][name],
            "launches_by_path": {
                "train_8_steps": train["launches"][name],
                f"order1_train_{BASELINE_STEPS}_steps": base_launches["train"][name],
                "hybrid_lm_apply": hybrid["lm_apply_launches"][name],
                f"hybrid_train_{HYBRID_STEPS}_steps": hybrid["train_launches"][name]},
            "max_abs_err": b["max_abs_err"],
            "ms": b["ms"],
            "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"],  # tensor cores: the products as the kernel issues them
            "bound_by": b["bound_by"],
            "library_ms": None,
            "bound_f32_cores_ms": b["bound_f32_cores_ms"],
            "ms_train_shape": brows[case_name(TRAIN_ATTN, "bfloat16")][name]["ms"],
            "plain_ms_train_shape": brows[case_name(TRAIN_ATTN, "bfloat16")][name]["plain_ms"],
            "shape": shape,
        })
    print(json.dumps({"kernels": kernels}))

    # ---- 12. device line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
