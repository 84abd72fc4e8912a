#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernel from the sources in this checkout, holds it against
its plain PyTorch version, drives smollm-135m's full-width inference forward
and its serving engine (random weights from a seed), cross-checks the two,
and prints one JSON line describing every ported kernel followed by the
device line.  Any failed phase exits non-zero.  Needs a CUDA device.

    python3 chip_smoke.py
"""

from __future__ import annotations

import json
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

MAIN = dict(b=4, hk=3, g=3, n=2048, d=64, dv=64)  # phase 3's main-path launch
EDGE = [  # (b, h, hk, n, d, dv, order): the JAX kernel tests' sweep + order 1
    (1, 2, 1, 256, 128, 128, 2),
    (2, 4, 2, 256, 64, 64, 2),
    (1, 3, 3, 384, 112, 112, 2),   # d=112 padded to 128
    (1, 2, 1, 300, 128, 128, 2),   # sequence padding
    (1, 8, 1, 128, 128, 128, 2),   # MQA, G=8
    (1, 2, 2, 256, 64, 256, 2),    # dv=256: 32 value tiles
    (1, 2, 2, 256, 64, 64, 1),     # order 1
]
PROMPT_LENS = (100, 256, 300, 384, 512, 700)
MAX_NEW = 32
F32_TOL, BF16_TOL = 1e-4, 1e-2
NEAR_TIE = 1e-3


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
    """(operations, bytes) of one forward: intra-chunk tiles, state reads and
    state updates; each input read once and the output written once."""
    quad = 2 * d * d * dv + 2 * d * d if order >= 2 else 0
    lin = 2 * d * dv + 2 * d
    ops = bk * (g * n * chunk * 2 * (d + dv) + g * n * (quad + lin) + n * (quad + lin))
    nbytes = itemsize * (bk * g * n * d + bk * n * d + bk * n * dv + bk * g * n * dv)
    return ops, nbytes


def rel_err(torch, out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


def phase_kernel(torch, K, ops, ref_mod, ln):
    """Phase 3: the kernel against its plain version on the card."""
    m = MAIN
    bk = m["b"] * m["hk"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = ln(torch.randn(bk, m["g"], m["n"], m["d"], device="cuda", generator=gen)).to(dtype)
        k = ln(torch.randn(bk, m["n"], m["d"], device="cuda", generator=gen)).to(dtype)
        v = torch.randn(bk, m["n"], m["dv"], device="cuda", generator=gen).to(dtype)
        out = K.taylor_fwd(q, k, v, alpha=3.0)
        ref = ref_mod.taylor_attention_ref(q[None], k[None], v[None], alpha=3.0)[0]
        torch.cuda.synchronize()
        err = rel_err(torch, out, ref)
        tol = F32_TOL if dtype == torch.float32 else BF16_TOL
        kernel_ms = cuda_ms(torch, lambda: K.taylor_fwd(q, k, v, alpha=3.0), 10)
        plain_ms = cuda_ms(
            torch, lambda: ref_mod.taylor_attention_ref(q[None], k[None], v[None]), 3
        )
        flops, nbytes = taylor_fwd_cost(bk, m["g"], m["n"], m["d"], m["dv"],
                                        K.TILES[m["d"]][1], q.element_size())
        bound_ms = max(flops / F32_FLOPS, nbytes / HBM_BYTES) * 1e3
        bound_tf32_ms = max(flops / TF32_FLOPS, nbytes / HBM_BYTES) * 1e3
        name = str(dtype).replace("torch.", "")
        print(f"[3] taylor_fwd {name} {m}: rel_err={err:.3e} (tol {tol}) "
              f"max_abs_err={float((out.float() - ref.float()).abs().max()):.3e} "
              f"kernel_ms={kernel_ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms(f32 cores)={bound_ms:.4f} bound_ms(tf32)={bound_tf32_ms:.4f} "
              f"gflop={flops / 1e9:.2f} achieved_tflops={flops / kernel_ms / 1e9:.2f}")
        if not err < tol:
            fail(f"taylor_fwd {name} rel err {err} >= {tol}")
        rows[name] = dict(
            max_abs_err=float((out.float() - ref.float()).abs().max()),
            rel_err=err, ms=kernel_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_tf32_ms=bound_tf32_ms,
        )
    for b, h, hk, n, d, dv, order in EDGE:
        q = torch.randn(b, h, n, d, device="cuda", generator=gen)
        k = torch.randn(b, hk, n, d, device="cuda", generator=gen)
        v = torch.randn(b, hk, n, dv, device="cuda", generator=gen)
        out = ops.taylor_attention_kernel(q, k, v, order=order)
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


def serve_requests(torch, ServeEngine, Request, params, cfg):
    """Phase 5/6 traffic: 6 greedy requests on 4 slots."""
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen) for n in PROMPT_LENS]
    eng = ServeEngine(params, cfg, max_slots=4, n_max=1024, decode_block=16)
    rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW)) for p in prompts]
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid, p in zip(rids, prompts):
        if rid not in outs or len(outs[rid]) != MAX_NEW:
            fail(f"request of prompt {len(p)} did not finish with {MAX_NEW} tokens")
    return prompts, [outs[r] for r in rids], eng.stats(), wall


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
    from repro_torch.models import lm_apply, lm_decode_step, lm_init, lm_init_caches
    from repro_torch.serve import Request, ServeEngine

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

    # ---- 2. build ----
    t0 = time.perf_counter()
    K.build()
    print(f"[2] built taylor_fwd in {time.perf_counter() - t0:.1f} s")
    print(K.build_log.strip())

    # ---- 3. kernel against its plain version ----
    ln = layernorm_no_affine
    krows = phase_kernel(torch, K, ops, ref_mod, ln)

    # ---- 4. full-width forward through the kernel ----
    cfg = get_config("smollm-135m")
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen).cuda()
    K.taylor_fwd.launches = 0
    logits, _ = lm_apply(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    launches = K.taylor_fwd.launches
    print(f"[4] lm_apply smollm-135m b=4 n=1024 {cfg.dtype}: taylor_fwd launches={launches}")
    if launches != cfg.n_layers:
        fail(f"lm_apply launched taylor_fwd {launches} times, expected {cfg.n_layers}")
    if logits.shape != (4, 1024, cfg.vocab) or not torch.isfinite(logits).all():
        fail("lm_apply logits have the wrong shape or are not finite")
    ref_logits, _ = lm_apply(params, {"tokens": tokens}, cfg.replace(attn_impl="torch"))
    fwd_err = rel_err(torch, logits, ref_logits)
    agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    fwd_ms = cuda_ms(torch, lambda: lm_apply(params, {"tokens": tokens}, cfg), 3)
    ref_ms = cuda_ms(
        torch, lambda: lm_apply(params, {"tokens": tokens}, cfg.replace(attn_impl="torch")), 3
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
    err32 = rel_err(torch, lm_apply(params, {"tokens": tokens}, cfg32)[0],
                    lm_apply(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
    print(f"[4] float32 activations: logits rel_err kernel vs torch = {err32:.3e} (tol 1e-3)")
    if not err32 < 1e-3:
        fail(f"float32 kernel forward disagrees with the torch forward: {err32}")
    qa = torch.randn(4, cfg.n_heads, 1024, 64, device="cuda", dtype=torch.bfloat16)
    ka, va = (torch.randn(4, cfg.n_kv_heads, 1024, 64, device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    layer_ms = cuda_ms(torch, lambda: ops.taylor_attention_kernel(qa, ka, va), 5)
    print(f"[4] one layer's taylor_attention_kernel at b=4 n=1024 bf16 (with layout and "
          f"LayerNorm): {layer_ms:.4f} ms; x{cfg.n_layers} layers = "
          f"{cfg.n_layers * layer_ms:.2f} ms of the {fwd_ms:.2f} ms forward")

    # ---- 5. serving ----
    K.taylor_fwd.launches = 0
    prompts, outs, st, wall = serve_requests(torch, ServeEngine, Request, params, cfg)
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
    prompts, outs, _, _ = serve_requests(torch, ServeEngine, Request, params, cfg32)
    mismatches, near_ties = cross_check(torch, lm_apply, params, cfg32, prompts, outs)
    print(f"[6] f32 engine tokens vs lm_apply argmax over {len(outs) * MAX_NEW} positions: "
          f"mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}")
    if mismatches:
        fail(f"{mismatches} engine tokens differ from the kernel forward's argmax")

    # ---- 7. kernels line ----
    row = krows["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "taylor_fwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/taylor_attention/csrc/taylor_fwd.cu",
        "replaces": "src/repro/kernels/taylor_attention/kernel.py:107",
        "launches": launches,
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": "operations",
        "library_ms": None,
        "bound_tf32_ms": row["bound_tf32_ms"],
        "shape": dict(MAIN, dtype="bfloat16"),
    }]}))

    # ---- 8. device line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
