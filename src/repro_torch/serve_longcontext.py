"""Long-context serving economics: the paper's O(1) decode state vs a KV cache.

The port's counterpart of the JAX package's ``examples/serve_longcontext.py``.

Part 1 — cache growth: the same reduced MQA model (granite-20b, one kv
head) on the taylor and softmax backends; decode-cache bytes as the
context capacity grows.  The taylor moment state stays constant; the KV
cache grows linearly.

Part 2 — continuous batching: a burst of mixed-length requests on reduced
qwen2-1.5b through ``ServeEngine`` (slotted moment-state cache, decode
blocks, mid-flight admission) against the one-request-at-a-time per-token
loop ``generate_loop``.

It runs on the CUDA card; pass ``--device cpu`` for the CPU.  The two
parts' functions take smaller sizes (``cache_growth(device, n_ctxs)``,
``continuous_batching(device, n_req, new_tokens)``).

  PYTHONPATH=src python -m repro_torch.serve_longcontext --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_reduced
from repro_torch.device import resolve_device
from repro_torch.models import lm_init
from repro_torch.models.lm import lm_decode_step, lm_init_caches, lm_prefill
from repro_torch.serve import Request, ServeEngine, generate_loop
from repro_torch.tree import tree_leaves

N_CTX = (256, 2048, 16384)


def cache_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def cache_growth(device, n_ctxs=N_CTX):
    """{backend: {n_ctx: (cache bytes, µs per decode token)}}."""
    rng = np.random.default_rng(0)
    out = {}
    for backend in ("taylor", "softmax"):
        cfg = get_reduced("granite-20b").replace(attention=backend)
        params = lm_init(torch.Generator().manual_seed(0), cfg, device=device)
        print(f"\n== backend: {backend} (MQA kv=1) ==")
        out[backend] = {}
        for n_ctx in n_ctxs:
            caches = lm_init_caches(cfg, 1, n_ctx, device=device)
            prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 64))).to(device)
            _, caches_p = lm_prefill(params, {"tokens": prompt}, cfg, n_max=n_ctx)
            tok = torch.zeros((1,), dtype=torch.int64, device=device)
            logits, caches_p = lm_decode_step(params, tok, caches_p, 64, cfg)
            _sync(device)
            t0 = time.perf_counter()
            for i in range(8):
                logits, caches_p = lm_decode_step(params, tok, caches_p, 65 + i, cfg)
            _sync(device)
            us = (time.perf_counter() - t0) / 8 * 1e6
            out[backend][n_ctx] = (cache_bytes(caches), us)
            print(f"  n_ctx={n_ctx:6d}: decode cache = {cache_bytes(caches):>12,} B, "
                  f"{us:8.0f} µs/token")
    print("\ntaylor cache is context-independent; the KV cache grows linearly.")
    return out


def continuous_batching(device, n_req=8, new_tokens=32):
    """(tokens/s of the per-token loop, of the engine, per-slot state bytes)."""
    rng = np.random.default_rng(0)
    cfg = get_reduced("qwen2-1.5b")  # taylor backend
    params = lm_init(torch.Generator().manual_seed(0), cfg, device=device)
    prompts = [rng.integers(0, cfg.vocab, (int(n),)).astype(np.int64)
               for n in rng.integers(8, 33, n_req)]
    print(f"\n== continuous batching: {n_req} mixed-length requests, "
          f"{new_tokens} new tokens each ==")

    def loop_pass():
        return [generate_loop(params, {"tokens": torch.from_numpy(p)[None].to(device)}, cfg,
                              steps=new_tokens, n_max=128, device=device)[0]
                for p in prompts]

    def engine_pass():
        eng = ServeEngine(params, cfg, max_slots=4, n_max=128, decode_block=16, device=device)
        rids = [eng.submit(Request(tokens=p, max_new_tokens=new_tokens)) for p in prompts]
        outs = eng.run()
        if not all(len(outs[r]) == new_tokens for r in rids):
            raise SystemExit("a request did not finish with its budget of tokens")
        return eng, [outs[r] for r in rids]

    def timed(fn):
        fn()  # warmup
        _sync(device)
        t0 = time.perf_counter()
        res = fn()
        _sync(device)
        return res, time.perf_counter() - t0

    loop_toks, t_loop = timed(loop_pass)
    (eng, eng_toks), t_eng = timed(engine_pass)
    for a, b in zip(loop_toks, eng_toks):
        if not np.array_equal(a.cpu().numpy(), np.asarray(b)):
            raise SystemExit("the engine's tokens differ from the per-token loop's")
    total = n_req * new_tokens
    print(f"  old per-token loop (1 request/call): {total / t_loop:8.0f} tok/s")
    print(f"  ServeEngine (4 slots, block=16):     {total / t_eng:8.0f} tok/s")
    print(f"  per-slot decode state:               {eng.slot_state_bytes:,} B "
          f"(O(1) in context on the taylor backend)")
    return total / t_loop, total / t_eng, eng.slot_state_bytes


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    return cache_growth(device), continuous_batching(device)


if __name__ == "__main__":
    main()
