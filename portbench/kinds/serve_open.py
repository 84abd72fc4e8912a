"""Traffic kind ``serve_open``: requests offered to the program's
``ServeEngine`` in an open loop at the cell's fixed rate.

Set-up draws the weights on the card in the type they are served in, builds
the engine with the cell's slots, ``n_max`` and decode block (whole-prompt
admission), and warms it with one request of the cell's longest prompt and
one decode block.  The window offers the requests of ``traffic.open_loop``:
each is submitted as soon as the loop finds it due (between engine steps),
and the engine is stepped while it has work.  The engine reads the
harness's clock (``time.perf_counter``); a request's time to first token
runs from the moment it was due, so a stall delays every request behind it.
After the window no request is added, and the engine is stepped until every
request due in the window has ended or the cell's drain limit has passed; a
request that fails or does not end counts as missing, with infinite time.

The check takes a sample of the finished requests drawn from the seed, the
longest among them, and runs the plain reference once over each prompt
with its served tokens: the number is the widest gap by which a served
token's reference logit lies below the reference's best at its position
(greedy decoding throughout).
"""

from __future__ import annotations

import gc
import math
import time

import numpy as np
import torch

from portbench import compare, program, traffic, weights
from portbench.reference import model as ref


def _finished(res) -> bool:
    from repro_torch.serve import Status

    return res is not None and res.status == Status.OK


def build(h):
    """The engine over the drawn weights, warmed with one request of the
    cell's longest prompt and one decode block: (engine, dtype)."""
    from repro_torch.serve import Request, ServeEngine

    cfg, cell = h.config, h.cell
    tr = cell["traffic"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[cell["precision"]["param_dtype"]]
    mc = program.model_config(cfg, cell["precision"])
    params = program.to_program(cfg, weights.draw(cfg, h.seed, h.device, dtype), dtype)
    engine = ServeEngine(params, mc, max_slots=tr["slots"], n_max=tr["n_max"],
                         decode_block=tr["decode_block"], device=h.device,
                         clock=time.perf_counter)
    del params
    warm = np.random.default_rng(h.seed).integers(0, cfg["vocab"], tr["prompt"]["hi"])
    engine.submit(Request(tokens=warm, max_new_tokens=tr["decode_block"] + 1))
    engine.run()
    return engine, dtype


def window(h, engine, arrivals) -> dict:
    """Offers ``arrivals`` over a window of ``h.seconds`` and drains: each
    request's ttft and tpot (ms, infinite when missing), the output tokens
    finished in the window, the finished (arrival, tokens) pairs and the
    engine's counters over the window."""
    from repro_torch.serve import Request

    tr = h.cell["traffic"]
    before = engine.stats()
    rid_of, results = {}, {}
    busy, nxt = False, 0
    with h.tracer.window():
        t_start = time.perf_counter()
        while True:
            now = time.perf_counter() - t_start
            while nxt < len(arrivals) and arrivals[nxt].due_s <= now:
                a = arrivals[nxt]
                with h.tracer.span("engine.submit"):
                    rid_of[nxt] = engine.submit(Request(tokens=a.prompt, max_new_tokens=a.max_new))
                nxt, busy = nxt + 1, True
            if now >= h.seconds:
                break
            if busy:
                with h.tracer.span("engine.step"):
                    busy = engine.step()
                results.update(engine.poll())
            else:
                due = arrivals[nxt].due_s if nxt < len(arrivals) else h.seconds
                time.sleep(max(0.0, min(due, h.seconds) - now))
        window_stats = engine.stats()
    drain_end = time.perf_counter() + tr["drain_s"]
    while busy and time.perf_counter() < drain_end:
        busy = engine.step()
        results.update(engine.poll())
    close = t_start + h.seconds
    ttft, tpot, served, done = [], [], 0, []
    for j, a in enumerate(arrivals):
        res = results.get(rid_of.get(j))
        if not _finished(res) or res.finished_at > drain_end:
            ttft.append(math.inf)
            tpot.append(math.inf)
            continue
        due = t_start + a.due_s
        ttft.append(1e3 * (res.first_token_at - due))
        tpot.append(1e3 * (res.finished_at - res.first_token_at) / max(1, len(res.tokens) - 1))
        if res.finished_at <= close:
            served += len(res.tokens)
        done.append((a, np.asarray(res.tokens)))
    stats = {k: window_stats.get(k, 0) - before.get(k, 0)
             for k in ("prefill_tokens", "prefill_seconds", "decode_seconds", "decode_dispatches")}
    return {"ttft": ttft, "tpot": tpot, "served": served, "done": done, "stats": stats,
            "queue_at_close": window_stats.get("queue_depth", 0)}


def serve(h) -> dict:
    """Set-up, the window and the drain; the engine is freed at the end."""
    engine, dtype = build(h)
    arrivals = traffic.open_loop(h.seed, h.cell["traffic"], h.seconds, h.config["vocab"])
    setup_s = time.perf_counter() - h.t0
    out = window(h, engine, arrivals)
    peak = torch.cuda.max_memory_allocated(h.device) if h.device.type == "cuda" else 0
    del engine
    gc.collect()
    if h.device.type == "cuda":
        torch.cuda.empty_cache()
    return dict(out, setup_s=setup_s, peak=peak, dtype=dtype)


def run(h) -> dict:
    out = serve(h)
    ttft = out["ttft"]
    with h.tracer.span("reference"):
        picked = sample(h.seed, out["done"], h.cell["traffic"]["sample"]) if out["done"] else []
        gap = reference_gap(h, h.config, picked, out["dtype"]) if picked else math.inf
    return {
        "setup_s": out["setup_s"],
        "e2e": {"ttft_p95_ms": traffic.percentile(ttft, 95),
                "tpot_p95_ms": traffic.percentile(out["tpot"], 95),
                "output_tokens_per_s": out["served"] / h.seconds},
        "attempted": len(ttft),
        "failed": sum(math.isinf(x) for x in ttft),
        "numbers": {"logit_gap": gap},
        "memory_peak_bytes": out["peak"],
        "layer": {"stats": out["stats"], "window_s": h.seconds},
    }


def sample(seed: int, done: list, count: int) -> list:
    """``count`` finished requests drawn by the seed, the longest (prompt
    and output) always among them."""
    longest = max(range(len(done)), key=lambda i: len(done[i][0].prompt) + len(done[i][1]))
    rest = [i for i in range(len(done)) if i != longest]
    pick = np.random.default_rng(seed).permutation(rest)[:max(0, count - 1)]
    return [done[longest]] + [done[i] for i in pick]


def _sequences(picked):
    for a, toks in picked:
        seq = np.concatenate([a.prompt, toks[:-1]])
        yield torch.as_tensor(seq)[None], torch.as_tensor(toks), len(a.prompt)


def reference_gap(h, cfg: dict, picked: list, dtype, quant=None) -> float:
    """The widest gap of a served token below the reference's best, over
    the ``picked`` (arrival, served tokens) pairs, from the served weights
    (drawn again, in ``dtype``) upcast to float32.  With ``quant`` the
    reference runs in the control's precision and the gap is that of the
    token it puts first."""
    ref.exact_float32()
    params = weights.draw(cfg, h.seed, h.device, dtype)
    worst = 0.0
    with torch.no_grad():
        for seq, toks, plen in _sequences(picked):
            seq, toks = seq.to(h.device), toks.to(h.device)
            exact = ref.forward(params, seq, cfg)[0, plen - 1:]
            if quant is not None:
                toks = ref.forward(params, seq, cfg, quant)[0, plen - 1:].argmax(-1)
            worst = max(worst, compare.logit_gap(exact, toks))
    return worst
