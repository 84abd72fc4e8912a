"""Traffic kind ``train``: optimizer steps of the program's training step,
one after another, each on its own rows.

Set-up draws the weights (float32 master copy) on the card, builds the
program's AdamW and ``train.make_train_step`` over them, and drives that
same state through the cell's first ``CHECKED`` steps, each through the
window's own call on its own rows; the readings the check needs are taken
from the program's state as they pass (each step's loss, the first
gradient from AdamW's first moment after step 1, each leaf's change after
the last).  The window then runs steps back to back on that state, each
ended by a device synchronise, until ``seconds`` have passed; every step it
finished counts.  After the window the state is freed and the plain
reference follows the same rows from the same weights for the checked
steps; the numbers of ``compare.py`` decide ``correct``.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict

import torch

from portbench import compare, program, traffic, weights
from portbench.reference import model as ref
from portbench.reference.adamw import AdamW

CHECKED = 3   # steps the reference follows
ROWS = 256    # distinct batches drawn for the set-up and the window


def _batches(h, tr: dict, vocab: int):
    b, n = tr["batch"], tr["seq"]
    rows = traffic.train_rows(h.seed, ROWS * b, n, vocab, h.device)

    def batch(i: int) -> Dict[str, torch.Tensor]:
        r = rows[(i % ROWS) * b:(i % ROWS + 1) * b]
        return {"tokens": r[:, :-1], "labels": r[:, 1:]}

    return batch


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _change_norms(cfg: dict, seed: int, device, current) -> Dict[tuple, float]:
    """‖p − p0‖ per leaf, ``current((unit, leaf))`` giving p, with p0 drawn
    again unit by unit."""
    out = {}
    for unit in weights.units(cfg):
        for name, start in weights.draw_unit(cfg, seed, unit, device).items():
            out[(unit, name)] = float(torch.linalg.vector_norm(
                current((unit, name)).detach().float() - start))
    return out


def prepare(h):
    """The program's training state over the drawn weights, driven through
    the checked steps: (state, step, batch, readings), the readings being
    (losses, first gradient's norm per leaf, change's norm per leaf)."""
    from repro_torch import optim as popt
    from repro_torch import train as ptrain

    cfg, cell = h.config, h.cell
    o = cell["optimizer"]
    dev = h.device
    mc = program.model_config(cfg, cell["precision"])
    harness = weights.draw(cfg, h.seed, dev)
    paths = program.leaf_paths(cfg, harness)
    tree = program.to_program(cfg, harness)
    del harness
    opt = popt.adamw(popt.constant(o["lr"]), b1=o["b1"], b2=o["b2"], eps=o["eps"],
                     weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
                     state_dtype=torch.float32)
    state = ptrain.TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                              params=tree, opt_state=opt.init(tree))
    del tree
    step = ptrain.make_train_step(mc, opt)
    batch = _batches(h, cell["traffic"], cfg["vocab"])
    losses, first = [], {}
    for i in range(CHECKED):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(program.get(state.opt_state.m, p)))
                     / (1.0 - o["b1"]) for k, p in paths}
    path_of = dict(paths)
    delta = _change_norms(cfg, h.seed, dev, lambda k: program.get(state.params, path_of[k]))
    _sync(dev)
    return state, step, batch, (losses, first, delta)


def numbers(got, want) -> dict:
    """The compared numbers of readings ``got`` against the reference's."""
    moved = compare.moved_leaves(want[1])
    return {
        "loss_gap": compare.loss_gap(got[0], want[0]),
        "grad_gap": compare.worst_leaf_gap(got[1], want[1]),
        "delta_gap": compare.worst_leaf_gap(got[2], want[2], moved),
    }


def free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def run(h) -> dict:
    dev, tr = h.device, h.cell["traffic"]
    state, step, batch, readings = prepare(h)
    setup_s = time.perf_counter() - h.t0
    tokens_per_step = tr["batch"] * tr["seq"]
    steps, bad = 0, 0
    with h.tracer.window():
        t_start = time.perf_counter()
        while True:
            with h.tracer.span("train_step"):
                state, m = step(state, batch(CHECKED + steps))
                _sync(dev)
            steps += 1
            bad += not math.isfinite(float(m["loss"]))
            if time.perf_counter() - t_start >= h.seconds:
                break
        window_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, m, step
    free(dev)
    with h.tracer.span("reference"):
        want = reference(h, h.config, h.cell, batch)
    return {
        "setup_s": setup_s,
        "e2e": {"train_tokens_per_s": steps * tokens_per_step / window_s},
        "attempted": steps,
        "failed": bad,
        "numbers": numbers(readings, want),
        "memory_peak_bytes": peak,
        "layer": {"steps": steps, "window_s": window_s, "tokens_per_step": tokens_per_step,
                  "batch": tr["batch"], "seq": tr["seq"]},
    }


def reference(h, cfg: dict, cell: dict, batch, quant=None, half=False):
    """The plain reference over the checked steps from the same weights and
    rows: (losses, first clipped gradient's norm per leaf, change's norm per
    leaf).  ``quant`` runs it in the control's precision; ``half`` plants a
    fault, the loss taken over the first half of each batch's positions."""
    o = cell["optimizer"]
    ref.exact_float32()
    params = weights.draw(cfg, h.seed, h.device)
    keys = weights.leaf_names(cfg)
    leaves = [weights.unit_of(params, u)[name] for u, name in keys]
    for p in leaves:
        p.requires_grad_(True)
    adam = AdamW(leaves, o["lr"], o["b1"], o["b2"], o["eps"], o["weight_decay"], o["clip_norm"])
    losses, first = [], {}
    for i in range(CHECKED):
        b = batch(i)
        n = b["tokens"].shape[1] // 2 if half else None
        loss = ref.loss(params, b["tokens"], b["labels"], cfg, quant, keep=n)
        grads = adam.clip_grads(torch.autograd.grad(loss, leaves))
        losses.append(float(loss.detach()))
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(keys, grads)}
        adam.step(grads)
        del loss, grads
    current = dict(zip(keys, leaves))
    delta = _change_norms(cfg, h.seed, h.device, current.get)
    del params, leaves, current, adam
    free(h.device)
    return losses, first, delta
