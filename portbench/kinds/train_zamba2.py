"""Traffic kind ``train_zamba2``: the ``train`` kind's optimizer steps on
Zamba2's layout (``weights_zamba2.py``, ``program_zamba2.py``,
``reference/zamba2.py``).

Set-up draws the weights (float32 master copy) on the card, builds the
program's AdamW and ``train.make_train_step`` over them and drives that
state through the first ``CHECKED`` steps of the window's own call, as the
``train`` kind does.  The step is donated (``make_train_step(...,
donate=True)``): it writes the new params and moments into the old ones, as
a deployment holds a state that fills most of the card once.  The window
and the check are the ``train`` kind's, less the loss gap (``numbers``).
"""

from __future__ import annotations

import math
import time
from typing import Dict

import torch

from portbench import program_zamba2 as layout
from portbench import weights_zamba2 as zw
from portbench.kinds import train
from portbench.kinds.train import CHECKED, _batches, _sync, free
from portbench.program import get
from portbench.reference import model as ref_model
from portbench.reference import zamba2 as ref
from portbench.reference.adamw import AdamW


def model_config(cfg: dict, precision: dict):
    """The program's ``ModelConfig`` for a configuration file of the
    release's keys and a cell's precision."""
    from repro_torch.core.feature_map import TaylorConfig
    from repro_torch.models.config import ModelConfig, SiteConfig, SSMConfig

    if cfg["attention"] != "taylor":
        raise ValueError(f"attention {cfg['attention']!r}: the cell runs the Taylor form")
    return ModelConfig(
        name=cfg["name"], family="lm", d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        head_dim=cfg["attention_head_dim"], d_ff=cfg["intermediate_size"],
        vocab=cfg["vocab_size"], pattern=("mamba",), n_groups=cfg["num_hidden_layers"],
        act="geglu_erf" if cfg["hidden_act"] == "gelu" else cfg["hidden_act"],
        norm="rmsnorm", norm_eps=cfg["rms_norm_eps"], tie_embeddings=True, pos="rope",
        rope_theta=float(cfg["rope_theta"]), max_seq=cfg["max_position_embeddings"],
        attention="taylor",
        taylor=TaylorConfig(order=cfg["taylor"]["order"], alpha=cfg["taylor"]["alpha"]),
        attn_chunk=cfg["chunk_size"],
        ssm=SSMConfig(d_state=cfg["mamba_d_state"], expand=cfg["mamba_expand"],
                      head_dim=cfg["mamba_headdim"], conv_width=cfg["mamba_d_conv"],
                      n_groups=cfg["mamba_ngroups"]),
        sites=SiteConfig(layer_ids=tuple(cfg["hybrid_layer_ids"]),
                         n_blocks=cfg["num_mem_blocks"], adapter_rank=cfg["adapter_rank"]),
        dtype=precision["dtype"], param_dtype=precision["param_dtype"],
        remat=precision.get("remat", "none"),
    )


def numbers(got, want) -> dict:
    """The ``train`` kind's compared numbers without ``loss_gap``: at this
    cell's widths the program's loss gap (bf16 over 27 layers) reads as high
    as the fp8 control's, so no limit tells them apart; the leaf gaps do."""
    out = train.numbers(got, want)
    del out["loss_gap"]
    return out


def _change_norms(cfg: dict, seed: int, device, current) -> Dict[tuple, float]:
    """‖p − p0‖ per leaf, ``current((unit, leaf))`` giving p, with p0 drawn
    again unit by unit."""
    out = {}
    for unit in zw.units(cfg):
        for name, start in zw.draw_unit(cfg, seed, unit, device).items():
            out[(unit, name)] = float(torch.linalg.vector_norm(
                current((unit, name)).detach().float() - start))
    return out


def prepare(h):
    """The program's training state over the drawn weights, driven through
    the checked steps: (state, step, batch, readings), the readings being
    (losses, first gradient's norm per leaf, change's norm per leaf)."""
    from repro_torch import optim as popt
    from repro_torch import train as ptrain

    cfg, cell, dev = h.config, h.cell, h.device
    o = cell["optimizer"]
    mc = model_config(cfg, cell["precision"])
    paths = layout.leaf_paths(cfg)
    tree = layout.to_program(cfg, zw.draw(cfg, h.seed, dev))
    opt = popt.adamw(popt.constant(o["lr"]), b1=o["b1"], b2=o["b2"], eps=o["eps"],
                     weight_decay=o["weight_decay"], clip_norm=o["clip_norm"],
                     state_dtype=torch.float32)
    state = ptrain.TrainState(step=torch.zeros((), dtype=torch.int32, device=dev),
                              params=tree, opt_state=opt.init(tree))
    del tree
    step = ptrain.make_train_step(mc, opt, donate=True)
    batch = _batches(h, cell["traffic"], cfg["vocab_size"])
    losses, first = [], {}
    for i in range(CHECKED):
        state, m = step(state, batch(i))
        losses.append(float(m["loss"]))
        if i == 0:
            first = {k: float(torch.linalg.vector_norm(get(state.opt_state.m, p)))
                     / (1.0 - o["b1"]) for k, p in paths}
    path_of = dict(paths)
    delta = _change_norms(cfg, h.seed, dev, lambda k: get(state.params, path_of[k]))
    _sync(dev)
    return state, step, batch, (losses, first, delta)


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
    ref_model.exact_float32()
    params = zw.draw(cfg, h.seed, h.device)
    keys = zw.leaf_names(cfg)
    leaves = [zw.unit_of(params, u)[name] for u, name in keys]
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
