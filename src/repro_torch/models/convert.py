"""Weight bridge between the JAX package's ``lm_init`` params and the port's.

The JAX tree stacks every block leaf over the depth scan:
``blocks/group/r{j}/... [n_groups, run_len, ...]`` (one run per stretch of
equal block kind and attention backend: ``schedule_runs``) and
``blocks/tail/t{i}/...``.  A ``shared_attn`` block's weights live once, in
``blocks/shared``: its runs have no ``r{j}`` (the other runs keep their
run index ``j``) and its tail positions no ``t{i}``.  The port keeps one
dict per layer, in layer order (``None`` at the shared block's
occurrences), and the shared block under ``"shared"``.  An encdec model's
encoder is stacked the same way in the JAX tree (``encoder/group/r{j}``
over ``[n_encoder_groups, run_len]``, one run per stretch of equal kind)
and is a layer list in the port (``encoder/blocks``); ``vision_proj``,
``pos_embed`` and the encoder's ``final_norm``/``pos_embed`` carry over as
they are.  The caller converts the JAX arrays with
``np.asarray`` (this module imports no JAX)::

    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    params = params_from_jax(tree, cfg, device="cpu")

and ``params_to_numpy`` goes back (numpy arrays in the JAX tree layout).
``to_jax_layout`` is that restacking for any leaf type: the optimizers and
the JAX checkpoint loader take the stacking from it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, schedule_runs
from repro_torch.tree import tree_map


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Convert a numpy copy of the JAX ``lm_init`` tree to the port's params.

    Args:
      tree: nested dict of numpy arrays (or tensors) with the JAX
        ``lm_init`` structure; any tree of that structure, e.g. AdamW's
        moments.
      cfg: the port's model config (same geometry as the JAX config).
      device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".

    Returns:
      The port's param dict (``repro_torch.models.lm`` layout).
    """
    device = resolve_device(device)

    def to_t(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, copy=True)
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    blocks = _unstack(tree["blocks"]["group"], _decoder_runs(cfg), cfg.n_groups, to_t)
    for i, kind in enumerate(cfg.tail):
        blocks.append(None if kind == "shared_attn"
                      else tree_map(to_t, tree["blocks"]["tail"][f"t{i}"]))
    params = {
        "embed": tree_map(to_t, tree["embed"]),
        "final_norm": tree_map(to_t, tree["final_norm"]),
        "blocks": blocks,
    }
    if "shared" in tree["blocks"]:
        params["shared"] = tree_map(to_t, tree["blocks"]["shared"])
    for key in ("unembed", "pos_embed", "vision_proj"):
        if key in tree:
            params[key] = tree_map(to_t, tree[key])
    if "encoder" in tree:
        enc = tree["encoder"]
        params["encoder"] = {k: tree_map(to_t, v) for k, v in enc.items() if k != "group"}
        params["encoder"]["blocks"] = _unstack(enc["group"], _encoder_runs(cfg),
                                               cfg.n_encoder_groups, to_t)
    return params


def params_to_numpy(params: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """Inverse of ``params_from_jax``: the port's params as numpy arrays in
    the JAX ``lm_init`` tree layout (block leaves stacked over
    ``[n_groups, run_len, ...]``)."""
    to_np = lambda t: t.detach().cpu().numpy()
    stack = lambda rows: np.stack([np.stack(row) for row in rows])
    return to_jax_layout(tree_map(to_np, params), cfg, stack)


def to_jax_layout(tree: Dict[str, Any], cfg: ModelConfig,
                  stack: Callable[[List[List[Any]]], Any]) -> Dict[str, Any]:
    """A tree in the port's param layout -> the JAX ``lm_init`` layout.

    Leaves outside the blocks carry over as they are; ``stack(rows)`` makes
    one stacked leaf of a run's leaves at one path, ``rows[group][r]`` for
    ``n_groups`` groups of ``run_len`` layers (``np.stack`` for numpy,
    ``np.array`` of indices for the optimizers' stacking)."""
    blocks = tree["blocks"]
    n_group = cfg.n_groups * len(cfg.pattern)
    out = {
        "embed": tree["embed"],
        "final_norm": tree["final_norm"],
        "blocks": {"group": _restack(blocks, _decoder_runs(cfg), cfg.n_groups, stack)},
    }
    if cfg.tail:  # as in the JAX tree, which has no "tail" entry without one
        out["blocks"]["tail"] = {f"t{i}": blocks[n_group + i]
                                 for i, kind in enumerate(cfg.tail) if kind != "shared_attn"}
    if "shared" in tree:
        out["blocks"]["shared"] = tree["shared"]
    for key in ("unembed", "pos_embed", "vision_proj"):
        if key in tree:
            out[key] = tree[key]
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {k: v for k, v in enc.items() if k != "blocks"}
        out["encoder"]["group"] = _restack(enc["blocks"], _encoder_runs(cfg),
                                           cfg.n_encoder_groups, stack)
    return out


def _decoder_runs(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """``(kind, run_len)`` of the decoder pattern's runs (``schedule_runs``)."""
    return [(kind, rl) for kind, _, rl in schedule_runs(cfg)]


def _encoder_runs(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """``(kind, run_len)`` of the encoder pattern's runs of equal kind."""
    out: List[Tuple[str, int]] = []
    for kind in cfg.encoder_pattern:
        if out and out[-1][0] == kind:
            out[-1] = (kind, out[-1][1] + 1)
        else:
            out.append((kind, 1))
    return out


def _unstack(group, runs, n_groups: int, to_t) -> List[Any]:
    """A JAX stacked ``group`` tree (``r{j}`` leaves ``[n_groups, run_len,
    ...]``) -> one dict per layer, in layer order (``None`` at shared
    blocks)."""
    return [None if kind == "shared_attn" else tree_map(lambda x: to_t(x[gi, r]), group[f"r{j}"])
            for gi in range(n_groups)
            for j, (kind, run_len) in enumerate(runs)
            for r in range(run_len)]


def _restack(blocks: List[Any], runs, n_groups: int, stack) -> Dict[str, Any]:
    """Inverse of ``_unstack``: the layers' dicts -> ``{"r{j}": stacked}``."""
    per_group = sum(rl for _, rl in runs)
    group, offset = {}, 0
    for j, (kind, run_len) in enumerate(runs):
        if kind != "shared_attn":
            group[f"r{j}"] = _stack([[blocks[gi * per_group + offset + r] for r in range(run_len)]
                                     for gi in range(n_groups)], stack)
        offset += run_len
    return group


def _stack(rows, stack):
    """[[layer dict] * run_len] * n_groups -> one dict of ``stack(rows)`` leaves."""
    first = rows[0][0]
    if isinstance(first, dict):
        return {k: _stack([[layer[k] for layer in row] for row in rows], stack) for k in first}
    return stack(rows)
