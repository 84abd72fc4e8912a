"""Weight bridge: the JAX package's ``lm_init`` params -> the port's params.

The JAX tree stacks every block leaf over the depth scan:
``blocks/group/r{j}/... [n_groups, run_len, ...]`` (one run per stretch of
equal block kinds) and ``blocks/tail/t{i}/...``.  The port keeps one dict
per layer, in layer order.  The caller converts the JAX arrays with
``np.asarray`` (this module imports no JAX)::

    tree = jax.tree_util.tree_map(np.asarray, jax_params)
    params = params_from_jax(tree, cfg, device="cpu")
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _runs(kinds):
    """Runs of equal consecutive kinds: [('attn', 2), ...] (the JAX scan runs)."""
    out = []
    for kind in kinds:
        if out and out[-1][0] == kind:
            out[-1] = (kind, out[-1][1] + 1)
        else:
            out.append((kind, 1))
    return out


def params_from_jax(tree: Dict[str, Any], cfg: ModelConfig, device=None) -> Dict[str, Any]:
    """Convert a numpy copy of the JAX ``lm_init`` tree to the port's params.

    Args:
      tree: nested dict of numpy arrays with the JAX ``lm_init`` structure.
      cfg: the port's model config (same geometry as the JAX config).
      device: ``None`` (the CUDA card; raises without one) or e.g. "cpu".

    Returns:
      The port's param dict (``repro_torch.models.lm`` layout).
    """
    device = resolve_device(device)
    to_t = lambda x: torch.from_numpy(np.array(x, copy=True)).to(device)
    group = tree["blocks"]["group"]
    blocks = []
    for gi in range(cfg.n_groups):
        for j, (_, run_len) in enumerate(_runs(cfg.pattern)):
            for r in range(run_len):
                blocks.append(_map(group[f"r{j}"], lambda x: to_t(x[gi, r])))
    for i in range(len(cfg.tail)):
        blocks.append(_map(tree["blocks"]["tail"][f"t{i}"], to_t))
    params = {
        "embed": _map(tree["embed"], to_t),
        "final_norm": _map(tree["final_norm"], to_t),
        "blocks": blocks,
    }
    if "unembed" in tree:
        params["unembed"] = _map(tree["unembed"], to_t)
    return params
