"""Zamba2's weights (``weights_zamba2.py``) rearranged into the program's
parameter tree, and where each leaf lies in it.  The kind builds the
program's model config (``kinds/train_zamba2.py``); this module only moves
tensors and imports nothing of the program.

The program's tree::

    {"embed": {"w"}, "final_norm": {"scale"},
     "blocks": [{"norm1": {"scale"}, "mamba": {"in_proj": {"w"}, "conv_w",
                 "conv_b", "A_log", "D", "dt_bias", "out_proj": {"w"},
                 "gate_norm": {"scale"}}}],
     "shared_blocks": [{"norm1": {"scale"}, "attn": {"wq": {"w"}, ...},
                        "norm2": {"scale"}, "mlp": {"w_gate", "w_up", "w_down"}}],
     "sites": [{"adapter": {"a", "b"}, "linear": {"w"}}]}
"""

from __future__ import annotations

from typing import List, Tuple

from portbench import weights_zamba2 as zw

_MAMBA_F32 = ("A_log", "D", "dt_bias")  # the program keeps these in float32


def _path(unit: str, name: str) -> Tuple:
    if unit in ("embed", "final_norm"):
        return (unit, name)
    if unit.startswith("layer"):
        i = int(unit[len("layer"):])
        if name == "norm1":
            return ("blocks", i, "norm1", "scale")
        if name in ("in_proj", "out_proj"):
            return ("blocks", i, "mamba", name, "w")
        if name == "gate_norm":
            return ("blocks", i, "mamba", name, "scale")
        return ("blocks", i, "mamba", name)
    if unit.startswith("shared"):
        k = int(unit[len("shared"):])
        if name in ("norm1", "norm2"):
            return ("shared_blocks", k, name, "scale")
        if name in ("wq", "wk", "wv", "wo"):
            return ("shared_blocks", k, "attn", name, "w")
        return ("shared_blocks", k, "mlp", name)
    j = int(unit[len("site"):])
    if name == "linear":
        return ("sites", j, "linear", "w")
    return ("sites", j, "adapter", name[len("adapter_"):])


def leaf_paths(cfg: dict) -> List[Tuple[Tuple[str, str], Tuple]]:
    """((unit, leaf), path in the program's tree) of every leaf."""
    return [(key, _path(*key)) for key in zw.leaf_names(cfg)]


def to_program(cfg: dict, harness: dict, dtype=None) -> dict:
    """The program's tree over the harness's tensors (no copy, except a cast
    to ``dtype`` where given; the mamba constants stay float32)."""
    import torch

    tree: dict = {"blocks": [], "shared_blocks": [], "sites": []}
    for (unit, name), path in leaf_paths(cfg):
        src = zw.unit_of(harness, unit)[name]
        if dtype is not None:
            src = src.to(torch.float32 if name in _MAMBA_F32 else dtype)
        node = tree
        for key, nxt in zip(path[:-1], path[1:]):
            if isinstance(node, list):
                while len(node) <= key:
                    node.append({})
                node = node[key]
            else:
                node = node.setdefault(key, [] if isinstance(nxt, int) else {})
        node[path[-1]] = src
    return tree
