"""The one place where the harness meets the program (``repro_torch``): the
program's model config from a configuration file, and the harness's weights
rearranged into the program's parameter tree.

Nothing here computes a result; the traffic kinds call the program's entry
points (``train.make_train_step``, ``serve.ServeEngine``) themselves.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from portbench.weights import layer_kinds, unit_of, units

_ATTN = ("wq", "wk", "wv", "wo")
_MAMBA_F32 = ("A_log", "D", "dt_bias")  # the program keeps these in float32


def model_config(cfg: dict, precision: dict):
    """The program's ``ModelConfig`` for a configuration file and a cell's
    precision (``dtype``, ``param_dtype``, ``remat``)."""
    from repro_torch.core.feature_map import TaylorConfig
    from repro_torch.models.config import ModelConfig, SSMConfig

    head_dim = cfg["head_dim"] if cfg["head_dim"] != cfg["d_model"] // cfg["n_heads"] else 0
    return ModelConfig(
        name=cfg["name"], family=cfg["family"], d_model=cfg["d_model"],
        n_heads=cfg["n_heads"], n_kv_heads=cfg["n_kv_heads"], d_ff=cfg["d_ff"],
        vocab=cfg["vocab"], pattern=tuple(cfg["pattern"]), n_groups=cfg["n_groups"],
        tail=tuple(cfg["tail"]), head_dim=head_dim, act=cfg["act"], norm=cfg["norm"],
        norm_eps=cfg["norm_eps"], pos=cfg["pos"], rope_theta=cfg.get("rope_theta", 10000.0),
        max_seq=cfg["context"],
        tie_embeddings=cfg["tie_embeddings"], attention=cfg["attention"],
        taylor=TaylorConfig(order=cfg["taylor"]["order"], alpha=cfg["taylor"]["alpha"]),
        attn_chunk=cfg["attn_chunk"],
        ssm=SSMConfig(**cfg["ssm"]) if cfg["ssm"] else None,
        dtype=precision["dtype"], param_dtype=precision["param_dtype"],
        remat=precision.get("remat", "none"),
    )


def _block_paths(kind: str, names: List[str]) -> Dict[str, Tuple[str, ...]]:
    """leaf name -> path inside the program's block dict."""
    out = {}
    for name in names:
        if name in ("norm1", "norm2"):
            out[name] = (name, "scale")
        elif name in ("norm1_bias", "norm2_bias"):
            out[name] = (name[:-len("_bias")], "bias")
        elif kind == "mamba":
            out[name] = (("mamba", name, "w") if name in ("in_proj", "out_proj")
                         else ("mamba", name, "scale") if name == "gate_norm"
                         else ("mamba", name))
        elif name in _ATTN:
            out[name] = ("attn", name, "w")
        else:
            out[name] = ("mlp", name)
    return out


def leaf_paths(cfg: dict, harness: dict) -> List[Tuple[Tuple[str, str], Tuple]]:
    """((unit, leaf), path in the program's tree) of every leaf."""
    kinds = layer_kinds(cfg)
    out = []
    for unit in units(cfg):
        if unit == "pos_embed":
            out.append(((unit, "w"), (unit,)))
        elif unit in ("embed", "unembed", "final_norm"):
            out += [((unit, name), (unit, name)) for name in harness[unit]]
        elif unit == "shared":
            for name, path in _block_paths("shared_attn", list(harness["shared"])).items():
                out.append(((unit, name), ("shared",) + path))
        else:
            i = int(unit[len("layer"):])
            for name, path in _block_paths(kinds[i], list(harness["layers"][i])).items():
                out.append(((unit, name), ("blocks", i) + path))
    return out


def get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def to_program(cfg: dict, harness: dict, dtype=None) -> dict:
    """The program's parameter tree over the harness's tensors (no copy,
    except a cast to ``dtype`` where given; the mamba constants stay
    float32 as the program keeps them)."""
    import torch

    tree: dict = {"blocks": [None] * len(layer_kinds(cfg))}
    for (unit, name), path in leaf_paths(cfg, harness):
        src = unit_of(harness, unit)[name]
        if dtype is not None:
            src = src.to(torch.float32 if name in _MAMBA_F32 else dtype)
        node = tree
        for key in path[:-1]:
            if isinstance(node, list):
                if node[key] is None:
                    node[key] = {}
                node = node[key]
            else:
                node = node.setdefault(key, {})
        node[path[-1]] = src
    return tree
