"""Model weights drawn from the run's seed, in the plain reference's layout.

The harness makes the weights and hands the same tensors to both sides: the
program gets them rearranged into its own tree (``program.py``), the
reference reads them as they are.  Each unit (the embedding, the head, the
final norm, the learned positions, each layer, the shared block) is drawn
on the card by a
``torch.Generator`` seeded from the run's seed and the unit's name, in one
call for all its matrices, so a single unit can be drawn again later (the
training check compares the parameters' change against the drawn start).

Layout::

    {"embed": {"w": [V, d]}, "unembed": {"w": [V, d]},
     "final_norm": {"scale": [d](, "bias": [d])},
     ("pos_embed": {"w": [context, d]},)
     "layers": [block or None (a shared_attn place)], "shared": block}

``pos_embed`` is there under ``pos = "learned"``, and every norm has a
``bias`` (in a block: ``norm1_bias``, ``norm2_bias``) under ``norm =
"layernorm"``.  An attention block is ``norm1 [d], wq [d, h, hd], wk/wv
[d, hk, hd], wo [h, hd, d], norm2 [d]`` and its MLP (``gelu``: ``w_up [d, f], b_up [f],
w_down [f, d], b_down [d]``; ``silu``: ``w_gate, w_up [d, f], w_down
[f, d]``).  A mamba block is ``norm1 [d], in_proj [d, 2·di + 2·G·N + H],
conv_w [W, di + 2·G·N], conv_b, A_log [H], D [H], dt_bias [H], out_proj
[di, d], gate_norm [di]``.  Matrices are N(0, 1/fan_in), the embedding and
the head N(0, 1/d), the learned positions N(0, 0.01²), the conv taps
N(0, 0.1²); norm scales are ones, biases
zeros; ``A_log = log(linspace(1, 16, H))``, ``dt_bias = log(expm1(0.01))``.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, List, Tuple

import torch

Tensor = torch.Tensor


def layer_kinds(cfg: dict) -> List[str]:
    """Block kinds in layer order: the pattern ``n_groups`` times, then the tail."""
    return list(cfg["pattern"]) * cfg["n_groups"] + list(cfg["tail"])


def ssm_sizes(cfg: dict) -> Tuple[int, int, int, int, int]:
    """(d_inner, SSD heads H, head dim P, B/C groups G, state N)."""
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    return di, di // s["head_dim"], s["head_dim"], s["n_groups"], s["d_state"]


def _norm(cfg: dict, name: str, bias: str) -> List[Tuple[str, tuple, tuple]]:
    """A norm's leaves: its scale ``name``, and under LayerNorm its bias."""
    d = cfg["d_model"]
    out = [(name, (d,), ("ones",))]
    if cfg["norm"] == "layernorm":
        out.append((bias, (d,), ("zeros",)))
    return out


def _block_leaves(cfg: dict, kind: str) -> List[Tuple[str, tuple, tuple]]:
    """(name, shape, init) of one block's leaves; init is ("normal", std),
    ("ones",), ("zeros",) or a named constant."""
    d = cfg["d_model"]
    if kind == "mamba":
        di, nh, _, g, n = ssm_sizes(cfg)
        conv = di + 2 * g * n
        return _norm(cfg, "norm1", "norm1_bias") + [
            ("in_proj", (d, 2 * di + 2 * g * n + nh), ("normal", d**-0.5)),
            ("conv_w", (cfg["ssm"]["conv_width"], conv), ("normal", 0.1)),
            ("conv_b", (conv,), ("zeros",)),
            ("A_log", (nh,), ("a_log",)),
            ("D", (nh,), ("ones",)),
            ("dt_bias", (nh,), ("dt_bias",)),
            ("out_proj", (di, d), ("normal", di**-0.5)),
            ("gate_norm", (di,), ("ones",)),
        ]
    h, hk, hd, f = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"], cfg["d_ff"]
    leaves = _norm(cfg, "norm1", "norm1_bias") + [
        ("wq", (d, h, hd), ("normal", d**-0.5)),
        ("wk", (d, hk, hd), ("normal", d**-0.5)),
        ("wv", (d, hk, hd), ("normal", d**-0.5)),
        ("wo", (h, hd, d), ("normal", (h * hd) ** -0.5)),
    ] + _norm(cfg, "norm2", "norm2_bias")
    if cfg["act"] == "gelu":
        return leaves + [
            ("w_up", (d, f), ("normal", d**-0.5)),
            ("b_up", (f,), ("zeros",)),
            ("w_down", (f, d), ("normal", f**-0.5)),
            ("b_down", (d,), ("zeros",)),
        ]
    return leaves + [
        ("w_gate", (d, f), ("normal", d**-0.5)),
        ("w_up", (d, f), ("normal", d**-0.5)),
        ("w_down", (f, d), ("normal", f**-0.5)),
    ]


def units(cfg: dict) -> List[str]:
    """The names of the units drawn one by one: ``embed``, ``unembed``,
    ``final_norm``, ``pos_embed`` under learned positions, ``layer<i>`` for
    every block that is not a shared place, ``shared`` where the pattern
    has one."""
    kinds = layer_kinds(cfg)
    out = ["embed", "unembed", "final_norm"] + (["pos_embed"] if cfg["pos"] == "learned" else [])
    out += [f"layer{i}" for i, k in enumerate(kinds) if k != "shared_attn"]
    if "shared_attn" in kinds:
        out.append("shared")
    return out


def _unit_leaves(cfg: dict, unit: str):
    d, v = cfg["d_model"], cfg["vocab"]
    if unit in ("embed", "unembed"):
        return [("w", (v, d), ("normal", d**-0.5))]
    if unit == "final_norm":
        return _norm(cfg, "scale", "bias")
    if unit == "pos_embed":
        return [("w", (cfg["context"], d), ("normal", 0.01))]
    if unit == "shared":
        return _block_leaves(cfg, "shared_attn")
    return _block_leaves(cfg, layer_kinds(cfg)[int(unit[len("layer"):])])


def _unit_seed(seed: int, unit: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{unit}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def draw_unit(cfg: dict, seed: int, unit: str, device, dtype=torch.float32) -> Dict[str, Tensor]:
    """One unit's leaves ``{name: tensor}`` in ``dtype``: every normal leaf
    comes out of one ``randn`` call on ``device`` (float32), scaled, then
    cast."""
    leaves = _unit_leaves(cfg, unit)
    normal = [(name, shape, init[1]) for name, shape, init in leaves if init[0] == "normal"]
    total = sum(math.prod(shape) for _, shape, _ in normal)
    gen = torch.Generator(device=device).manual_seed(_unit_seed(seed, unit))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in normal:
        size = math.prod(shape)
        out[name] = (flat[off:off + size].view(shape) * std).to(dtype)
        off += size
    del flat
    for name, shape, init in leaves:
        if init[0] == "normal":
            continue
        if init[0] == "ones":
            x = torch.ones(shape, device=device)
        elif init[0] == "zeros":
            x = torch.zeros(shape, device=device)
        elif init[0] == "a_log":
            x = torch.log(torch.linspace(1.0, 16.0, shape[0], device=device))
        else:  # dt_bias
            x = torch.full(shape, math.log(math.expm1(0.01)), device=device)
        out[name] = x.to(dtype)
    return {name: out[name] for name, _, _ in leaves}


def draw(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Every unit, assembled into the layout of the module docstring."""
    params = {unit: draw_unit(cfg, seed, unit, device, dtype)
              for unit in units(cfg) if not unit.startswith("layer")}
    kinds = layer_kinds(cfg)
    params["layers"] = [None] * len(kinds)
    for i, kind in enumerate(kinds):
        if kind != "shared_attn":
            params["layers"][i] = draw_unit(cfg, seed, f"layer{i}", device, dtype)
    return params


def unit_of(params: dict, unit: str) -> Dict[str, Tensor]:
    """A unit's leaves ``{name: tensor}`` out of a full layout."""
    if unit.startswith("layer"):
        return params["layers"][int(unit[len("layer"):])]
    return params[unit]


def leaf_names(cfg: dict) -> List[Tuple[str, str]]:
    """(unit, leaf) of every parameter leaf, in ``units`` order."""
    return [(u, name) for u in units(cfg) for name, _, _ in _unit_leaves(cfg, u)]


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for u in units(cfg) for _, shape, _ in _unit_leaves(cfg, u))
