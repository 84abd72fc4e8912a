"""Zamba2's weights drawn from the run's seed, in the layout of its plain
reference (``reference/zamba2.py``), unit by unit as ``weights.py`` draws
the other configurations': each unit comes out of one ``randn`` call of a
generator seeded from the run's seed and the unit's name, so that a unit
can be drawn again on its own.

The configuration file keeps the release's ``config.json`` keys.  Layout::

    {"embed": {"w": [V, d]}, "final_norm": {"scale": [d]},
     "layers": [mamba block] * num_hidden_layers,
     "shared": [shared block] * num_mem_blocks,
     "sites": [site] * len(hybrid_layer_ids)}

A mamba block is ``weights.py``'s (``norm1 [d], in_proj [d, 2·di + 2·G·N +
H], conv_w [W, di + 2·G·N], conv_b, A_log [H], D [H], dt_bias [H],
out_proj [di, d], gate_norm [di]``).  A shared block is ``norm1 [2d], wq,
wk, wv [2d, h, hd], wo [h, hd, d], norm2 [d], w_gate, w_up [d, f], w_down
[f, d]``; a site is ``adapter_a [d, r], adapter_b [r, 2f], linear [d, d]``.
Matrices are N(0, 1/fan_in), the embedding N(0, 1/d), the conv taps
N(0, 0.1²); norm scales are ones, the conv bias zeros, ``A_log =
log(linspace(1, 16, H))``, ``dt_bias = log(expm1(0.01))`` (as
``weights.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.weights import _unit_seed

Tensor = torch.Tensor


def sizes(cfg: dict) -> dict:
    """The widths the layout reads, by short name."""
    d, di = cfg["hidden_size"], cfg["mamba_expand"] * cfg["hidden_size"]
    return dict(d=d, di=di, H=cfg["n_mamba_heads"], P=cfg["mamba_headdim"],
                G=cfg["mamba_ngroups"], N=cfg["mamba_d_state"], W=cfg["mamba_d_conv"],
                w=cfg["attention_hidden_size"], h=cfg["num_attention_heads"],
                hk=cfg["num_key_value_heads"], hd=cfg["attention_head_dim"],
                f=cfg["intermediate_size"], r=cfg["adapter_rank"], V=cfg["vocab_size"])


def units(cfg: dict) -> List[str]:
    """``embed``, ``final_norm``, ``layer<i>``, ``shared<k>``, ``site<j>``."""
    return (["embed", "final_norm"] + [f"layer{i}" for i in range(cfg["num_hidden_layers"])]
            + [f"shared{k}" for k in range(cfg["num_mem_blocks"])]
            + [f"site{j}" for j in range(len(cfg["hybrid_layer_ids"]))])


def _unit_leaves(cfg: dict, unit: str) -> List[Tuple[str, tuple, tuple]]:
    s = sizes(cfg)
    d, di, H, G, N, w, f = (s[k] for k in ("d", "di", "H", "G", "N", "w", "f"))
    h, hk, hd, r = s["h"], s["hk"], s["hd"], s["r"]
    if unit == "embed":
        return [("w", (s["V"], d), ("normal", d**-0.5))]
    if unit == "final_norm":
        return [("scale", (d,), ("ones",))]
    if unit.startswith("layer"):
        conv = di + 2 * G * N
        return [
            ("norm1", (d,), ("ones",)),
            ("in_proj", (d, 2 * di + 2 * G * N + H), ("normal", d**-0.5)),
            ("conv_w", (s["W"], conv), ("normal", 0.1)),
            ("conv_b", (conv,), ("zeros",)),
            ("A_log", (H,), ("a_log",)),
            ("D", (H,), ("ones",)),
            ("dt_bias", (H,), ("dt_bias",)),
            ("out_proj", (di, d), ("normal", di**-0.5)),
            ("gate_norm", (di,), ("ones",)),
        ]
    if unit.startswith("shared"):
        return [
            ("norm1", (w,), ("ones",)),
            ("wq", (w, h, hd), ("normal", w**-0.5)),
            ("wk", (w, hk, hd), ("normal", w**-0.5)),
            ("wv", (w, hk, hd), ("normal", w**-0.5)),
            ("wo", (h, hd, d), ("normal", (h * hd) ** -0.5)),
            ("norm2", (d,), ("ones",)),
            ("w_gate", (d, f), ("normal", d**-0.5)),
            ("w_up", (d, f), ("normal", d**-0.5)),
            ("w_down", (f, d), ("normal", f**-0.5)),
        ]
    if unit.startswith("site"):
        return [
            ("adapter_a", (d, r), ("normal", d**-0.5)),
            ("adapter_b", (r, 2 * f), ("normal", r**-0.5)),
            ("linear", (d, d), ("normal", d**-0.5)),
        ]
    raise ValueError(f"unknown unit {unit!r}")


def draw_unit(cfg: dict, seed: int, unit: str, device, dtype=torch.float32) -> Dict[str, Tensor]:
    """One unit's leaves ``{name: tensor}`` in ``dtype``: the normal leaves
    out of one ``randn`` call on ``device`` (float32), scaled, then cast."""
    leaves = _unit_leaves(cfg, unit)
    normal = [(name, shape, init[1]) for name, shape, init in leaves if init[0] == "normal"]
    gen = torch.Generator(device=device).manual_seed(_unit_seed(seed, unit))
    flat = torch.randn(sum(math.prod(shape) for _, shape, _ in normal), generator=gen,
                       device=device, dtype=torch.float32)
    out, off = {}, 0
    for name, shape, std in normal:
        size = math.prod(shape)
        out[name] = (flat[off:off + size].view(shape) * std).to(dtype)
        off += size
    del flat
    const = {"ones": lambda n: torch.ones(n, device=device),
             "zeros": lambda n: torch.zeros(n, device=device),
             "a_log": lambda n: torch.log(torch.linspace(1.0, 16.0, n, device=device)),
             "dt_bias": lambda n: torch.full((n,), math.log(math.expm1(0.01)), device=device)}
    for name, shape, init in leaves:
        if init[0] != "normal":
            out[name] = const[init[0]](shape[0]).to(dtype)
    return {name: out[name] for name, _, _ in leaves}


def draw(cfg: dict, seed: int, device, dtype=torch.float32) -> dict:
    """Every unit, assembled into the layout of the module docstring."""
    one = lambda u: draw_unit(cfg, seed, u, device, dtype)
    return {"embed": one("embed"), "final_norm": one("final_norm"),
            "layers": [one(f"layer{i}") for i in range(cfg["num_hidden_layers"])],
            "shared": [one(f"shared{k}") for k in range(cfg["num_mem_blocks"])],
            "sites": [one(f"site{j}") for j in range(len(cfg["hybrid_layer_ids"]))]}


def unit_of(params: dict, unit: str) -> Dict[str, Tensor]:
    """A unit's leaves ``{name: tensor}`` out of a full layout."""
    for prefix, key in (("layer", "layers"), ("shared", "shared"), ("site", "sites")):
        if unit.startswith(prefix):
            return params[key][int(unit[len(prefix):])]
    return params[unit]


def leaf_names(cfg: dict) -> List[Tuple[str, str]]:
    """(unit, leaf) of every parameter leaf, in ``units`` order."""
    return [(u, name) for u in units(cfg) for name, _, _ in _unit_leaves(cfg, u)]


def n_params(cfg: dict) -> int:
    return sum(math.prod(shape) for u in units(cfg) for _, shape, _ in _unit_leaves(cfg, u))
