"""Parameter / optimizer-state / batch specs, and placing trees on a mesh.

Rules are written on *path suffixes* and *trailing dims*, so one table
covers the JAX package's stacked leaves (``[n_groups, run_len, ...]``) and
the port's per-layer ones: a port leaf's spec is the reference leaf's spec
without its stacked leading entries.  Every rule is resolved
**divisibility-aware**: a logical axis is dropped where the dim does not
divide by the physical axis size, which lets one table serve MQA (kv = 1),
GQA, MHA, the reduced test configs and the 1 T MoE.

Logical axes (bound to physical axes by ``distributed.api`` rules):
  fsdp — parameter sharding (ZeRO-3 style; gathered per layer for compute)
  tp   — tensor parallel (heads / ffn / vocab)
  ep   — expert parallel (the same physical axis as tp by default)
  dp   — batch

``Placements(mesh, specs)`` says where each leaf of a tree lives;
``distribute_tree`` cuts whole leaves into this rank's blocks and
``gather_tree`` puts the blocks back together (a collective).  The serve
engine's cache specs (``slot_cache_specs``, ``cache_specs``) are not
ported yet.
"""

from __future__ import annotations

import re
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.distributed import collectives as col
from repro_torch.distributed.api import P, Rules, entry_names, mesh_axis_size
from repro_torch.tree import tree_items, tree_map, tree_unflatten

# (path-suffix regex, trailing-dim logical axes).  First match wins.
PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"(embed|unembed)\.w$", ("tp", "fsdp")),
    (r"pos_embed$", (None, "tp")),
    (r"vision_proj\.w$", (None, "tp")),
    (r"experts\.(w_gate|w_up)$", ("ep", "fsdp", None)),
    (r"experts\.w_down$", ("ep", None, "fsdp")),
    (r"experts\.(b_up)$", ("ep", None)),
    (r"experts\.(b_down)$", ("ep", None)),
    (r"router\.w$", ("fsdp", None)),
    (r"wq\.w$", ("fsdp", "tp", None)),
    (r"(wk|wv)\.w$", ("fsdp", "tp", None)),
    (r"(wq|wk|wv)\.b$", ("tp", None)),
    (r"wo\.w$", ("tp", None, "fsdp")),
    (r"(w_gate|w_up)$", ("fsdp", "tp")),
    (r"w_down$", ("tp", "fsdp")),
    (r"b_up$", ("tp",)),
    (r"b_down$", (None,)),
    (r"in_proj\.w$", ("fsdp", "tp")),
    (r"conv_w$", (None, "tp")),
    (r"conv_b$", ("tp",)),
    (r"(A_log|D|dt_bias)$", ("tp",)),
    (r"out_proj\.w$", ("tp", "fsdp")),
    (r"gate_norm\.scale$", ("tp",)),
    # norms & anything else: replicated
)


def norm_path(path: str) -> str:
    """``.m['blocks'][0]['attn']`` -> ``m.blocks.0.attn`` (the reference's
    ``_norm_path`` of the same leaf, up to its stacking keys)."""
    s = re.sub(r"\[['\"]?([^'\"\]]+)['\"]?\]", r".\1", path)
    return s.lstrip(".")


def _resolve_dim(logical: Optional[str], size: int, rules: Rules, mesh) -> Optional[Any]:
    """Physical axis (or tuple) for one dim, or None if off/indivisible."""
    if logical is None:
        return None
    phys = rules.get(logical)
    if phys is None:
        return None
    if size % mesh_axis_size(mesh, phys) != 0:
        return None
    return phys


def spec_for(path_str: str, shape: Sequence[int], rules: Rules, mesh) -> P:
    for pattern, logical_axes in PARAM_RULES:
        if re.search(pattern, path_str):
            n_lead = len(shape) - len(logical_axes)
            if n_lead < 0:
                continue  # rule written for more dims than this param has
            entries: list = [None] * n_lead
            used = set()
            for logical, size in zip(logical_axes, shape[n_lead:]):
                phys = _resolve_dim(logical, size, rules, mesh)
                if phys is not None and phys in used:
                    phys = None  # one physical axis may appear only once
                if phys is not None:
                    used.add(phys)
                entries.append(phys)
            return P(*entries)
    return P()  # replicated


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(leaf.shape)


def param_specs(params_shapes: Any, mesh, rules: Rules) -> Any:
    """Tree of ``P`` mirroring a tree of tensors (or anything with ``.shape``)."""
    items = list(tree_items(params_shapes))
    return tree_unflatten(params_shapes, [spec_for(norm_path(p), _shape(l), rules, mesh)
                                          for p, l in items])


def opt_state_specs(opt_state_shapes: Any, pspecs: Any, params_shapes: Any, mesh,
                    rules: Rules) -> Any:
    """Specs of an optimizer state, by matching its paths against the params'.

    A state leaf whose path ends in a param's path (after the state's own
    prefix, e.g. ``m.``) and whose shape equals the param's inherits its
    spec; Adafactor's factored ``row``/``col`` statistics take the spec
    without its last / second-to-last entry; placeholders and scalars are
    replicated."""
    del mesh, rules
    by_path = {norm_path(p): (_shape(l), s) for (p, l), (_, s) in zip(
        tree_items(params_shapes), tree_items(pspecs))}

    def match(path_str: str, shape):
        parts = path_str.split(".")
        for i in range(len(parts)):
            for field in ("", "row", "col", "full"):
                if field and parts[-1] != field:
                    continue
                cand = ".".join(parts[i:-1] if field else parts[i:])
                if cand not in by_path:
                    continue
                pshape, pspec = by_path[cand]
                if shape == pshape:
                    return pspec
                if field == "row" and shape == pshape[:-1]:
                    return P(*tuple(pspec)[:-1]) if len(pspec) else P()
                if field == "col" and shape == pshape[:-2] + pshape[-1:]:
                    t = tuple(pspec)
                    return P(*(t[:-2] + t[-1:])) if len(t) >= 2 else P()
                return P()  # placeholder / scalar
        return P()

    items = list(tree_items(opt_state_shapes))
    return tree_unflatten(opt_state_shapes, [match(norm_path(p), _shape(l)) for p, l in items])


def batch_specs(batch_shapes: Any, mesh, rules: Rules) -> Any:
    """Inputs: dim 0 = batch -> dp (when divisible); the rest replicated."""

    def one(leaf):
        shape = _shape(leaf)
        if len(shape) == 0:
            return P()
        return P(_resolve_dim("dp", shape[0], rules, mesh), *([None] * (len(shape) - 1)))

    return tree_map(one, batch_shapes)


# ---------------------------------------------------------------------------
# Placing trees on a mesh
# ---------------------------------------------------------------------------


class Placements(NamedTuple):
    """Where each leaf of a tree lives: a mesh and a congruent tree of ``P``."""

    mesh: Any
    specs: Any


def _entries(spec):
    return [(dim, entry) for dim, entry in enumerate(spec) if entry is not None]


def block_of(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of a whole leaf (a view)."""
    for dim, entry in _entries(spec):
        x = col.slice_values(x, dim, mesh, entry)
    return x


def distribute_tree(tree: Any, placements: Placements) -> Any:
    """Whole leaves (the same on every rank) -> this rank's blocks."""
    return _map_specs(lambda x, spec: block_of(x, spec, placements.mesh).contiguous(), tree,
                      placements.specs)


def gather_leaf(x: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A block with ``spec`` -> the whole leaf on every rank (a collective)."""
    for dim, entry in reversed(_entries(spec)):
        x = col.gather_values(x, dim, mesh, entry)
    return x


def gather_tree(tree: Any, placements: Placements) -> Any:
    """This rank's blocks -> whole leaves on every rank (a collective)."""
    return _map_specs(lambda x, spec: gather_leaf(x, spec, placements.mesh), tree,
                      placements.specs)


def global_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """The whole leaf's shape from a block's shape and its spec."""
    out = list(shape)
    for dim, entry in _entries(spec):
        out[dim] *= mesh_axis_size(mesh, entry)
    return tuple(out)


def whole_template(tree: Any, placements: Placements) -> Any:
    """Uninitialised whole-shaped CPU tensors for a tree of blocks (a
    template to read whole leaves into)."""
    return _map_specs(lambda x, spec: torch.empty(global_shape(x.shape, spec, placements.mesh),
                                                  dtype=x.dtype), tree, placements.specs)


def _map_specs(fn, tree, specs):
    leaves = [fn(torch.as_tensor(x), s) for (_, x), (_, s) in zip(tree_items(tree),
                                                                   tree_items(specs))]
    return tree_unflatten(tree, leaves)


def global_norm(leaves, specs, mesh) -> torch.Tensor:
    """sqrt(Σ over leaves of Σ x²) in float32 of a tree's blocks (``specs``
    leaf by leaf): each leaf's sum is summed over the axes that split it,
    one all-reduce per set of axes."""
    sq = [x.float().square().sum() for x in leaves]
    groups: Dict[Tuple[str, ...], list] = {}
    for i, spec in enumerate(specs):
        names = tuple(sorted({nm for e in spec for nm in entry_names(e)}))
        groups.setdefault(names, []).append(i)
    out = list(sq)
    for names, idx in groups.items():
        if not names:
            continue
        vals = torch.stack([sq[i] for i in idx])
        for name in names:
            vals = col.all_reduce_values(vals, mesh, name)
        for j, i in enumerate(idx):
            out[i] = vals[j]
    return torch.stack(out).sum().sqrt()
