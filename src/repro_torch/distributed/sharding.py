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
engine's slotted decode cache takes its specs from ``slot_cache_specs``
(each backend's ``cache_pspec`` resolved per leaf by
``_resolve_logical_spec``), a prefill's caches from ``cache_specs``, and
its weights from ``serve_param_specs``.
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


def block_shape(shape: Sequence[int], spec, mesh) -> Tuple[int, ...]:
    """A block's shape from the whole leaf's shape and its spec (the inverse
    of ``global_shape``)."""
    out = list(shape)
    for dim, entry in _entries(spec):
        out[dim] //= mesh_axis_size(mesh, entry)
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


# ---------------------------------------------------------------------------
# Slotted serve-cache specs: each backend's state layout, resolved per leaf
# ---------------------------------------------------------------------------


def _resolve_logical_spec(logical, shape: Sequence[int], rules: Rules, mesh) -> P:
    """One leaf's logical spec ("dp" / "tp" / None per dim) -> physical axes,
    divisibility-aware, one physical axis once, and where the dim carrying
    "tp" (the head dim) does not divide, "tp" on the leaf's last dim when
    that divides (MQA: the Taylor value moments shard their d_v columns)."""
    entries: list = []
    used = set()
    for name, size in zip(tuple(logical), shape):
        phys = _resolve_dim(name, size, rules, mesh)
        key = tuple(phys) if isinstance(phys, tuple) else phys
        if phys is not None and key in used:
            phys = None
        if phys is not None:
            used.add(key)
        entries.append(phys)
    logical_t = tuple(logical)
    if "tp" in logical_t:
        i = logical_t.index("tp")
        if entries[i] is None and i < len(shape) - 1 and logical_t[-1] is None:
            phys = _resolve_dim("tp", shape[-1], rules, mesh)
            key = tuple(phys) if isinstance(phys, tuple) else phys
            if phys is not None and key not in used:
                entries[-1] = phys
    return P(*entries)


def _logical_cache_specs(cfg) -> Dict[str, Any]:
    """The logical spec tree of ``lm_init_caches``'s output: each run's state
    from its own backend's ``cache_pspec`` (a mamba run's from the "ssm"
    backend, a cross block's pair with its ``cross_cache_pspec``), group
    runs with their ``[n_groups, run_len]`` stacking entries in front, and
    ``kv_src`` slots over "dp"."""
    from repro_torch.backends import get_backend, resolve_backend  # noqa: PLC0415 (cycle)
    from repro_torch.backends.state import CrossCache  # noqa: PLC0415
    from repro_torch.models.config import schedule_runs  # noqa: PLC0415

    def one(kind, rcfg):
        if kind == "mamba":
            return get_backend("ssm").cache_pspec(rcfg)
        backend = resolve_backend(rcfg)
        spec = backend.cache_pspec(rcfg)
        if kind != "cross":
            return spec
        return spec, CrossCache(kv=backend.cross_cache_pspec(rcfg))

    def stack(tree):
        return tree_map(lambda p: P(None, None, *p), tree)

    tail_cfg = cfg.layer_cfg(cfg.attention)
    return {
        "group": tuple(stack(one(kind, cfg.layer_cfg(bk))) for kind, bk, _ in
                       schedule_runs(cfg)) if cfg.n_groups else (),
        "tail": tuple(one(kind, tail_cfg) for kind in cfg.tail),
        "kv_src": P("dp", None, None) if cfg.family in ("vlm", "encdec") else None,
    }


def slot_cache_specs(cfg, max_slots: int, n_max: int, mesh, rules: Rules, state=None) -> Any:
    """The spec tree of the serve engine's slotted decode cache.

    Congruent with ``models.lm.lm_init_caches(cfg, max_slots, n_max)``
    (group caches ``[n_groups, run_len, slots, ...]``, tail caches
    ``[slots, ...]``, ``kv_src``), or with a codec's stored tree when
    ``state`` is a ``serve.state_repr`` codec other than the dense one
    (its ``logical_specs``: a quantised payload keeps the dense leaf's
    spec and its scale replicates; page pools reuse the dense K/V specs,
    the page table and lengths replicate).  Each run's layout comes from
    its backend's ``cache_pspec``: ``kv`` and ``moments`` states put slots
    over "dp" and kv heads over "tp" (MQA's indivisible heads fall back to
    the last dim), ``ssm`` states slots over "dp" and SSD heads and conv
    channels over "tp".  Every axis resolves divisibility-aware, so a 1×1
    mesh (or an indivisible one) gives replicated specs."""
    import dataclasses  # noqa: PLC0415

    from repro_torch.models.lm import lm_init_caches  # noqa: PLC0415 (cycle)

    meta = torch.device("meta")
    logical = _logical_cache_specs(cfg)
    if state is not None and state.name != "dense":
        shapes = dataclasses.replace(state, device=meta, mesh=None).init_stored()
        logical = state.logical_specs(logical)
    else:
        shapes = lm_init_caches(cfg, max_slots, n_max, device=meta)
    return tree_map(lambda p, leaf: _resolve_logical_spec(p, leaf.shape, rules, mesh),
                    logical, shapes)


def cache_specs(cache_shapes: Any, mesh, rules: Rules, batch: int) -> Any:
    """Decode caches of a batch (``lm_prefill``'s output): the batch dim is
    found by its size (0 for tail caches, 1 or 2 under the group stacking)
    and goes over "dp", the heads dim after it over "tp", falling back to
    the last dim (MQA Taylor states shard their d_v dim)."""

    def one(leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        if not shape:
            return P()
        entries: list = [None] * len(shape)
        for b_idx in (0, 1, 2):
            if len(shape) > b_idx and shape[b_idx] == batch:
                break
        else:
            return P(*entries)
        entries[b_idx] = _resolve_dim("dp", shape[b_idx], rules, mesh)
        h_idx = b_idx + 1
        if len(shape) > h_idx:
            tp = _resolve_dim("tp", shape[h_idx], rules, mesh)
            if tp is not None:
                entries[h_idx] = tp
            elif len(shape) > h_idx + 1:
                entries[-1] = _resolve_dim("tp", shape[-1], rules, mesh)
        return P(*entries)

    return tree_map(one, cache_shapes)


def serve_param_specs(params: Any, cfg, mesh, rules: Rules) -> Any:
    """Where the serve engine holds each weight: a layer's attention (and
    cross-attention) and MLP weights in their ``param_specs`` "model" blocks
    where its site keeps them split (``spmd.attn_mode`` "heads", ``d_ff``
    dividing), the value projection's columns and the output projection's
    rows under "dv" (the kv heads do not divide, MQA), a MoE block's experts
    over "ep" along the expert dim where it divides (``ep_a2a`` pads and
    cuts them otherwise) and its shared experts' ``d_ff`` as an MLP's, an
    encoder block's heads and ``d_ff`` where they divide (its sites carry
    no state, so they never take "dv"), everything else whole.
    A decode step reads every weight, so a block gathered over "data"
    (fsdp) would move the whole model per token: the engine's weights
    replicate over "data", and every collective of a step moves
    activations or state."""
    from repro_torch.distributed import spmd  # noqa: PLC0415 (cycle)
    from repro_torch.models.lm import _layers  # noqa: PLC0415 (cycle)

    tp, ep = rules.get("tp"), rules.get("ep")
    size = mesh_axis_size(mesh, tp) if tp is not None else 1
    tp_rules = {"tp": tp}
    whole = lambda tree: tree_map(lambda _: P(), tree)  # noqa: E731
    split = lambda tree: param_specs(tree, mesh, tp_rules)  # noqa: E731
    out = whole(params)

    def block(p, kind, lcfg, dv=True):
        spec = whole(p)
        if size == 1:
            return spec
        for key in ("attn", "cross"):
            if key not in p or kind == "mamba":
                continue
            mode = spmd.attn_mode(lcfg, size)
            if mode == "heads":
                spec[key] = {k: split({k: v})[k] for k, v in p[key].items()}
            elif mode == "dv" and dv:
                spec[key]["wv"] = {k: P(*([None] * (v.ndim - 1)), tp)
                                   for k, v in p[key]["wv"].items()}
                spec[key]["wo"] = {"w": P(None, tp, None)}
        if "mlp" in p and lcfg.d_ff % size == 0:
            spec["mlp"] = {k: split({k: v})[k] for k, v in p["mlp"].items()}
        if "moe" in p:
            # experts over "ep" along the expert dim, the router whole, the
            # shared experts' d_ff over "model" where it divides (their site's split)
            spec["moe"]["experts"] = param_specs({"experts": p["moe"]["experts"]}, mesh,
                                                 {"ep": ep})["experts"]
            if "shared" in p["moe"] and lcfg.moe.d_ff_shared % size == 0:
                spec["moe"]["shared"] = split(p["moe"]["shared"])
        return spec

    blocks, shared = [], None
    for i, (kind, lcfg, p) in enumerate(_layers(params, cfg)):
        if params["blocks"][i] is None:  # a shared_attn occurrence
            shared = block(p, kind, lcfg)
            blocks.append(None)
        else:
            blocks.append(block(p, kind, lcfg))
    out["blocks"] = blocks
    if shared is not None:
        out["shared"] = shared
    if "encoder" in params:
        out["encoder"]["blocks"] = [block(p, kind, cfg, dv=False) for kind, p in
                                    zip(cfg.encoder_pattern * cfg.n_encoder_groups,
                                        params["encoder"]["blocks"])]
    return out
