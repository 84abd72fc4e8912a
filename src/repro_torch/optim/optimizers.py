"""Optimizers over parameter trees (pure transforms, not ``torch.optim``).

``Optimizer`` mirrors the optax contract of the JAX package:
``init(params) -> state`` and ``update(grads, state, params) -> (updates,
state)``; ``apply_updates`` adds them.  Nothing is updated in place: every
call returns new tensors.  The suite is the JAX package's:

  * adamw      — m/v in float32 (default) or bfloat16 (``state_dtype``).
  * adafactor  — factored second moment (rank-1 row/col statistics) for
    ≥2-D leaves + optional bfloat16 momentum: ~0 bytes of state per param
    without momentum.  Its statistics and its RMS update clip are taken
    over the JAX package's *stacked* leaves (block leaves stacked over
    ``[n_groups, run_len]``), so it takes the model's config and keeps its
    state in that layout (see ``adafactor``); on a mesh they are the
    global stacked leaf's, summed over the leaf's blocks.
  * sgdm       — momentum baseline.

All fold in global-norm gradient clipping (``clip_norm``) and a
learning-rate schedule (step -> lr).  Moments in bfloat16 are computed in
float32 and rounded to nearest even when stored, as XLA's ``astype``.

Spans (``repro_torch.spans``): ``optimizer.clip`` (the global norm and the
scaled gradients), ``optimizer.update`` (the per-leaf update) and
``optimizer.apply`` (``apply_updates``).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.distributed import collectives as col
from repro_torch.distributed import sharding
from repro_torch.models.convert import to_jax_layout
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor
Schedule = Callable[[Tensor], Tensor]


def _same(params):
    return params


class Optimizer(NamedTuple):
    """``init(params) -> state`` (a fresh state is zeros, its step too) and
    ``update(grads, state, params, placements=None) -> (updates, state)``.
    On a mesh ``params`` and ``grads`` are this rank's blocks and
    ``placements`` (a ``distributed.sharding.Placements`` of the params)
    says how each leaf splits, so that the clip norm (and Adafactor's
    statistics) sum each leaf over its blocks.  ``state_layout(params)`` is
    the tree whose paths and shapes the state's leaves follow: the params
    themselves, or Adafactor's stacked tree; a mesh takes the state's specs
    from it (``launch.train.make_sharded_state_and_step``)."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple]
    state_layout: Callable[[Any], Any] = _same
    # ``update_in_place(grads, state, params) -> state``: ``update`` and
    # ``apply_updates`` written into ``params`` and the state's own tensors,
    # leaf by leaf, with the same arithmetic (a donated step); AdamW's only
    update_in_place: Optional[Callable[..., Any]] = None


def global_norm(tree) -> Tensor:
    """sqrt(Σ over leaves of Σ x²), in float32."""
    sq = [x.float().square().sum() for x in tree_leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def _clip_scale(grads, clip_norm: Optional[float], placements=None) -> Optional[Tensor]:
    """min(1, clip_norm / the global norm of grads) (float32 0-d), or None
    without clipping; on a mesh each leaf's sum of squares is summed over
    its blocks."""
    if clip_norm is None:
        return None
    if placements is None:
        norm = global_norm(grads)
    else:
        norm = sharding.global_norm(tree_leaves(grads), tree_leaves(placements.specs),
                                    placements.mesh)
    return torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)


def _clip_by_global_norm(grads, clip_norm: Optional[float], placements=None):
    with spans.span("optimizer.clip"):
        scale = _clip_scale(grads, clip_norm, placements)
        if scale is None:
            return grads
        return tree_map(lambda g: g * scale.to(g.dtype), grads)


def apply_updates(params, updates):
    """params + updates, added in float32 and cast back to each param's dtype."""
    with spans.span("optimizer.apply"):
        return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype), params, updates)


def _per_leaf(fn, n_out: int, params, *trees):
    """``fn`` over the leaves of ``params`` and ``trees`` (one structure),
    returning ``n_out`` results per leaf -> ``n_out`` trees of that structure."""
    outs = [fn(*xs) for xs in zip(tree_leaves(params), *map(tree_leaves, trees))]
    return tuple(tree_unflatten(params, [o[i] for o in outs]) for i in range(n_out))


def _zeros_like_tree(params, dtype):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device), params)


def _step0(params) -> Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


class AdamState(NamedTuple):
    step: Tensor  # int32 0-d: updates taken so far
    m: Any
    v: Any


def adamw(
    schedule: Schedule,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """AdamW with decoupled weight decay inside the lr product:
    ``u = -lr·(m̂/(√v̂ + eps) + weight_decay·p)``, bias-corrected from the
    incremented step.  The moments m and v are stored in ``state_dtype``;
    the arithmetic runs in float32."""

    def init(params):
        return AdamState(step=_step0(params), m=_zeros_like_tree(params, state_dtype),
                         v=_zeros_like_tree(params, state_dtype))

    def leaf_update(state):
        """(the incremented step, ``(p, g, m, v) -> (update, m, v)`` at it)."""
        step = state.step + 1
        lr = schedule(step)
        s = step.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=s.device), s)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=s.device), s)

        def upd(p, g, m, v):
            g32 = g.float()
            m32 = b1 * m.float() + (1 - b1) * g32
            v32 = b2 * v.float() + (1 - b2) * g32.square()
            u = -lr * ((m32 / c1) / ((v32 / c2).sqrt() + eps) + weight_decay * p.float())
            return u, m32.to(state_dtype), v32.to(state_dtype)

        return step, upd

    def update(grads, state, params, placements=None):
        grads = _clip_by_global_norm(grads, clip_norm, placements)
        step, upd = leaf_update(state)
        with spans.span("optimizer.update"):
            updates, m, v = _per_leaf(upd, 3, params, grads, state.m, state.v)
        return updates, AdamState(step=step, m=m, v=v)

    def update_in_place(grads, state, params):
        """``update`` then ``apply_updates``, each leaf written into its
        param and moments as it is done: no second copy of either."""
        with spans.span("optimizer.clip"):
            scale = _clip_scale(grads, clip_norm)
        step, upd = leaf_update(state)
        with spans.span("optimizer.update"):
            for p, g, m, v in zip(*map(tree_leaves, (params, grads, state.m, state.v))):
                u, m_new, v_new = upd(p, g if scale is None else g * scale.to(g.dtype), m, v)
                m.copy_(m_new)
                v.copy_(v_new)
                p.copy_((p.float() + u.float()).to(p.dtype))
        return AdamState(step=step, m=state.m, v=state.v)

    return Optimizer(init=init, update=update, update_in_place=update_in_place)


# ---------------------------------------------------------------------------
# Adafactor (factored second moment)
# ---------------------------------------------------------------------------


class FactoredV(NamedTuple):
    """Second-moment statistics of one stacked leaf: factored row/col (≥2-D)
    or full (1-D and scalars)."""

    row: Tensor  # shape[:-1]            (zeros((1,)) when unused)
    col: Tensor  # shape[:-2] + [-1]     (zeros((1,)) when unused)
    full: Tensor  # same as the leaf      (zeros((1,)) when factored)


class AdafactorState(NamedTuple):
    step: Tensor
    m: Any  # momentum, in the stacked layout (zeros((1,)) leaves when disabled)
    v: Any  # tree of FactoredV, in the stacked layout


def _factorable(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _stacking(params, cfg) -> Any:
    """The stacked layout of ``params``: the JAX ``lm_init`` tree (``cfg``'s
    stacking, ``models.convert.to_jax_layout``) whose leaves are int arrays
    of the port's leaf indices, shape ``[n_groups, run_len]`` for a stacked
    block leaf and ``()`` for the rest.  ``cfg=None``: ``params`` is taken
    as already stacked (each leaf its own)."""
    idx = tree_unflatten(params, [np.array(i) for i in range(len(tree_leaves(params)))])
    if cfg is None:
        if isinstance(params, dict) and isinstance(params.get("blocks"), list):
            raise ValueError("adafactor over a model's params needs its cfg= (the JAX "
                             "package's statistics are over stacked block leaves)")
        return idx
    return to_jax_layout(idx, cfg, np.array)


def adafactor(
    schedule: Schedule,
    decay: float = 0.99,
    eps: float = 1e-30,
    momentum: Optional[float] = 0.9,
    momentum_dtype: torch.dtype = torch.bfloat16,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = 1.0,
    *,
    cfg,
) -> Optimizer:
    """Adafactor as the JAX package's, on the port's per-layer params.

    The reference runs over its stacked tree, where a block leaf is
    ``[n_groups, run_len, *shape]``: factorability, the factored statistics
    and the RMS update clip are per stacked leaf.  So a 1-D leaf of a run
    longer than one is factored over ``(run_len, d)`` and the RMS spans all
    layers of a run and all groups.  ``cfg`` (the model's ``ModelConfig``)
    gives that stacking; ``cfg=None`` takes each leaf of ``params`` as a
    stacked leaf of its own (a plain tree; a model's params raise).

    The state (``AdafactorState``) is in the stacked layout, with the JAX
    tree's paths and shapes, so a JAX checkpoint's state loads as it is.
    Statistics of ≥2-D leaves factor per layer (their means run over each
    layer's last two axes) and only the RMS sums over the layers; the
    smaller leaves are stacked with ``torch.stack`` and computed whole.

    On a mesh (``update(..., placements=)``) each rank holds its blocks of
    the params and of the stacked state (the stacked leaf's spec is the
    layer's behind ``[None, None]``; ``row``/``col`` take it less its last /
    second-to-last entry, ``distributed.sharding.opt_state_specs``), and
    every statistic is the global stacked leaf's: a mean over a split axis
    sums its partial sums over that axis's ranks and divides by the whole
    length, the RMS clip sums over every axis that splits the leaf and
    divides by the whole leaf's size.  Factorability follows the whole
    leaf's shape, so a mesh's state is cut from the whole params' (a local
    block's dim of 1 would not factor)."""

    def init(params):
        leaves = tree_leaves(params)

        def shape_of(idx):
            return idx.shape + leaves[int(idx.flat[0])].shape

        def zeros(shape, dtype, idx):
            return torch.zeros(shape, dtype=dtype, device=leaves[int(idx.flat[0])].device)

        def fv(idx):
            shape = shape_of(idx)
            if _factorable(shape):
                return FactoredV(row=zeros(shape[:-1], torch.float32, idx),
                                 col=zeros(shape[:-2] + shape[-1:], torch.float32, idx),
                                 full=zeros((1,), torch.float32, idx))
            return FactoredV(row=zeros((1,), torch.float32, idx),
                             col=zeros((1,), torch.float32, idx),
                             full=zeros(shape, torch.float32, idx))

        def mom(idx):
            return zeros((1,) if momentum is None else shape_of(idx), momentum_dtype, idx)

        layout = _stacking(params, cfg)
        return AdafactorState(step=_step0(params), m=tree_map(mom, layout),
                              v=tree_map(fv, layout))

    def update(grads, state, params, placements=None):
        g_leaves, p_leaves = tree_leaves(grads), tree_leaves(params)
        with spans.span("optimizer.clip"):  # the scale alone: each piece applies it
            scale = _clip_scale(g_leaves, clip_norm, placements)
        step = state.step + 1
        lr = schedule(step)
        vs = tree_leaves(state.v)
        specs = None if placements is None else tree_leaves(placements.specs)
        mesh = None if placements is None else placements.mesh
        updates: List[Optional[Tensor]] = [None] * len(p_leaves)
        new_m, new_v = [], []
        with spans.span("optimizer.update"):
            for idx, m, v in zip(tree_leaves(_stacking(params, cfg)), tree_leaves(state.m),
                                 zip(vs[0::3], vs[1::3], vs[2::3])):
                spec = () if specs is None else tuple(specs[int(idx.flat[0])])
                m, v = _adafactor_leaf(idx, g_leaves, p_leaves, m, FactoredV(*v), scale, lr,
                                       updates, decay, eps, momentum, momentum_dtype,
                                       weight_decay, spec, mesh)
                new_m.append(m)
                new_v.extend(v)
        return tree_unflatten(params, updates), AdafactorState(
            step=step, m=tree_unflatten(state.m, new_m), v=tree_unflatten(state.v, new_v))

    def state_layout(params):
        return params if cfg is None else to_jax_layout(
            params, cfg, lambda rows: torch.stack([torch.stack(r) for r in rows]))

    return Optimizer(init=init, update=update, state_layout=state_layout)


def _adafactor_leaf(idx, g_leaves, p_leaves, m, v: FactoredV, scale, lr, updates,
                    decay, eps, momentum, momentum_dtype, weight_decay, spec=(), mesh=None):
    """One stacked leaf's update, written into ``updates`` at the port's
    leaf indices ``idx``; returns its new momentum and statistics.  ``spec``
    is the layer's spec on ``mesh`` (``()``: whole leaves): the statistics
    are the global stacked leaf's.

    Pieces ``(pos, port leaf indices, gradient)``: each layer of a ≥2-D
    leaf on its own at its position ``pos`` in the stack (an unstacked leaf
    is one such piece, pos ``()``); a smaller stacked leaf whole (pos ``()``,
    its gradient a ``torch.stack`` of its layers')."""
    local = tuple(p_leaves[int(idx.flat[0])].shape)
    whole = sharding.global_shape(local, spec, mesh) if spec else local
    shape = idx.shape + whole
    # the mesh axis of each dim of the stacked leaf (None: whole)
    entries = (None,) * idx.ndim + spec + (None,) * (len(whole) - len(spec))
    factored = _factorable(shape)

    def mean(x, dim, of, keepdim=False):
        """The mean of ``x`` over its axis ``dim``, the stacked leaf's axis
        ``of``: where a mesh splits that axis, the partial sums summed over
        its ranks over the whole length."""
        if entries[of] is None:
            return x.mean(dim, keepdim=keepdim)
        return col.all_reduce_values(x.sum(dim, keepdim=keepdim), mesh, entries[of]) / shape[of]

    if len(shape) - idx.ndim >= 2 or idx.ndim == 0:
        pieces = [(pos, [int(idx[pos])], g_leaves[int(idx[pos])])
                  for pos in np.ndindex(idx.shape)]
    else:
        ids = [int(i) for i in idx.flat]
        pieces = [((), ids, torch.stack([g_leaves[i] for i in ids]).reshape(idx.shape + local))]
    stats = (v.row, v.col) if factored else (v.full,)
    new_stats = [torch.empty_like(t) for t in stats]
    us, sq = [], torch.zeros((), dtype=torch.float32, device=v.row.device)
    for pos, _, g in pieces:
        g32 = (g if scale is None else g * scale.to(g.dtype)).float()
        g2 = g32.square() + eps
        if factored:
            row = decay * v.row[pos] + (1 - decay) * mean(g2, -1, -1)
            col_ = decay * v.col[pos] + (1 - decay) * mean(g2, -2, -2)
            rmean = mean(row, -1, -2, keepdim=True)  # row's last axis is the leaf's -2
            vhat = row[..., :, None] * col_[..., None, :] / torch.clamp(rmean[..., None],
                                                                        min=eps)
            new_stats[0][pos], new_stats[1][pos] = row, col_
        else:
            vhat = decay * v.full[pos] + (1 - decay) * g2
            new_stats[0][pos] = vhat
        u = g32 * torch.rsqrt(vhat + eps)
        sq = sq + u.square().sum()
        us.append(u)
    # update clipping (the adafactor RMS trick), over the whole stacked leaf
    for entry in dict.fromkeys(e for e in entries if e is not None):
        sq = col.all_reduce_values(sq, mesh, entry)
    denom = torch.clamp(torch.sqrt(sq / float(np.prod(shape)) + 1e-12), min=1.0)
    m_out = m if momentum is None else torch.empty_like(m)
    neg_lr = -lr
    for k, (pos, ids, _) in enumerate(pieces):
        u, us[k] = us[k].div_(denom), None  # each piece's f32 copy lives until it is an update
        if momentum is not None:
            u = momentum * m[pos].float() + (1 - momentum) * u
            m_out[pos] = u.to(momentum_dtype)
        whole = pos == () and idx.ndim > 0  # the stacked piece: one update per layer
        parts = u.reshape((-1,) + u.shape[idx.ndim:]).unbind(0) if whole else [u]
        for i, part in zip(ids, parts):
            if weight_decay:
                part = part + weight_decay * p_leaves[i].float()
            updates[i] = part.mul_(neg_lr)
    new_v = new_stats + [v.full] if factored else [v.row, v.col, new_stats[0]]
    return m_out, new_v


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------


class SgdState(NamedTuple):
    step: Tensor
    m: Any


def sgdm(
    schedule: Schedule,
    momentum: float = 0.9,
    weight_decay: float = 0.0,
    clip_norm: Optional[float] = 1.0,
    state_dtype: torch.dtype = torch.float32,
) -> Optimizer:
    """SGD with heavy-ball momentum: ``m = momentum·m + g + weight_decay·p``,
    ``u = -lr·m``; m stored in ``state_dtype``, the arithmetic in float32."""

    def init(params):
        return SgdState(step=_step0(params), m=_zeros_like_tree(params, state_dtype))

    def update(grads, state, params, placements=None):
        grads = _clip_by_global_norm(grads, clip_norm, placements)
        step = state.step + 1
        lr = schedule(step)

        def upd(p, g, m):
            g32 = g.float() + weight_decay * p.float()
            m32 = momentum * m.float() + g32
            return -lr * m32, m32.to(state_dtype)

        with spans.span("optimizer.update"):
            updates, m = _per_leaf(upd, 2, params, grads, state.m)
        return updates, SgdState(step=step, m=m)

    return Optimizer(init=init, update=update)


def make_optimizer(name: str, schedule: Schedule, *, cfg, **kw) -> Optimizer:
    """The optimizer ``name`` ("adamw", "adafactor", "sgdm") over ``schedule``.

    ``cfg`` is the model's config, which Adafactor's stacked statistics need
    (``None`` for a plain tree); AdamW and SGD are elementwise and ignore
    it.  ``kw`` goes to the optimizer."""
    if name == "adamw":
        return adamw(schedule, **kw)
    if name == "adafactor":
        return adafactor(schedule, cfg=cfg, **kw)
    if name == "sgdm":
        return sgdm(schedule, **kw)
    raise ValueError(f"unknown optimizer {name!r}")
