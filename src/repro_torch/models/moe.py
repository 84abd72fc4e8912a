"""Mixture-of-Experts FFN (the JAX package's ``models/moe.py``).

Three dispatch paths behind one API:

  * ``dense``  — every expert sees every token, combined through one-hot
    gate weights: exact but O(tokens · E · d · ff); the oracle.
  * ``ep``     — fixed expert capacity (GShard-style, sort-free: a cumsum
    of one-hots gives each routed (token, k) its place in its expert's
    buffer), dispatch and combine as einsums; routed pairs past the
    capacity are dropped.  O(tokens · top_k · capacity_factor · d · ff).
  * ``ep_a2a`` — expert parallelism on a mesh (``_moe_ep_a2a``): each
    "data" shard routes its tokens, chunk by chunk, into per-expert
    buffers by sort-based positions, an all-to-all over "ep" (= "model")
    hands each rank its experts' buffers (optionally as an int8 payload),
    the experts run there, and the reverse all-to-all brings the outputs
    back to be combined.  Experts are zero-padded to a multiple of the ep
    axis (padded experts are never routed to).  ``_moe_ep_a2a_plain``
    computes the same function on one device without collectives (the
    tests' and ``chip_smoke.py``'s reference for a mesh run).

``moe_apply`` picks the path as the JAX package does: ``"auto"`` runs
``ep_a2a`` on a mesh (inside ``distributed.spmd.region`` or an
``api.sharding_rules`` context) and ``dense`` off one; ``"ep_a2a"`` off a
mesh runs ``ep``.  Inside a region ``dense`` and ``ep`` (and ``ep_a2a`` over
an ep axis of one rank) give the single-device numbers over the whole
batch: global capacity and positions, the aux loss from global means.

Routing: softmax of the f32 router logits, top-k with renormalised gates,
lower expert index first on ties (``jax.lax.top_k``'s order); optional
shared experts (Qwen-MoE / Kimi style, one fused MLP) always active.  A
Switch-style load-balance loss ``E · Σ_e f_e · p_e`` is returned for the
train loop.  The expert products are plain batched matrix products, as in
the JAX package, where they are XLA code outside any Pallas kernel.

Params: ``{"router": {"w": [d, E] f32}, "experts": {leaf: [E, ...]},
"shared": mlp params}`` (``shared`` only with ``n_shared_experts``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed import api as dist
from repro_torch.distributed import collectives as col
from repro_torch.distributed import spmd
from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    m = cfg.moe
    d = cfg.d_model
    experts = {}
    for e in range(m.n_experts):  # drawn expert by expert into the stacked leaves
        for k, v in mlp_init(gen, d, m.d_ff_expert, cfg.act, dtype).items():
            experts.setdefault(k, v.new_empty((m.n_experts,) + v.shape))[e] = v
    params = {
        "router": dense_init(gen, (d, m.n_experts), dtype=torch.float32),
        "experts": experts,
    }
    if m.n_shared_experts:
        params["shared"] = mlp_init(gen, d, m.d_ff_shared, cfg.act, dtype)
    return params


def _experts_apply(experts, x: Tensor, act: str) -> Tensor:
    """Every expert's MLP at once: ``x`` [t, d] (the same tokens for each
    expert) or [E, C, d] (each expert its own buffer) -> [E, t or C, d]."""
    stacked = {k: v[:, None] if k.startswith("b_") else v for k, v in experts.items()}
    return mlp_apply(stacked, x, act)


def _route(params, x: Tensor, m: MoEConfig) -> Tuple[Tensor, Tensor, Tensor]:
    """(gates [t, top_k], idx [t, top_k], aux loss scalar) for flattened
    tokens ``x`` [t, d]."""
    logits = x.float() @ params["router"]["w"]
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps the lower index first on ties, as
    # jax.lax.top_k does (torch.topk promises no order among equals)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, :m.top_k], idx[:, :m.top_k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp(min=1e-9)
    # Switch-transformer load-balance loss: E * Σ_e f_e · p_e
    me = probs.mean(dim=0)
    ce = F.one_hot(idx[:, 0], m.n_experts).float().mean(dim=0)
    aux = m.n_experts * (me * ce).sum()
    return gates, idx, aux


def _moe_dense(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Oracle path: every expert sees every token, one-hot-masked combine."""
    m = cfg.moe
    gates, idx, aux = _route(params, x, m)
    # combine[t, e] = gate of expert e for token t (0 if not selected)
    combine = torch.zeros((x.shape[0], m.n_experts), dtype=torch.float32,
                          device=x.device).scatter(1, idx, gates)
    outs = _experts_apply(params["experts"], x, cfg.act)  # [E, t, d]
    y = torch.einsum("etd,te->td", outs.float(), combine)
    return y.to(x.dtype), aux


def _capacity(m: MoEConfig, tokens: int, n_local_experts: int) -> int:
    """Expert buffer size: ``capacity_factor · tokens · top_k / E``, at least
    4, rounded up to a multiple of 8 (the JAX package's rule)."""
    cap = max(int(m.capacity_factor * tokens * m.top_k / m.n_experts), 4)
    return ((cap + 7) // 8) * 8


def _dispatch_positions(e_onehot: Tensor, capacity: int) -> Tuple[Tensor, Tensor]:
    """(pos [t, K], keep [t, K]) of each routed (token, k) pair, given its
    expert one-hot ``e_onehot`` [t, K, E]: its place in its expert's buffer
    and whether that place is inside ``capacity``.  Priority: earlier tokens
    first, then k = 0 before k = 1 ... — a float cumsum of the one-hots, as
    in the JAX package, so the same pairs are dropped."""
    t, k, n_experts = e_onehot.shape
    flat = e_onehot.reshape(t * k, n_experts)
    pos = ((flat.cumsum(dim=0) - flat) * flat).sum(dim=-1).reshape(t, k).long()
    return pos, pos < capacity


def _moe_ep_capacity(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Capacity-based dispatch, x [t, d]: dispatch [t, E, C] one-hot, expert
    inputs [E, C, d] = dispatchᵀ x, y = combine · expert outputs."""
    m = cfg.moe
    t = x.shape[0]
    gates, idx, aux = _route(params, x, m)
    capacity = _capacity(m, t, m.n_experts)
    e_onehot = F.one_hot(idx, m.n_experts).float()  # [t, K, E]
    pos, keep = _dispatch_positions(e_onehot, capacity)
    gates = gates * keep.to(gates.dtype)
    # one_hot of a position past the capacity is all zeros (as jax.nn.one_hot)
    cap_onehot = F.one_hot(pos.clamp(max=capacity), capacity + 1)[..., :capacity].float()
    dispatch = torch.einsum("tke,tkc->tec", e_onehot, cap_onehot * keep[..., None])
    combine = torch.einsum("tke,tkc,tk->tec", e_onehot, cap_onehot, gates)
    xin = torch.einsum("tec,td->ecd", dispatch, x.float()).to(x.dtype)
    outs = _experts_apply(params["experts"], xin, cfg.act)  # [E, C, d]
    y = torch.einsum("tec,ecd->td", combine, outs.float())
    return y.to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert parallelism: sort-based dispatch and an all-to-all over "ep"
# ---------------------------------------------------------------------------


def _sort_positions(e_flat: Tensor, n_experts: int) -> Tensor:
    """Position (int32) of each routed (token, k) inside its expert's buffer:
    a stable argsort by expert, each expert's start an exclusive prefix of
    the counts (O(t·K log) time and O(t·K) memory, against the one-hot
    cumsum's O(t·K·E))."""
    tk = e_flat.shape[0]
    order = torch.sort(e_flat, stable=True).indices
    counts = torch.bincount(e_flat, minlength=n_experts)
    starts = counts.cumsum(0) - counts
    pos_sorted = torch.arange(tk, device=e_flat.device) - starts[e_flat[order]]
    pos = torch.empty(tk, dtype=torch.int32, device=e_flat.device)
    pos[order] = pos_sorted.to(torch.int32)
    return pos


def _quantize_rows(x: Tensor) -> Tuple[Tensor, Tensor]:
    """int8 payload and scales of ``x``: per row (last dim) absmax / 127 +
    1e-8 in x's dtype, rounded half to even, clipped to ±127."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-8
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


class _A2AInt8(torch.autograd.Function):
    """The all-to-all with an int8 payload and float32 scales beside it,
    dequantised into x's dtype; straight-through gradients, the backward
    exchange at full precision."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        q, scale = _quantize_rows(x)
        qr = col.all_to_all_values(q, split_dim, concat_dim, mesh, axis)
        sr = col.all_to_all_values(scale.float(), split_dim, concat_dim, mesh, axis)
        return qr.to(x.dtype) * sr.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return (col.all_to_all_values(g, concat_dim, split_dim, mesh, axis),
                None, None, None, None)


class _Int8RoundTrip(torch.autograd.Function):
    """``_A2AInt8`` without the exchange: what a row reads after it."""

    @staticmethod
    def forward(ctx, x):
        q, scale = _quantize_rows(x)
        return q.to(x.dtype) * scale.float().to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def _a2a_maybe_quant(x: Tensor, mesh, axis, split_dim: int, concat_dim: int,
                     quant: str) -> Tensor:
    """``collectives.all_to_all`` over ``axis``, with an int8 payload under
    ``quant="int8"`` (per-row absmax scales, straight-through gradients)."""
    if quant != "int8":
        return col.all_to_all(x, split_dim, concat_dim, mesh, axis)
    return _A2AInt8.apply(x, mesh, axis, split_dim, concat_dim)


def _e_pad(m: MoEConfig, ep_size: int) -> int:
    """The expert count padded to a multiple of the ep axis."""
    return -(-m.n_experts // ep_size) * ep_size


def _ep_plan(m: MoEConfig, tokens: int, d: int, ep_size: int) -> Tuple[int, int, int]:
    """(e_pad, chunks, capacity) for ``tokens`` local tokens: experts padded
    to a multiple of ``ep_size``; chunks so that a chunk's dispatch buffer
    (t_c · K · d floats) stays near 256 MB; the capacity of a chunk's
    tokens."""
    e_pad = _e_pad(m, ep_size)
    target = max(1, int(256e6 // (m.top_k * d * 4)))
    n_chunks = 1
    while tokens // n_chunks > target or tokens % n_chunks:
        n_chunks += 1
    return e_pad, n_chunks, _capacity(m, tokens // n_chunks, e_pad)


def _pad_experts(experts, e_pad: int):
    """Zero experts appended up to ``e_pad`` (never routed to)."""
    return {k: F.pad(v, (0, 0) * (v.dim() - 1) + (0, e_pad - v.shape[0])) if v.shape[0] < e_pad
            else v for k, v in experts.items()}


def _ep_chunk(x_c, idx_c, gates_c, experts, cfg, e_pad, cap, send, back):
    """One chunk: positions, the [e_pad, cap, d] buffers, ``send`` (to the
    ranks that hold the experts), the experts, ``back``, the gated combine
    in x's dtype."""
    k = cfg.moe.top_k
    tc, d = x_c.shape
    e_flat = idx_c.reshape(-1)
    pos = _sort_positions(e_flat, e_pad).long()
    keep = (pos < cap).to(x_c.dtype)
    pos_c = pos.clamp(max=cap - 1)
    src = x_c.repeat_interleave(k, dim=0) * keep[:, None]
    buf = torch.zeros((e_pad, cap, d), dtype=x_c.dtype, device=x_c.device)
    buf = buf.index_put((e_flat, pos_c), src, accumulate=True)
    h = _experts_apply(experts, send(buf), cfg.act)
    taken = back(h)[e_flat, pos_c] * (keep * gates_c.reshape(-1).to(x_c.dtype))[:, None]
    return taken.reshape(tc, k, d).sum(dim=1)


def _ep_rows(params, x: Tensor, cfg: ModelConfig, e_pad: int, n_chunks: int, cap: int,
             send, back) -> Tuple[Tensor, Tensor]:
    """One "data" shard's rows ``x`` [b, n, d]: route, then the chunk loop
    (each chunk recomputed in the backward, not saved).  ``params["experts"]``
    are the experts that ``send`` hands their buffers to.  Returns (y, the
    shard's aux loss)."""
    b, n, d = x.shape
    xf = x.reshape(-1, d)
    gates, idx, aux = _route(params, xf, cfg.moe)
    body = functools.partial(_ep_chunk, experts=params["experts"], cfg=cfg, e_pad=e_pad,
                             cap=cap, send=send, back=back)
    ys = []
    for x_c, i_c, g_c in zip(xf.chunk(n_chunks), idx.chunk(n_chunks), gates.chunk(n_chunks)):
        if torch.is_grad_enabled():
            ys.append(checkpoint(body, x_c, i_c, g_c, use_reentrant=False))
        else:
            ys.append(body(x_c, i_c, g_c))
    return torch.cat(ys).reshape(b, n, d), aux


def _moe_ep_a2a(params, x: Tensor, cfg: ModelConfig, mesh, dp, ep) -> Tuple[Tensor, Tensor]:
    """Expert parallelism on this rank's blocks (``distributed.spmd.moe_rows``
    gives them): ``x`` [b_loc, n, d] this "data" shard's rows (the same on
    every rank of ``ep``), ``params["router"]`` whole, ``params["experts"]``
    this rank's e_pad / ep experts, whole along the other dims.  Route,
    then per chunk: sort-based positions, [e_pad, cap, d] buffers, an
    all-to-all over ``ep`` (each rank keeps its experts' buffers from every
    rank: [e_loc, ep·cap, d]), the experts, the reverse all-to-all and the
    gated combine.  The aux loss is the shard's, averaged over ``dp``.
    Returns (y [b_loc, n, d], aux)."""
    m = cfg.moe
    b, n, d = x.shape
    e_pad, n_chunks, cap = _ep_plan(m, b * n, d, col.axis_size(mesh, ep))
    y, aux = _ep_rows(
        params, x, cfg, e_pad, n_chunks, cap,
        send=lambda buf: _a2a_maybe_quant(buf, mesh, ep, 0, 1, m.a2a_quant),
        back=lambda h: _a2a_maybe_quant(h, mesh, ep, 1, 0, m.a2a_quant))
    if dp:
        aux = col.all_reduce(aux, mesh, dp) / col.axis_size(mesh, dp)
    return y, aux


def _moe_ep_a2a_plain(params, x: Tensor, cfg: ModelConfig, dp_size: int,
                      ep_size: int) -> Tuple[Tensor, Tensor]:
    """The function ``_moe_ep_a2a`` computes on a mesh of ``dp_size`` ×
    ``ep_size``, on one device without collectives: whole ``x`` [b, n, d]
    and params; the same "data" shards (none where b does not divide),
    chunks, capacities, padding, int8 rounding and aux (each shard's,
    averaged); an ep axis of one rank is the global capacity path, as in
    the JAX package.  Returns (y, aux)."""
    m = cfg.moe
    b, n, d = x.shape
    if ep_size == 1:
        y, aux = _moe_ep_capacity(params, x.reshape(b * n, d), cfg)
        return y.reshape(b, n, d), aux
    if b % dp_size:
        dp_size = 1
    e_pad, n_chunks, cap = _ep_plan(m, (b // dp_size) * n, d, ep_size)
    trip = _Int8RoundTrip.apply if m.a2a_quant == "int8" else (lambda t: t)
    padded = dict(params, experts=_pad_experts(params["experts"], e_pad))
    ys, auxes = zip(*(_ep_rows(padded, xs, cfg, e_pad, n_chunks, cap, send=trip, back=trip)
                      for xs in x.chunk(dp_size)))
    return torch.cat(ys), torch.stack(auxes).mean()


def ep_a2a_drops(params, x: Tensor, cfg: ModelConfig, dp_size: int,
                 ep_size: int) -> Tuple[int, int]:
    """(routed pairs dropped, routed pairs) when ``_moe_ep_a2a`` on a mesh of
    ``dp_size`` × ``ep_size`` routes the whole ``x`` [b, n, d]: each "data"
    shard's chunks at their capacity (a host sync; for reports and tests)."""
    m = cfg.moe
    b, n, d = x.shape
    if b % dp_size or ep_size == 1:  # ep of one rank: the global capacity path
        dp_size = 1
    e_pad, n_chunks, cap = _ep_plan(m, (b // dp_size) * n, d, ep_size)
    if ep_size == 1:
        n_chunks, cap = 1, _capacity(m, b * n, m.n_experts)
    dropped = 0
    for xs in x.chunk(dp_size):
        _, idx, _ = _route(params, xs.reshape(-1, d), m)
        for ic in idx.chunk(n_chunks):
            dropped += int((_sort_positions(ic.reshape(-1), e_pad) >= cap).sum())
    return dropped, b * n * m.top_k


def _on_mesh() -> bool:
    return dist.active() is not None


@functools.lru_cache(maxsize=None)
def _shared_cfg(cfg: ModelConfig) -> ModelConfig:
    """The shared experts' MLP view of ``cfg`` (its hidden size as ``d_ff``)."""
    return cfg.replace(d_ff=cfg.moe.d_ff_shared)


def _mlp(p, h: Tensor, cfg: ModelConfig, positions) -> Tensor:
    return mlp_apply(p, h, cfg.act)


_WHOLE = {"dense": _moe_dense, "ep": _moe_ep_capacity, "ep_a2a": _moe_ep_capacity}


def moe_apply(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """x: [b, n, d] -> (y [b, n, d], aux loss scalar).

    ``cfg.moe.impl``: "dense" (the oracle), "ep" (capacity dispatch),
    "ep_a2a" (expert parallelism on a mesh; "ep" off one) and "auto"
    ("ep_a2a" on a mesh, "dense" off one), as in the JAX package.  Inside a
    ``distributed.spmd.region`` ``x`` is the residual stream's block:
    ``ep_a2a`` runs on the rank's rows and experts (``spmd.moe_rows``), the
    others on the whole batch (``spmd.moe_whole``); under an
    ``api.sharding_rules`` context alone the tensors are whole on every
    rank, and ``ep_a2a`` computes the mesh's function whole
    (``_moe_ep_a2a_plain``).  The shared experts run as a block's MLP
    (``spmd.site("mlp")``: their ``d_ff`` over "tp")."""
    m = cfg.moe
    b, n, d = x.shape
    impl = m.impl
    if impl == "auto":
        impl = "ep_a2a" if _on_mesh() else "dense"
    if impl == "ep_a2a" and not _on_mesh():
        impl = "ep"
    if impl not in _WHOLE:
        raise ValueError(f"unknown moe impl {m.impl!r}")
    routed = {"router": params["router"], "experts": params["experts"]}
    if spmd.in_region():
        ep_size = spmd.axis_size("ep")
        if impl == "ep_a2a" and ep_size > 1:
            y, aux = spmd.moe_rows(
                lambda p, xr, mesh, dp, ep: _moe_ep_a2a(p, xr, cfg, mesh, dp, ep), routed, x,
                functools.partial(_pad_experts, e_pad=_e_pad(m, ep_size)))
        else:
            y, aux = spmd.moe_whole(
                lambda p, xa: _WHOLE[impl](p, xa.reshape(-1, d), cfg), routed, x)
    elif impl == "ep_a2a":
        mesh, rules = dist.active()
        y, aux = _moe_ep_a2a_plain(routed, x, cfg, dist.mesh_axis_size(mesh, rules.get("dp")),
                                   dist.mesh_axis_size(mesh, rules.get("ep")))
    else:
        y, aux = _WHOLE[impl](routed, x.reshape(b * n, d), cfg)
    y = y.reshape(x.shape)
    if m.n_shared_experts:
        y = y + spmd.site("mlp", _mlp, params["shared"], x, _shared_cfg(cfg))
    return y, aux
