"""Mixture-of-Experts FFN (the JAX package's ``models/moe.py``).

Two single-device dispatch paths behind one API:

  * ``dense`` — every expert sees every token, combined through one-hot
    gate weights: exact but O(tokens · E · d · ff); the oracle.
  * ``ep``    — fixed expert capacity (GShard-style, sort-free: a cumsum of
    one-hots gives each routed (token, k) its place in its expert's
    buffer), dispatch and combine as einsums; routed pairs past the
    capacity are dropped.  O(tokens · top_k · capacity_factor · d · ff).

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

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig, MoEConfig
from repro_torch.models.layers import dense_init, mlp_apply, mlp_init

Tensor = torch.Tensor


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    m = cfg.moe
    d = cfg.d_model
    experts = [mlp_init(gen, d, m.d_ff_expert, cfg.act, dtype) for _ in range(m.n_experts)]
    params = {
        "router": dense_init(gen, (d, m.n_experts), dtype=torch.float32),
        "experts": {k: torch.stack([e[k] for e in experts]) for k in experts[0]},
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


def moe_apply(params, x: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """x: [b, n, d] -> (y [b, n, d], aux loss scalar).

    ``cfg.moe.impl``: "dense" (the oracle), "ep" (capacity dispatch), and
    without a mesh — the only case ported — "auto" runs "dense" and
    "ep_a2a" runs "ep", as in the JAX package."""
    m = cfg.moe
    b, n, d = x.shape
    impl = {"auto": "dense", "ep_a2a": "ep"}.get(m.impl, m.impl)
    if impl == "dense":
        y, aux = _moe_dense(params, x.reshape(b * n, d), cfg)
    elif impl == "ep":
        y, aux = _moe_ep_capacity(params, x.reshape(b * n, d), cfg)
    else:
        raise ValueError(f"unknown moe impl {m.impl!r}")
    y = y.reshape(b, n, d)
    if m.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg.act)
    return y, aux
