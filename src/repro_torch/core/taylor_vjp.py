"""Memory-optimal backward for chunked Taylor linear attention.

Autograd of the chunk loop in ``core/taylor.py`` would save the moment
state of every chunk: O(n/C · d²·d_v) residuals.  ``taylor_chunked_core``
is a ``torch.autograd.Function`` that saves only (q, k, v) and rebuilds the
states on the fly (FlashLinearAttention-style):

  * pass 1 (forward direction): recompute S_{<c} chunk by chunk; emit dq
    and the per-chunk cotangents of (num, den).
  * pass 2 (reverse direction): carry the accumulated future state
    gradient (dS*, dz*) backwards; emit dk, dv.

Residual memory: O(n·(d + d_v)) + two live states.  Compute: ≈2× forward.

This is the torch-side gradient oracle for the CUDA backward kernels
(``kernels/taylor_attention/csrc/taylor_bwd.cu`` computes the same two-pass
math), the backward of ``attn_impl="torch"`` training, and the trainable
kernel wrapper's backward outside the kernels' envelope.  It keeps
``_safe_div``'s sign-keeping clamp; the kernels clamp to +1e-6 (the two
differ only where |den| < 1e-6).

All math uses raw moments (scale factors applied at contraction time),
matching ``core/taylor.py``.  q, k must already be LayerNorm'd.

Spans (``repro_torch.spans``): ``attention.scan`` around the chunked
forward (a remat rerun included) and ``attention.scan.bwd`` around the two
passes.
"""

from __future__ import annotations

from typing import List

import torch

from repro_torch import spans
from repro_torch.core.feature_map import TaylorConfig, poly_scores
from repro_torch.core.taylor import (
    TaylorState,
    _chunk_inter,
    _safe_div,
    _state_update,
    chunked_num_den,
    init_taylor_state,
)

Tensor = torch.Tensor

_VJP_TILE = 8  # d-axis tile bounding backward transients


def _poly_deriv(s: Tensor, cfg: TaylorConfig) -> Tensor:
    """d/ds of the truncated exponential: order1 -> 1;  order2 -> 1 + s."""
    if cfg.order >= 2:
        return 1.0 + s
    return torch.ones_like(s)


def _tiles(d: int):
    t = _VJP_TILE if d % _VJP_TILE == 0 else d
    return [(t0, t) for t0 in range(0, d, t)]


def _dq_quad(qc32: Tensor, dnum: Tensor, s2: Tensor, half_a2: float) -> Tensor:
    """2·(a²/2)·Σ_{e,v} q_e S2[d,e,v] dnum_v, d-tiled (no [*,c,d,v] temp)."""
    parts = []
    for t0, t in _tiles(qc32.shape[-1]):
        s2t = s2[:, :, t0 : t0 + t]  # [b,k,T,e,v]
        w = torch.einsum("bkgiv,bktev->bkgite", dnum, s2t)
        parts.append(torch.einsum("bkgite,bkgie->bkgit", w, qc32))
    return (2.0 * half_a2) * torch.cat(parts, dim=-1)


def _dk_dv_from_ds2(kc32: Tensor, vc32: Tensor, ds2: Tensor):
    """Gradients of the update S2 += k⊗k⊗v given dS2 (symmetric), d-tiled."""
    dk_parts = []
    dv = None
    for t0, t in _tiles(kc32.shape[-1]):
        s2t = ds2[:, :, t0 : t0 + t]  # [b,k,T,e,v]
        w = torch.einsum("bkjv,bktev->bkjte", vc32, s2t)
        dk_parts.append(2.0 * torch.einsum("bkje,bkjte->bkjt", kc32, w))
        w2 = torch.einsum("bkje,bktev->bkjtv", kc32, s2t)
        part = torch.einsum("bkjt,bkjtv->bkjv", kc32[..., t0 : t0 + t], w2)
        dv = part if dv is None else dv + part
    return torch.cat(dk_parts, dim=-1), dv


def _ds2_accum(qc32: Tensor, dnum: Tensor, half_a2: float) -> Tensor:
    """half_a2 · Σ_{g,i} q⊗q⊗dnum -> [b,k,d,e,v], d-tiled."""
    parts = []
    for t0, t in _tiles(qc32.shape[-1]):
        parts.append(half_a2 * torch.einsum(
            "bkgct,bkgce,bkgcv->bktev", qc32[..., t0 : t0 + t], qc32, dnum
        ))
    return torch.cat(parts, dim=2)


def _chunks(q: Tensor, k: Tensor, v: Tensor, chunk: int):
    """Chunk-major views: qs [nc,b,hk,g,c,d], ks/vs [nc,b,hk,c,·]."""
    b, hk, g, n, d = q.shape
    if n % chunk:
        raise ValueError(f"seq len {n} not a multiple of chunk {chunk}")
    nc = n // chunk
    qs = q.reshape(b, hk, g, nc, chunk, d).movedim(3, 0)
    ks = k.reshape(b, hk, nc, chunk, d).movedim(2, 0)
    vs = v.reshape(b, hk, nc, chunk, v.shape[-1]).movedim(2, 0)
    return qs, ks, vs, nc


def _forward(q: Tensor, k: Tensor, v: Tensor, cfg: TaylorConfig, chunk: int) -> Tensor:
    """The chunked forward: out [b, hk, g, n, dv] in v's dtype."""
    b, hk, g, n, d = q.shape
    dv = v.shape[-1]
    qs, ks, vs, _ = _chunks(q, k, v, chunk)
    state0 = init_taylor_state(b, hk, d, dv, cfg, device=q.device)
    nums, dens, _ = chunked_num_den(qs, ks, vs, cfg, state0)
    nums = nums.movedim(0, 3).reshape(b, hk, g, n, dv)
    dens = dens.movedim(0, 3).reshape(b, hk, g, n)
    return _safe_div(nums, dens).to(v.dtype)


def _bwd_rule(cfg: TaylorConfig, chunk: int, q: Tensor, k: Tensor, v: Tensor,
              dout: Tensor):
    """(dq, dk, dv) of ``_forward`` by two passes over the chunks."""
    b, hk, g, n, d = q.shape
    dv = v.shape[-1]
    a = cfg.scale(d)
    half_a2 = 0.5 * a * a
    c0 = 0.0 if cfg.minus_one else 1.0
    qs, ks, vs, nc = _chunks(q, k, v, chunk)
    dos = dout.float().reshape(b, hk, g, nc, chunk, dv).movedim(3, 0)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=q.device).tril()

    # ---- pass 1: forward recompute.  emits dq + per-chunk dnum/dden. ----
    state = init_taylor_state(b, hk, d, dv, cfg, device=q.device)
    dqs: List[Tensor] = []
    dnums: List[Tensor] = []
    ddens: List[Tensor] = []
    for qc, kc, vc, doc in zip(qs, ks, vs, dos):
        qc32, kc32, vc32 = qc.float(), kc.float(), vc.float()
        s = torch.einsum("bkgid,bkjd->bkgij", qc32, kc32) * a
        p = torch.where(mask, poly_scores(s, cfg), 0.0)
        num = torch.einsum("bkgij,bkjv->bkgiv", p, vc32)
        den = p.sum(dim=-1)
        inum, iden = _chunk_inter(qc, state, cfg, a)
        num, den = num + inum, den + iden
        small = torch.where(den < 0, -1e-6, 1e-6)  # sign-keeping clamp
        den = torch.where(den.abs() < 1e-6, small, den)
        o = num / den[..., None]
        dnum = doc / den[..., None]
        dden = -(doc * o).sum(dim=-1) / den

        # intra-chunk gradients
        dp = torch.einsum("bkgiv,bkjv->bkgij", dnum, vc32) + dden[..., None]
        ds = torch.where(mask, dp * _poly_deriv(s, cfg), 0.0) * a
        dq_c = torch.einsum("bkgij,bkjd->bkgid", ds, kc32)

        # inter-chunk gradients w.r.t. q (state S_{<c} is a constant here)
        dq_c = dq_c + a * torch.einsum("bkgiv,bkdv->bkgid", dnum, state.s1)
        dq_c = dq_c + a * dden[..., None] * state.z1[:, :, None, None, :]
        if cfg.order >= 2:
            dq_c = dq_c + _dq_quad(qc32, dnum, state.s2, half_a2)
            qz2 = torch.einsum("bkgie,bkde->bkgid", qc32, state.z2)
            dq_c = dq_c + (2.0 * half_a2) * dden[..., None] * qz2

        state = _state_update(state, kc, vc, cfg)
        dqs.append(dq_c)
        dnums.append(dnum)
        ddens.append(dden)

    # ---- pass 2: reverse.  carry future state-gradients; emit dk, dv. ----
    dstate = init_taylor_state(b, hk, d, dv, cfg, device=q.device)  # zeros
    dks: List[Tensor] = [None] * nc
    dvs: List[Tensor] = [None] * nc
    for c in reversed(range(nc)):
        qc32, kc32, vc32 = qs[c].float(), ks[c].float(), vs[c].float()
        dnum, dden = dnums[c], ddens[c]
        s = torch.einsum("bkgid,bkjd->bkgij", qc32, kc32) * a
        p = torch.where(mask, poly_scores(s, cfg), 0.0)
        dp = torch.einsum("bkgiv,bkjv->bkgij", dnum, vc32) + dden[..., None]
        ds = torch.where(mask, dp * _poly_deriv(s, cfg), 0.0) * a
        # intra
        dk_c = torch.einsum("bkgij,bkgid->bkjd", ds, qc32)
        dv_c = torch.einsum("bkgij,bkgiv->bkjv", p, dnum)
        # from future chunks' state use: S1 += kᵀv ; z1 += k ; s0 += v ; etc.
        dv_c = dv_c + c0 * dstate.s0[:, :, None, :]
        dv_c = dv_c + torch.einsum("bkjd,bkdv->bkjv", kc32, dstate.s1)
        dk_c = dk_c + torch.einsum("bkjv,bkdv->bkjd", vc32, dstate.s1)
        dk_c = dk_c + dstate.z1[:, :, None, :]
        if cfg.order >= 2:
            dk_s2, dv_s2 = _dk_dv_from_ds2(kc32, vc32, dstate.s2)
            dk_c = dk_c + dk_s2
            dv_c = dv_c + dv_s2
            dk_c = dk_c + 2.0 * torch.einsum("bkje,bkde->bkjd", kc32, dstate.z2)
        dks[c], dvs[c] = dk_c, dv_c

        # accumulate THIS chunk's contribution to the state gradient (the
        # inter-chunk read used S_{<c}: its gradient flows to earlier chunks)
        z2, s2 = dstate.z2, dstate.s2
        if cfg.order >= 2:
            z2 = z2 + half_a2 * torch.einsum("bkgi,bkgid,bkgie->bkde", dden, qc32, qc32)
            s2 = s2 + _ds2_accum(qc32, dnum, half_a2)
        dstate = TaylorState(
            n0=dstate.n0,
            s0=dstate.s0 + c0 * dnum.sum(dim=(2, 3)),
            z1=dstate.z1 + a * torch.einsum("bkgi,bkgid->bkd", dden, qc32),
            s1=dstate.s1 + a * torch.einsum("bkgid,bkgiv->bkdv", qc32, dnum),
            z2=z2,
            s2=s2,
        )

    dq = torch.stack(dqs).movedim(0, 3).reshape(b, hk, g, n, d).to(q.dtype)
    dk = torch.stack(dks).movedim(0, 2).reshape(b, hk, n, d).to(k.dtype)
    dv_ = torch.stack(dvs).movedim(0, 2).reshape(b, hk, n, dv).to(v.dtype)
    return dq, dk, dv_


class _ChunkedCore(torch.autograd.Function):
    """Custom-gradient chunked attention; residuals are (q, k, v) only."""

    @staticmethod
    def forward(ctx, q, k, v, cfg, chunk):
        ctx.cfg, ctx.chunk = cfg, chunk
        ctx.save_for_backward(q, k, v)
        with spans.span("attention.scan"):
            return _forward(q, k, v, cfg, chunk)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        with spans.span("attention.scan.bwd"):
            dq, dk, dv = _bwd_rule(ctx.cfg, ctx.chunk, q, k, v, dout)
        return dq, dk, dv, None, None


def taylor_chunked_core(q: Tensor, k: Tensor, v: Tensor, cfg: TaylorConfig,
                        chunk: int) -> Tensor:
    """Causal chunked Taylor attention on PRE-NORMALISED q/k.

    Args:
      q: grouped queries ``[b, hk, g, n, d]``.
      k: keys ``[b, hk, n, d]``.
      v: values ``[b, hk, n, dv]``.
      cfg: Taylor config (decay 1, full second moment).
      chunk: sequence chunk; must divide n.

    Returns:
      ``out [b, hk, g, n, dv]`` in v's dtype, differentiable w.r.t. q, k
      and v through the two-pass recompute backward (``_bwd_rule``).
    """
    return _ChunkedCore.apply(q, k, v, cfg, chunk)
