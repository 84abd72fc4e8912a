"""Higher-order (Taylor) linear attention — the paper's core contribution.

``softmax(QKᵀ/(α√d))V`` approximated with the order-2 Taylor expansion of
exp, re-associated for linear complexity.  Three exact-equivalent modes:

  * ``parallel``  — materialises the n×n polynomial score matrix.  O(n²d).
  * ``chunked``   — chunks of C tokens: a quadratic C×C tile inside each
    chunk, and constant-size moment state (S0, S1, S2, z*) between chunks.
    The hand-written CUDA kernel (``repro_torch.kernels.taylor_attention``)
    computes this form on the card.
  * ``recurrent`` — token-level RNN; the decode path.  O(1) state per step.

Plus ``noncausal``: one global state over all keys, for encoder and cross
attention.  All modes support GQA: q is [b, h, n, d]; k, v are
[b, h_kv, n, d] with ``h % h_kv == 0``.  The moment state depends only on
K/V and is therefore per kv-head.  Every contraction runs in float32
whatever the input dtype.

The variants of ``TaylorConfig``: ``decay < 1`` weights token j's
contribution at position i by ``γ_h^(i-j)`` (causal modes only);
``sym_state`` keeps z2/s2 packed in the ``symvec`` basis, [d(d+1)/2(, v)]
instead of [d, d(, v)].  Both run the scan with autograd in training; the
custom recompute backward (``core/taylor_vjp.py``) and the CUDA kernels
serve the undecayed, full-moment form only.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch.core.feature_map import (
    TaylorConfig,
    layernorm_no_affine,
    poly_scores,
    symvec,
)

Tensor = torch.Tensor


class TaylorState(NamedTuple):
    """Running moments of the Taylor-linear attention (per batch, kv-head).

    Shapes (b = batch, k = kv heads, d = qk head dim, v = value head dim):
      n0: [b, k]           token count (denominator constant term)
      s0: [b, k, v]        Σ_j v_j
      z1: [b, k, d]        Σ_j k_j
      s1: [b, k, d, v]     Σ_j k_j ⊗ v_j
      z2: [b, k, d, d]     Σ_j k_j ⊗ k_j
      s2: [b, k, d, d, v]  Σ_j k_j ⊗ k_j ⊗ v_j

    With ``sym_state`` z2/s2 are [b, k, D2] / [b, k, D2, v], D2 = d(d+1)/2
    (the ``symvec`` basis).  z2/s2 are ``None`` for order-1 configs.
    """

    n0: Tensor
    s0: Tensor
    z1: Tensor
    s1: Tensor
    z2: Optional[Tensor]
    s2: Optional[Tensor]


def init_taylor_state(
    batch: int,
    kv_heads: int,
    d: int,
    d_v: int,
    cfg: TaylorConfig,
    device=None,
) -> TaylorState:
    """Zero float32 state for prefill/decode (``device``: torch's default
    when None).  With ``cfg.sym_state`` the second moments are packed:
    [d(d+1)/2(, d_v)] instead of [d, d(, d_v)] — half the decode state."""
    z = lambda *s: torch.zeros(s, dtype=torch.float32, device=device)
    second = cfg.order >= 2
    quad = ((d * (d + 1)) // 2,) if cfg.sym_state else (d, d)
    return TaylorState(
        n0=z(batch, kv_heads),
        s0=z(batch, kv_heads, d_v),
        z1=z(batch, kv_heads, d),
        s1=z(batch, kv_heads, d, d_v),
        z2=z(batch, kv_heads, *quad) if second else None,
        s2=z(batch, kv_heads, *quad, d_v) if second else None,
    )


def _norm_qk(q: Tensor, k: Tensor, cfg: TaylorConfig):
    if cfg.normalize_qk:
        q = layernorm_no_affine(q).to(q.dtype)
        k = layernorm_no_affine(k).to(k.dtype)
    return q, k


def _group(q: Tensor, h_kv: int) -> Tensor:
    """[b, h, n, d] -> [b, h_kv, g, n, d]."""
    b, h, n, d = q.shape
    if h % h_kv:
        raise ValueError(f"q heads {h} not divisible by kv heads {h_kv}")
    return q.reshape(b, h_kv, h // h_kv, n, d)


def _ungroup(o: Tensor) -> Tensor:
    """[b, h_kv, g, n, v] -> [b, h, n, v]."""
    b, hk, g, n, v = o.shape
    return o.reshape(b, hk * g, n, v)


def _safe_div(num: Tensor, den: Tensor, eps: float = 1e-6) -> Tensor:
    """num / den with |den| clamped at eps, keeping den's sign."""
    den = den.float()
    small = torch.where(den < 0, -eps, eps)
    den = torch.where(den.abs() < eps, small, den)
    return num / den[..., None]


def decay_gammas(h_kv: int, decay: float, device=None) -> Tensor:
    """Per-kv-head decay rates from the single ``TaylorConfig.decay`` scalar.

    Geometric spread ``γ_h = decay^((h+1)/h_kv)`` for ``h = 0..h_kv-1``
    (ALiBi-slope style): the last head decays at exactly ``decay``, earlier
    heads progressively slower.  With ``h_kv == 1`` this is ``[decay]``.

    Returns:
      ``[h_kv]`` float32 rates.
    """
    h = torch.arange(1, h_kv + 1, dtype=torch.float32, device=device)
    return torch.tensor(decay, dtype=torch.float32, device=device) ** (h / h_kv)


def _lag_weights(g_h: Tensor, c: int) -> Tensor:
    """``γ_h^(i-j)`` for i, j < c, 0 where j > i: [hk, c, c].  (The exponent
    is clamped at 0 above the diagonal, where γ^(i-j) would overflow.)"""
    idx = torch.arange(c, dtype=torch.float32, device=g_h.device)
    delta = (idx[:, None] - idx[None, :]).clamp(min=0.0)
    return g_h[:, None, None] ** delta


# ---------------------------------------------------------------------------
# Parallel (quadratic) reference mode.
# ---------------------------------------------------------------------------


def taylor_attention_parallel(
    q: Tensor, k: Tensor, v: Tensor, cfg: TaylorConfig, causal: bool = True
) -> Tensor:
    """Reference O(n²) evaluation of the Taylor-approximated attention."""
    b, h, n, d = q.shape
    h_kv = k.shape[1]
    q, k = _norm_qk(q, k, cfg)
    qg = _group(q, h_kv).float()
    a = cfg.scale(d)
    s = torch.einsum("bkgid,bkjd->bkgij", qg, k.float()) * a
    p = poly_scores(s, cfg)
    if causal:
        mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
        p = torch.where(mask, p, 0.0)
    if cfg.decay != 1.0:
        if not causal:
            raise ValueError("taylor decay is causal-self-attention only")
        w = _lag_weights(decay_gammas(h_kv, cfg.decay, q.device), n)  # [hk, n, n]
        p = p * w[None, :, None]
    num = torch.einsum("bkgij,bkjv->bkgiv", p, v.float())
    den = p.sum(dim=-1)
    return _ungroup(_safe_div(num, den)).to(v.dtype)


# ---------------------------------------------------------------------------
# Chunked mode.
# ---------------------------------------------------------------------------


_QUAD_TILE = 32  # first-axis tile of S2 contractions (bounds transients)


def _quad_num(qg: Tensor, s2: Tensor, half_a2: float) -> Tensor:
    """(a²/2)·(q ⊗ q)·S2 without materialising a [*, c, d, d_v] temp.

    qg: [b, k, g, c, d] float32; s2: [b, k, d, d, v].  Tiles the first
    moment axis so the transient is [*, c, T·d]."""
    b, hk, d, _, dv = s2.shape
    t = _QUAD_TILE if d % _QUAD_TILE == 0 else d
    acc = None
    for t0 in range(0, d, t):
        qq = (qg[..., t0 : t0 + t, None] * qg[..., None, :]).reshape(
            qg.shape[:-1] + (t * d,)
        )
        s2t = s2[:, :, t0 : t0 + t].reshape(b, hk, t * d, dv)
        part = torch.einsum("bkgcf,bkfv->bkgcv", qq, s2t)
        acc = part if acc is None else acc + part
    return half_a2 * acc


def _chunk_inter(qg: Tensor, state: TaylorState, cfg: TaylorConfig, a: float):
    """Contribution of all previous chunks to (num, den) for query block qg.

    qg: [b, k, g, c, d].  Returns num [b,k,g,c,v], den [b,k,g,c] (float32).
    A ``sym_state`` state is read in the ``symvec`` basis, whose dot
    products are the same (q·k)².
    """
    qg = qg.float()
    num = a * torch.einsum("bkgcd,bkdv->bkgcv", qg, state.s1)
    den = a * torch.einsum("bkgcd,bkd->bkgc", qg, state.z1)
    if not cfg.minus_one:
        num = num + state.s0[:, :, None, None, :]
        den = den + state.n0[:, :, None, None]
    if cfg.order >= 2:
        half_a2 = 0.5 * a * a
        if cfg.sym_state:
            phi2 = symvec(qg)  # [b, k, g, c, D2]
            num = num + half_a2 * torch.einsum("bkgcf,bkfv->bkgcv", phi2, state.s2)
            den = den + half_a2 * torch.einsum("bkgcf,bkf->bkgc", phi2, state.z2)
        else:
            num = num + _quad_num(qg, state.s2, half_a2)
            u = torch.einsum("bkgcd,bkde->bkgce", qg, state.z2)
            den = den + half_a2 * (qg * u).sum(dim=-1)
    return num, den


def _state_update(
    state: TaylorState, kc: Tensor, vc: Tensor, cfg: TaylorConfig
) -> TaylorState:
    """Accumulate one chunk of keys/values into the moment state.

    kc: [b, k, c, d], vc: [b, k, c, v].  Returns a new state (functional).

    With ``cfg.decay != 1`` the sums are decayed: the old state is carried
    with ``γ^c`` and local token j enters with weight ``γ^(c-1-j)``, so the
    result is the state as of the chunk's last token.  Each weight is
    applied once per moment (into v for s0/s1/s2, into k for z1, into the
    k⊗k product for z2).  ``decay == 1`` runs the undecayed code unchanged.
    """
    kc32 = kc.float()
    vc32 = vc.float()
    c = kc.shape[2]
    if cfg.decay != 1.0:
        g_h = decay_gammas(kc.shape[1], cfg.decay, kc.device)  # [hk]
        idx = torch.arange(c - 1, -1, -1, dtype=torch.float32, device=kc.device)
        w = g_h[:, None] ** idx[None, :]  # [hk, c]
        carry = (g_h ** c)[None, :]  # [1, hk]
        vw = vc32 * w[None, :, :, None]
        kw = kc32 * w[None, :, :, None]
        tok = w.sum(dim=1)[None, :]
        old = lambda x, nd: x * carry.reshape(carry.shape + (1,) * nd)
    else:
        vw, kw, tok = vc32, kc32, c
        old = lambda x, nd: x
    n0 = old(state.n0, 0) + tok
    s0 = old(state.s0, 1) + vw.sum(dim=2)
    z1 = old(state.z1, 1) + kw.sum(dim=2)
    s1 = old(state.s1, 2) + torch.einsum("bkcd,bkcv->bkdv", kc32, vw)
    z2, s2 = state.z2, state.s2
    if cfg.order >= 2 and cfg.sym_state:
        phi2 = symvec(kc32)  # [b, k, c, D2]
        phi2w = phi2 if cfg.decay == 1.0 else phi2 * w[None, :, :, None]
        z2 = old(state.z2, 1) + phi2w.sum(dim=2)
        s2 = old(state.s2, 2) + torch.einsum("bkcf,bkcv->bkfv", phi2, vw)
    elif cfg.order >= 2:
        z2 = old(state.z2, 2) + torch.einsum("bkcd,bkce->bkde", kw, kc32)
        # d-tiled: a direct 3-operand product materialises [b,k,c,d,d]
        b, hk, _, d = kc.shape
        t = _QUAD_TILE if d % _QUAD_TILE == 0 else d
        parts = []
        for t0 in range(0, d, t):
            kk = (kc32[..., t0 : t0 + t, None] * kc32[..., None, :]).reshape(
                b, hk, c, t * d
            )
            parts.append(
                torch.einsum("bkcf,bkcv->bkfv", kk, vw).reshape(
                    b, hk, t, d, vc.shape[-1]
                )
            )
        s2 = old(state.s2, 3) + torch.cat(parts, dim=2)
    return TaylorState(n0=n0, s0=s0, z1=z1, s1=s1, z2=z2, s2=s2)


def taylor_attention_chunked(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    cfg: TaylorConfig,
    chunk: int = 128,
    initial_state: Optional[TaylorState] = None,
    return_state: bool = False,
):
    """Causal Taylor linear attention via a chunk-level scan (exact).

    The sequence length must be a multiple of ``chunk``.  Returns
    out [b, h, n, v] (and the final TaylorState if requested — the
    prefill→decode handoff).  Without a state in or out, and for the
    undecayed full-moment form, the output's gradient is the two-pass
    recompute of ``core/taylor_vjp.py``, which keeps O(n·d) residuals;
    decayed and ``sym_state`` runs differentiate through the scan."""
    b, h, n, d = q.shape
    h_kv = k.shape[1]
    d_v = v.shape[-1]
    if n % chunk != 0:
        raise ValueError(f"seq len {n} not a multiple of chunk {chunk}")
    nc = n // chunk
    q, k = _norm_qk(q, k, cfg)
    qg = _group(q, h_kv)  # [b, hk, g, n, d]
    g = qg.shape[2]
    if (
        initial_state is None
        and not return_state
        and not cfg.sym_state
        and cfg.decay == 1.0
    ):
        # Training/eval: the custom backward saves only (q, k, v) instead of
        # every chunk's state (it is written for the undecayed full moment).
        from repro_torch.core.taylor_vjp import taylor_chunked_core  # noqa: PLC0415 (cycle)

        return _ungroup(taylor_chunked_core(qg, k, v, cfg, chunk)).to(v.dtype)
    # chunk-major layout for the scan: [nc, b, hk, (g,) c, ...]
    qs = qg.reshape(b, h_kv, g, nc, chunk, d).movedim(3, 0)
    ks = k.reshape(b, h_kv, nc, chunk, d).movedim(2, 0)
    vs = v.reshape(b, h_kv, nc, chunk, d_v).movedim(2, 0)
    state0 = initial_state
    if state0 is None:
        state0 = init_taylor_state(b, h_kv, d, d_v, cfg, device=q.device)
    nums, dens, final_state = chunked_num_den(qs, ks, vs, cfg, state0)
    # [nc, b, hk, g, c, v] -> [b, hk, g, n, v]
    nums = nums.movedim(0, 3).reshape(b, h_kv, g, n, d_v)
    dens = dens.movedim(0, 3).reshape(b, h_kv, g, n)
    out = _ungroup(_safe_div(nums, dens)).to(v.dtype)
    if return_state:
        return out, final_state
    return out


def chunked_num_den(qs, ks, vs, cfg: TaylorConfig, state0: TaylorState):
    """Scan over chunk-major (qs [nc,b,hk,g,c,d]; ks/vs [nc,b,hk,c,·]).

    Returns unnormalised (nums, dens, final_state)."""
    chunk = qs.shape[4]
    d = qs.shape[-1]
    a = cfg.scale(d)
    mask = torch.ones((chunk, chunk), dtype=torch.bool, device=qs.device).tril()
    if cfg.decay != 1.0:
        # intra-chunk pair weight γ^(i-j); inter-chunk scale γ^(i+1) lifts
        # the carried state (as of the previous chunk's last token) to each
        # local query position i.
        g_h = decay_gammas(qs.shape[2], cfg.decay, qs.device)  # [hk]
        w_intra = _lag_weights(g_h, chunk)  # [hk, c, c]
        lift = torch.arange(1, chunk + 1, dtype=torch.float32, device=qs.device)
        w_inter = g_h[:, None] ** lift[None, :]  # [hk, c]
    state = state0
    nums, dens = [], []
    for qc, kc, vc in zip(qs, ks, vs):
        s = torch.einsum("bkgid,bkjd->bkgij", qc.float(), kc.float()) * a
        p = torch.where(mask, poly_scores(s, cfg), 0.0)
        if cfg.decay != 1.0:
            p = p * w_intra[None, :, None]
        num = torch.einsum("bkgij,bkjv->bkgiv", p, vc.float())
        den = p.sum(dim=-1)
        inum, iden = _chunk_inter(qc, state, cfg, a)
        if cfg.decay != 1.0:
            inum = inum * w_inter[None, :, None, :, None]
            iden = iden * w_inter[None, :, None, :]
        state = _state_update(state, kc, vc, cfg)
        nums.append(num + inum)
        dens.append(den + iden)
    return torch.stack(nums), torch.stack(dens), state


# ---------------------------------------------------------------------------
# Non-causal / cross-attention mode: one global state, single pass.
# ---------------------------------------------------------------------------


def taylor_attention_noncausal(
    q: Tensor, k: Tensor, v: Tensor, cfg: TaylorConfig, chunk: int = 128
) -> Tensor:
    """Encoder / cross attention: every query sees every key.

    O(n·d²·d_v) with a single global moment state.  Queries are read chunk
    by chunk, which bounds the S2 read's transient to one chunk's
    [b, hk, g, chunk, T·d].  q: [b, h, nq, d]; k, v: [b, h_kv, nk, d/v].
    """
    b, h, nq, d = q.shape
    h_kv = k.shape[1]
    d_v = v.shape[-1]
    if cfg.decay != 1.0:
        raise ValueError(
            "taylor decay is causal-self-attention only (a position-decayed "
            "global source state is ill-defined)"
        )
    q, k = _norm_qk(q, k, cfg)
    a = cfg.scale(d)
    qg = _group(q, h_kv)  # [b, hk, g, nq, d]
    state = init_taylor_state(b, h_kv, d, d_v, cfg, device=q.device)
    state = _state_update(state, k, v, cfg)
    if nq % chunk != 0 or nq <= chunk:
        num, den = _chunk_inter(qg, state, cfg, a)
        return _ungroup(_safe_div(num, den)).to(v.dtype)
    outs = []
    for qc in qg.split(chunk, dim=3):
        num, den = _chunk_inter(qc, state, cfg, a)
        outs.append(_safe_div(num, den))
    return _ungroup(torch.cat(outs, dim=3)).to(v.dtype)


# ---------------------------------------------------------------------------
# Recurrent mode — decoding.
# ---------------------------------------------------------------------------


def taylor_decode_step(
    state: TaylorState,
    q_t: Tensor,
    k_t: Tensor,
    v_t: Tensor,
    cfg: TaylorConfig,
):
    """One autoregressive step.

    q_t: [b, h, d]; k_t: [b, h_kv, d]; v_t: [b, h_kv, v].
    Returns (out_t [b, h, v], new_state).  The new token attends to itself,
    so the state is updated *before* the read (inclusive causal semantics).
    """
    b, h, d = q_t.shape
    h_kv = k_t.shape[1]
    if cfg.normalize_qk:
        q_t = layernorm_no_affine(q_t).to(q_t.dtype)
        k_t = layernorm_no_affine(k_t).to(k_t.dtype)
    state = _state_update(state, k_t[:, :, None, :], v_t[:, :, None, :], cfg)
    qg = q_t.reshape(b, h_kv, h // h_kv, 1, d)
    num, den = _chunk_inter(qg, state, cfg, cfg.scale(d))
    out = _safe_div(num, den)[:, :, :, 0, :]  # [b, hk, g, v]
    return out.reshape(b, h, v_t.shape[-1]).to(v_t.dtype), state


def taylor_attention_recurrent(
    q: Tensor, k: Tensor, v: Tensor, cfg: TaylorConfig
) -> Tensor:
    """Token-level RNN evaluation (test oracle for the decode path)."""
    b, h, n, d = q.shape
    h_kv = k.shape[1]
    q, k = _norm_qk(q, k, cfg)
    step_cfg = dataclasses.replace(cfg, normalize_qk=False)
    state = init_taylor_state(b, h_kv, d, v.shape[-1], cfg, device=q.device)
    outs = []
    for t in range(n):
        out_t, state = taylor_decode_step(
            state, q[:, :, t], k[:, :, t], v[:, :, t], step_cfg
        )
        outs.append(out_t)
    return torch.stack(outs, dim=2)  # [b, h, n, v]


# ---------------------------------------------------------------------------
# Public state helpers.
# ---------------------------------------------------------------------------


def taylor_prefill_state(
    k: Tensor, v: Tensor, cfg: TaylorConfig, state: Optional[TaylorState] = None
) -> TaylorState:
    """Moment state of a key/value sequence in one shot (no output pass).

    k: raw keys [b, hk, n, d] (normalised here per ``cfg.normalize_qk``);
    v: [b, hk, n, d_v].  Accumulates onto ``state`` (default zeros)."""
    _, kn = _norm_qk(k, k, cfg)
    if state is None:
        state = init_taylor_state(
            k.shape[0], k.shape[1], k.shape[-1], v.shape[-1], cfg, device=k.device
        )
    return _state_update(state, kn, v, cfg)


def taylor_state_read(state: TaylorState, q_t: Tensor, cfg: TaylorConfig) -> Tensor:
    """Read one token's output from a FIXED moment state (no update).

    q_t: [b, h, d].  Returns [b, h, d_v] float32."""
    b, h, d = q_t.shape
    hk = state.z1.shape[1]
    if cfg.normalize_qk:
        q_t = layernorm_no_affine(q_t).to(q_t.dtype)
    qg = q_t.reshape(b, hk, h // hk, 1, d)
    num, den = _chunk_inter(qg, state, cfg, cfg.scale(d))
    return _safe_div(num, den)[:, :, :, 0, :].reshape(b, h, -1)


def merge_states(a: TaylorState, b: TaylorState) -> TaylorState:
    """States are prefix sums, so merging two consecutive shards is addition
    (undecayed states only: a decayed merge would discount the first shard
    by γ^len of the second)."""
    add = lambda x, y: None if x is None else x + y
    return TaylorState(*(add(x, y) for x, y in zip(a, b)))


def taylor_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    cfg: TaylorConfig,
    causal: bool = True,
    mode: str = "auto",
    chunk: int = 128,
) -> Tensor:
    """Dispatching entry point.

    mode: "auto" | "parallel" | "chunked" | "recurrent".  "auto" picks
    parallel for n <= 2·chunk and chunked otherwise; chunked falls back to
    parallel when n is not a multiple of ``chunk``.  ``causal=False`` takes
    the non-causal single-state path whatever the mode."""
    n = q.shape[2]
    if not causal:
        return taylor_attention_noncausal(q, k, v, cfg)
    if mode == "auto":
        mode = "parallel" if n <= 2 * chunk else "chunked"
    if mode == "parallel":
        return taylor_attention_parallel(q, k, v, cfg, causal=True)
    if mode == "chunked":
        if n % chunk != 0:
            return taylor_attention_parallel(q, k, v, cfg, causal=True)
        return taylor_attention_chunked(q, k, v, cfg, chunk=chunk)
    if mode == "recurrent":
        return taylor_attention_recurrent(q, k, v, cfg)
    raise ValueError(f"unknown mode {mode!r}")
