"""Mamba2 (SSD — state-space duality) block.

SSD is linear attention with a per-step decay: the recurrence

    h_t = a_t · h_{t-1} + dt_t · B_t ⊗ x_t        (h: [P, N] per head)
    y_t = C_t · h_t + D · x_t

is computed chunk by chunk, like the chunked Taylor scan: within a chunk
the decay-weighted scores are quadratic, across chunks the state carries.

Block layout (Mamba2 paper): in_proj → [z | x | B | C | dt]; a short causal
depthwise conv on (x, B, C); SSD; gated RMSNorm(y ⊙ silu(z)), taken per B/C
group with eps ``cfg.norm_eps``; out_proj.

The numerics are the JAX package's: the conv accumulates in the activation
dtype, the SSD runs in float32, and the decode state keeps ``ssd`` in
float32 and ``conv`` in the cache dtype.  On a mesh the block's layout is
set by ``distributed/spmd.py::site`` around it; under
``attn_sharding="cp"`` it runs the context-parallel SSD on its sequence
block (``mamba_apply``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.layers import dense_init, norm_apply, norm_init, trunc_normal

Tensor = torch.Tensor


class MambaCache(NamedTuple):
    conv: Tensor  # [b, W-1, conv_channels]: the last W-1 pre-conv activations
    ssd: Tensor   # [b, H, P, N]: the SSD recurrent state (float32)


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    """One mamba block's params (the JAX package's shapes and init scales)."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_ssm_heads(d)
    dbc = 2 * s.n_groups * s.d_state
    dev = gen.device
    f32 = torch.float32
    return {
        "in_proj": dense_init(gen, (d, 2 * di + dbc + nh), dtype=dtype),
        "conv_w": trunc_normal(gen, (s.conv_width, di + dbc), 0.1, dtype),
        "conv_b": torch.zeros((di + dbc,), dtype=dtype, device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nh, dtype=f32, device=dev)),
        "D": torch.ones((nh,), dtype=f32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.full((nh,), 0.01, dtype=f32, device=dev))),
        "out_proj": dense_init(gen, (di, d), dtype=dtype),
        "gate_norm": norm_init(di, "rmsnorm", dtype, device=dev),
    }


def _split_proj(s: SSMConfig, d_model: int, zxbcdt: Tensor):
    """in_proj's output -> (z, xBC, dt)."""
    di = s.d_inner(d_model)
    gN = s.n_groups * s.d_state
    return zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * gN], zxbcdt[..., 2 * di + 2 * gN:]


def _causal_conv(xbc: Tensor, w: Tensor, b: Tensor, state: Optional[Tensor] = None):
    """Depthwise causal conv of width W over ``xbc`` [b, n, c], then SiLU.

    Returns ``(y, new_state)``; ``state`` [b, W-1, c] holds the last W-1
    inputs for streaming decode (zeros when None).  The taps accumulate in
    the activation dtype, as in the JAX package."""
    W = w.shape[0]
    bsz, n, c = xbc.shape
    if state is None:
        pad = xbc.new_zeros((bsz, W - 1, c))
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)  # [b, n+W-1, c]
    y = xp[:, 0:n] * w[0].to(xbc.dtype)
    for i in range(1, W):
        y = y + xp[:, i:i + n] * w[i].to(xbc.dtype)
    y = F.silu(y.float() + b.float())
    new_state = xp[:, n:] if W > 1 else xbc.new_zeros((bsz, 0, c))
    return y.to(xbc.dtype), new_state


def _ssd_chunked(
    x: Tensor,   # [b, n, H, P]
    dt: Tensor,  # [b, n, H]  (after softplus)
    A: Tensor,   # [H]        (negative)
    B: Tensor,   # [b, n, G, N]
    C: Tensor,   # [b, n, G, N]
    chunk: int,
    initial_state: Optional[Tensor] = None,
    return_state: bool = False,
):
    """Exact chunked SSD scan, in float32.  G divides H (B/C shared per group).

    The chunks' intra-chunk terms and state contributions are computed for
    all chunks at once; only the [b, H, P, N] carry runs chunk after chunk.
    The decay exponent is masked to -inf above the diagonal before ``exp``:
    the values are the JAX package's (its ``where`` drops those entries), and
    the gradient stays finite where ``exp`` of the unmasked exponent would
    overflow (autograd through the ``where`` alone gives 0·inf = NaN).

    Returns ``y [b, n, H, P]`` (float32), and the final state when
    ``return_state``."""
    b, n, H, P = x.shape
    N = B.shape[3]
    rep = H // B.shape[2]
    nc = n // chunk
    f32 = torch.float32

    Bh = B.repeat_interleave(rep, dim=2).to(f32).reshape(b, nc, chunk, H, N)
    Ch = C.repeat_interleave(rep, dim=2).to(f32).reshape(b, nc, chunk, H, N)
    la = (dt.to(f32) * A.to(f32)[None, None, :]).reshape(b, nc, chunk, H)  # log decay
    xc = (x.to(f32) * dt.to(f32)[..., None]).reshape(b, nc, chunk, H, P)  # dt-scaled

    cum = la.cumsum(dim=2)  # [b, nc, c, H], inclusive
    total = cum[:, :, -1]   # [b, nc, H]
    # intra-chunk: S_ij = (C_i·B_j) exp(cum_i - cum_j) for j <= i
    scores = torch.einsum("bzihn,bzjhn->bzhij", Ch, Bh)
    decay = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).permute(0, 1, 4, 2, 3)
    mask = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    w = torch.where(mask, torch.exp(decay.masked_fill(~mask, float("-inf"))) * scores, 0.0)
    y = torch.einsum("bzhij,bzjhp->bzihp", w, xc)
    # each chunk's state contribution: Σ_j exp(total - cum_j) B_j x_j
    wj = torch.exp(total[:, :, None, :] - cum)  # [b, nc, c, H]
    contrib = torch.einsum("bzjhn,bzjhp->bzhpn", Bh * wj[..., None], xc)
    # the carry: h_new = exp(total) h + contribution, chunk after chunk
    h = initial_state if initial_state is not None else x.new_zeros((b, H, P, N), dtype=f32)
    keep = torch.exp(total)[..., None, None]  # [b, nc, H, 1, 1]
    h_prev = []
    for z in range(nc):
        h_prev.append(h)
        h = h * keep[:, z] + contrib[:, z]
    # inter-chunk: y_i += C_i · (exp(cum_i) h_prev)
    y_inter = torch.einsum("bzihn,bzhpn->bzihp", Ch, torch.stack(h_prev, dim=1))
    y = (y + y_inter * torch.exp(cum)[..., None]).reshape(b, n, H, P)
    if return_state:
        return y, h
    return y


def _ssd_inputs(params, x: Tensor, cfg: ModelConfig):
    """The block's path up to the SSD: (z, pre-conv xBC, xs, dt, A, B, C)."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_ssm_heads(d)
    gN = s.n_groups * s.d_state
    b, n, _ = x.shape
    zxbcdt = x @ params["in_proj"]["w"].to(x.dtype)
    z, xbc_raw, dt = _split_proj(s, d, zxbcdt)
    xbc, _ = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"])
    xs = xbc[..., :di].reshape(b, n, nh, s.head_dim)
    B = xbc[..., di:di + gN].reshape(b, n, s.n_groups, s.d_state)
    C = xbc[..., di + gN:].reshape(b, n, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    return z, xbc_raw, xs, dt, A, B, C


def gate_norm(params, y: Tensor, cfg: ModelConfig) -> Tensor:
    """RMSNorm (eps ``cfg.norm_eps``) of the gated SSD output ``y`` [...,
    d_inner], taken over each B/C group's share of d_inner on its own (the
    grouped norm of Mamba2 and of Zamba2's RMSNormGated); with one group,
    ``norm_apply``'s RMSNorm."""
    groups = cfg.ssm.n_groups
    if groups == 1:
        return norm_apply(params, y, "rmsnorm", cfg.norm_eps)
    x = y.float().unflatten(-1, (groups, -1))
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + cfg.norm_eps)
    return (x.flatten(-2) * params["scale"].float()).to(y.dtype)


def _ssd_output(params, y: Tensor, xs: Tensor, z: Tensor, cfg: ModelConfig, dtype) -> Tensor:
    """The D skip, the gated RMSNorm and out_proj on the SSD output."""
    y = y + xs.float() * params["D"][:, None]
    y = y.reshape(z.shape).to(dtype)
    y = gate_norm(params["gate_norm"], y * F.silu(z), cfg)
    return y @ params["out_proj"]["w"].to(dtype)


def mamba_apply(params, x: Tensor, cfg: ModelConfig, chunk: int = 128) -> Tensor:
    """Full-sequence forward: ``x`` [b, n, d_model] (the pre-normed block
    input) -> [b, n, d_model].  One chunk when ``n % chunk``.

    Under ``attn_sharding="cp"`` inside a sharding context, ``x`` is this
    rank's sequence block (``distributed/spmd.py``): the SSD runs the
    decay-weighted context parallelism of ``core/ssd_context_parallel.py``
    and the causal conv reads the previous block's last inputs.  The span
    ``mamba`` (``repro_torch.spans``) covers it, remat reruns included."""
    if x.shape[1] % chunk != 0:
        chunk = x.shape[1]  # single-chunk fallback (tests / odd shapes)
    with spans.span("mamba"):
        seq_ax = _cp_axis(cfg)
        if seq_ax is not None:
            return _mamba_apply_cp(params, x, cfg, chunk, *seq_ax)
        z, _, xs, dt, A, B, C = _ssd_inputs(params, x, cfg)
        y = _ssd_chunked(xs, dt, A, B, C, chunk)
        return _ssd_output(params, y, xs, z, cfg, x.dtype)


def _cp_axis(cfg: ModelConfig):
    """``(mesh, sequence axis)`` when the block runs context-parallel, else
    None."""
    if cfg.attn_sharding != "cp":
        return None
    from repro_torch.distributed import api as dist  # noqa: PLC0415 (cycle)

    ctx = dist.active()
    if ctx is None:
        return None
    mesh, rules = ctx
    seq_ax = rules.get("sp") or rules.get("tp")
    return None if seq_ax is None else (mesh, seq_ax)


def _mamba_apply_cp(params, x: Tensor, cfg: ModelConfig, chunk: int, mesh, axis) -> Tensor:
    """``mamba_apply`` on this rank's sequence block ``x`` [b, n_loc, d]."""
    from repro_torch.core.ssd_context_parallel import ssd_cp_local  # noqa: PLC0415 (cycle)
    from repro_torch.distributed import collectives as col  # noqa: PLC0415

    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_ssm_heads(d)
    gN = s.n_groups * s.d_state
    b, n, _ = x.shape
    zxbcdt = x @ params["in_proj"]["w"].to(x.dtype)
    z, xbc_raw, dt = _split_proj(s, d, zxbcdt)
    # the conv's halo: the previous block's last W-1 inputs (zeros on the
    # first block, through the gathered tensor all the same, so that every
    # rank's backward runs the gather's transpose)
    W = params["conv_w"].shape[0]
    tails = col.all_gather(xbc_raw[None, :, n - (W - 1):], 0, mesh, axis, grad="sum")
    idx = col.axis_rank(mesh, axis)
    halo = tails[max(idx - 1, 0)] * float(idx > 0)
    xbc, _ = _causal_conv(xbc_raw, params["conv_w"], params["conv_b"], state=halo)
    xs = xbc[..., :di].reshape(b, n, nh, s.head_dim)
    B = xbc[..., di:di + gN].reshape(b, n, s.n_groups, s.d_state)
    C = xbc[..., di + gN:].reshape(b, n, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"])
    y = ssd_cp_local(xs, dt, A, B, C, mesh, axis, chunk)
    return _ssd_output(params, y, xs, z, cfg, x.dtype)


# ---------------------------------------------------------------------------
# Streaming decode
# ---------------------------------------------------------------------------


def mamba_init_cache(cfg: ModelConfig, batch: int, device=None,
                     dtype=torch.float32) -> MambaCache:
    """Zero decode state: ``conv`` in ``dtype``, ``ssd`` in float32."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_ssm_heads(d)
    gN = s.n_groups * s.d_state
    return MambaCache(
        conv=torch.zeros((batch, s.conv_width - 1, di + 2 * gN), dtype=dtype, device=device),
        ssd=torch.zeros((batch, nh, s.head_dim, s.d_state), dtype=torch.float32, device=device),
    )


def mamba_prefill(params, h: Tensor, cfg: ModelConfig) -> Tuple[Tensor, MambaCache]:
    """Full-sequence SSD pass that also returns the streaming decode cache:
    ``mamba_apply`` with the final state and the conv tail kept.  The chunk
    is ``cfg.attn_chunk``, or the whole prompt when it does not divide it.

    Args:
      params: the block's ``"mamba"`` params.
      h: ``[b, n, d_model]`` pre-normed block input.
      cfg: model config.

    Returns:
      ``(y [b, n, d_model], MambaCache)``.
    """
    W = cfg.ssm.conv_width
    z, xbc_raw, xs, dt, A, B, C = _ssd_inputs(params, h, cfg)
    conv_tail = xbc_raw[:, -(W - 1):] if W > 1 else xbc_raw[:, :0]
    n = h.shape[1]
    chunk = cfg.attn_chunk if n % cfg.attn_chunk == 0 else n
    y, state = _ssd_chunked(xs, dt, A, B, C, chunk, return_state=True)
    return _ssd_output(params, y, xs, z, cfg, h.dtype), MambaCache(conv=conv_tail, ssd=state)


def mamba_decode_step(params, x_t: Tensor, cache: MambaCache,
                      cfg: ModelConfig) -> Tuple[Tensor, MambaCache]:
    """One token: ``x_t`` [b, d_model] -> ``(y_t [b, d_model], new cache)``;
    ``cache`` is not modified."""
    s, d = cfg.ssm, cfg.d_model
    di, nh = s.d_inner(d), s.n_ssm_heads(d)
    gN = s.n_groups * s.d_state
    bsz, dtype = x_t.shape[0], x_t.dtype
    f32 = torch.float32

    zxbcdt = x_t @ params["in_proj"]["w"].to(dtype)
    z, xbc, dt = _split_proj(s, d, zxbcdt)
    y_c, conv_state = _causal_conv(xbc[:, None, :], params["conv_w"], params["conv_b"],
                                   state=cache.conv)
    xbc = y_c[:, 0]
    xs = xbc[..., :di].reshape(bsz, nh, s.head_dim).to(f32)
    rep = nh // s.n_groups
    Bh = xbc[..., di:di + gN].reshape(bsz, s.n_groups, s.d_state).to(f32).repeat_interleave(
        rep, dim=1)  # [b, H, N]
    Ch = xbc[..., di + gN:].reshape(bsz, s.n_groups, s.d_state).to(f32).repeat_interleave(
        rep, dim=1)
    dt = F.softplus(dt.float() + params["dt_bias"])  # [b, H]
    A = -torch.exp(params["A_log"])

    a_t = torch.exp(dt * A[None, :])
    h = cache.ssd * a_t[..., None, None] + torch.einsum("bhn,bhp->bhpn", Bh,
                                                        xs * dt[..., None])
    y = torch.einsum("bhn,bhpn->bhp", Ch, h)
    return _ssd_output(params, y, xs, z, cfg, dtype), MambaCache(conv=conv_state, ssd=h)
