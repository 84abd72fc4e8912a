"""The plain reference of the port's attention and Mamba2 block kinds:
forward, loss and gradients in float32 PyTorch, with TF32 off.

It follows the port's architecture as the configuration file states it,
written from the equations and not from the port's code: pre-norm blocks
with RMSNorm or LayerNorm (scale and bias), RoPE (rotate-half) or learned
absolute positions added to the token embeddings, the paper's order-2
Taylor attention in
its quadratic form (q and k LayerNorm'd without affine, ``s = q·k /
(alpha·√d)``, weights ``1 + s + s²/2``, causal, normalised by their sum),
the GELU (tanh) or SiLU-gated MLP, and Mamba2 blocks whose SSD runs in its
quadratic (attention-like) form over the whole sequence.  No chunking of
the sequence enters the result: queries and SSD heads are taken in blocks
only to bound memory, and each block is recomputed in the backward.

``quant="fp8"`` is the control: every projection's activation and weight
are rounded to float8 e4m3 with one scale per tensor (amax / 448) before
the product, the gradient passing straight through.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.weights import layer_kinds, ssm_sizes

Tensor = torch.Tensor

Q_BLOCK = 512       # query rows of one attention block
SSD_HEADS = 16      # SSD heads of one block
EPS = 1e-6          # the LayerNorm of q and k, and the Taylor denominator's floor


def exact_float32() -> None:
    """Products in true float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
        return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g


def _q(x: Tensor, quant: Optional[str]) -> Tensor:
    return _Fp8.apply(x) if quant == "fp8" else x


def _mm(x: Tensor, w: Tensor, quant: Optional[str]) -> Tensor:
    """x [..., k] @ w [k, ...] (w flattened after its first axis)."""
    out = _q(x, quant) @ _q(w.reshape(w.shape[0], -1), quant)
    return out.reshape(x.shape[:-1] + w.shape[1:])


def rms_norm(x: Tensor, scale: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def layer_norm(x: Tensor, eps: float = EPS) -> Tensor:
    """LayerNorm without affine."""
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


def norm(x: Tensor, scale: Tensor, bias: Optional[Tensor], cfg: dict) -> Tensor:
    """The model's norm as the configuration states it."""
    if cfg["norm"] == "layernorm":
        return layer_norm(x, cfg["norm_eps"]) * scale + bias
    return rms_norm(x, scale, cfg["norm_eps"])


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x [b, h, n, hd], rotate-half convention."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, device=x.device, dtype=torch.float32) / hd)
    ang = positions.float()[:, None] * inv[None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attn_rows(q: Tensor, k: Tensor, v: Tensor, i0: int, a: float) -> Tensor:
    """Output rows [i0, i0 + rows) of causal Taylor attention: q [b, hk, g,
    rows, d] (normalised), k/v [b, hk, i1, ·] the keys up to the block's end."""
    s = torch.einsum("bkgid,bkjd->bkgij", q, k) * a
    p = 1.0 + s + 0.5 * s.square()
    rows, keys = q.shape[3], k.shape[2]
    i = torch.arange(i0, i0 + rows, device=q.device)[:, None]
    j = torch.arange(keys, device=q.device)[None, :]
    p = torch.where(j <= i, p, torch.zeros((), device=q.device))
    num = torch.einsum("bkgij,bkjv->bkgiv", p, v)
    den = p.sum(-1, keepdim=True).clamp(min=EPS)
    return num / den


def taylor_attention(q: Tensor, k: Tensor, v: Tensor, alpha: float) -> Tensor:
    """q [b, h, n, d], k/v [b, hk, n, ·] -> [b, h, n, dv]."""
    b, h, n, d = q.shape
    hk = k.shape[1]
    qn = layer_norm(q).reshape(b, hk, h // hk, n, d)
    kn = layer_norm(k)
    a = 1.0 / (alpha * math.sqrt(d))
    outs = []
    for i0 in range(0, n, Q_BLOCK):
        i1 = min(n, i0 + Q_BLOCK)
        args = (qn[:, :, :, i0:i1], kn[:, :, :i1], v[:, :, :i1])
        if torch.is_grad_enabled():
            outs.append(checkpoint(_attn_rows, *args, i0, a, use_reentrant=False))
        else:
            outs.append(_attn_rows(*args, i0, a))
    return torch.cat(outs, dim=3).reshape(b, h, n, v.shape[-1])


def attention_block(p: dict, x: Tensor, cfg: dict, quant: Optional[str]) -> Tensor:
    n = x.shape[1]
    pos = torch.arange(n, device=x.device)
    h = norm(x, p["norm1"], p.get("norm1_bias"), cfg)
    q = _mm(h, p["wq"], quant).permute(0, 2, 1, 3)   # [b, h, n, hd]
    k = _mm(h, p["wk"], quant).permute(0, 2, 1, 3)
    v = _mm(h, p["wv"], quant).permute(0, 2, 1, 3)
    if cfg["pos"] == "rope":
        q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = taylor_attention(q, k, v, cfg["taylor"]["alpha"]).permute(0, 2, 1, 3)
    x = x + _mm(o.reshape(o.shape[0], n, -1), p["wo"].reshape(-1, x.shape[-1]), quant)
    h = norm(x, p["norm2"], p.get("norm2_bias"), cfg)
    if cfg["act"] == "gelu":
        u = F.gelu(_mm(h, p["w_up"], quant) + p["b_up"], approximate="tanh")
        return x + _mm(u, p["w_down"], quant) + p["b_down"]
    u = F.silu(_mm(h, p["w_gate"], quant)) * _mm(h, p["w_up"], quant)
    return x + _mm(u, p["w_down"], quant)


def _ssd_heads(cb: Tensor, cum: Tensor, xdt: Tensor) -> Tensor:
    """y_i = Σ_{j<=i} (C_i·B_j) exp(cum_i - cum_j) dt_j x_j for a block of
    heads: cb [b, n, n], cum [b, hb, n], xdt [b, hb, n, P]."""
    n = cum.shape[-1]
    causal = torch.ones(n, n, dtype=torch.bool, device=cum.device).tril()
    expo = torch.where(causal, cum[..., :, None] - cum[..., None, :],
                       torch.full((), float("-inf"), device=cum.device))
    return (cb[:, None] * torch.exp(expo)) @ xdt


def mamba_block(p: dict, x: Tensor, cfg: dict, quant: Optional[str]) -> Tensor:
    di, nh, hp, g, ns = ssm_sizes(cfg)
    b, n, _ = x.shape
    h = norm(x, p["norm1"], p.get("norm1_bias"), cfg)
    zxbcdt = _mm(h, p["in_proj"], quant)
    z, xbc, dt = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * g * ns], zxbcdt[..., 2 * di + 2 * g * ns:]
    width = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    conv = sum(xp[:, i:i + n] * p["conv_w"][i] for i in range(width)) + p["conv_b"]
    xbc = F.silu(conv)
    xs = xbc[..., :di].reshape(b, n, nh, hp)
    B = xbc[..., di:di + g * ns].reshape(b, n, g, ns)
    C = xbc[..., di + g * ns:].reshape(b, n, g, ns)
    dt = F.softplus(dt + p["dt_bias"])                          # [b, n, H]
    cum = torch.cumsum(dt * -torch.exp(p["A_log"]), dim=1).transpose(1, 2)  # [b, H, n]
    xdt = (xs * dt[..., None]).permute(0, 2, 1, 3)              # [b, H, n, P]
    per = nh // g
    ys = []
    for h0 in range(0, nh, SSD_HEADS):
        h1 = min(nh, h0 + SSD_HEADS)
        grp = h0 // per
        if (h1 - 1) // per != grp:
            raise ValueError("an SSD head block spans two B/C groups")
        cb = torch.einsum("bin,bjn->bij", C[:, :, grp], B[:, :, grp])
        args = (cb, cum[:, h0:h1], xdt[:, h0:h1])
        if torch.is_grad_enabled():
            ys.append(checkpoint(_ssd_heads, *args, use_reentrant=False))
        else:
            ys.append(_ssd_heads(*args))
    y = torch.cat(ys, dim=1).permute(0, 2, 1, 3) + xs * p["D"][:, None]
    y = y.reshape(b, n, di) * F.silu(z)
    y = rms_norm(y, p["gate_norm"], 1e-6)
    return x + _mm(y, p["out_proj"], quant)


def _block(p: dict, kind: str, x: Tensor, cfg: dict, quant: Optional[str]) -> Tensor:
    if kind == "mamba":
        return mamba_block(p, x, cfg, quant)
    return attention_block(p, x, cfg, quant)


def forward(params: dict, tokens: Tensor, cfg: dict, quant: Optional[str] = None) -> Tensor:
    """Logits [b, n, V] in float32.  Under autograd every block is
    recomputed in the backward (only its input is kept)."""
    x = params["embed"]["w"].float()[tokens.long()]
    if cfg["pos"] == "learned":
        x = x + params["pos_embed"]["w"].float()[:tokens.shape[1]]
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        p = params["shared"] if kind == "shared_attn" else p
        p = {name: t.float() for name, t in p.items()}
        if torch.is_grad_enabled():
            x = checkpoint(_block, p, kind, x, cfg, quant, use_reentrant=False)
        else:
            x = _block(p, kind, x, cfg, quant)
    fn = {name: t.float() for name, t in params["final_norm"].items()}
    x = norm(x, fn["scale"], fn.get("bias"), cfg)
    return _mm(x, params["unembed"]["w"].float().t(), quant)


def loss(params: dict, tokens: Tensor, labels: Tensor, cfg: dict,
         quant: Optional[str] = None, keep: Optional[int] = None) -> Tensor:
    """Mean next-token NLL over every position (over the first ``keep``
    positions of each row where given)."""
    logits = forward(params, tokens, cfg, quant)[:, :keep]
    labels = labels[:, :keep]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
