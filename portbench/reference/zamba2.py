"""The plain reference of Zamba2-7B-Instruct's training step: forward, loss
and gradients in float32 PyTorch, with TF32 off (``model.exact_float32``).

Written from the layer equations of transformers' ``modeling_zamba2.py``
(``Zamba2ForCausalLM``), over the layout of ``weights_zamba2.py``:

  * x0 = the token embeddings; x = x0.
  * Layer i, a Mamba2 decoder layer: ``x <- x + mamba(rms(x + t))``, where
    t = 0 except at a hybrid site j (``hybrid_layer_ids[j] == i``), where
    ``t = linear_j(shared_{j % num_mem_blocks}(x, x0))``.
  * The shared block (no residual):
    ``h = rms(cat(x, x0))`` (width 2d), ``y = o(attention(q(h), k(h), v(h)))``
    with RoPE over the head dim (rotate-half, ``rope_theta``),
    ``y = rms(y)``, ``[g, u] = gate_up(y) + B_j(A_j(y))``,
    ``out = down(gelu(g) · u)`` with the exact (erf) GELU.
  * Mamba2: in_proj → [z | xBC | dt]; causal depthwise conv (width 4, with
    bias) and SiLU on xBC; dt = softplus(dt + dt_bias); the SSD
    ``y_i = Σ_{j<=i} (C_i·B_j) exp(Σ_{j<l<=i} dt_l A) dt_j x_j + D x_i``
    with B and C shared by the heads of each of ``mamba_ngroups`` groups;
    ``y = rms_g(y · silu(z))``, the RMS taken over each group's share of
    d_inner with eps 1e-5 (``Zamba2RMSNormGated``); out_proj.
  * A final RMSNorm and the head tied to the embedding; every RMSNorm of
    the model takes eps ``rms_norm_eps``.

Departures from that file: the paper's order-2 Taylor attention (``model.
taylor_attention``: q and k LayerNorm'd, ``s = q·k / (alpha·√hd)``, weights
``1 + s + s²/2``, causal) in place of the softmax at scale
``(head_dim / 2)^-0.5``; uniform ids in place of text; and dt is not
clamped at ``time_step_min``, as the file's kernel path leaves it when
``time_step_limit`` is unset (its plain-torch fallback clamps).  The SSD
runs in its quadratic form over the whole sequence (no chunking enters the
result); queries and SSD heads are taken in blocks, each recomputed in the
backward, only to bound memory.  ``quant="fp8"`` is ``model.py``'s control.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from portbench.reference.model import (
    SSD_HEADS,
    _mm,
    _ssd_heads,
    rms_norm,
    rope,
    taylor_attention,
)
from portbench.weights_zamba2 import sizes

Tensor = torch.Tensor

GATE_EPS = 1e-5  # Zamba2RMSNormGated's eps, fixed in the file


def gate_norm(y: Tensor, scale: Tensor, groups: int, eps: float = GATE_EPS) -> Tensor:
    """RMSNorm over each of ``groups`` equal slices of the last axis."""
    yg = y.unflatten(-1, (groups, -1))
    yg = yg * torch.rsqrt(yg.square().mean(-1, keepdim=True) + eps)
    return yg.flatten(-2) * scale


def mamba(p: dict, h: Tensor, cfg: dict, quant: Optional[str]) -> Tensor:
    """The Mamba2 mixer on the normed input ``h`` [b, n, d]."""
    s = sizes(cfg)
    di, nh, hp, g, ns = s["di"], s["H"], s["P"], s["G"], s["N"]
    b, n, _ = h.shape
    zxbcdt = _mm(h, p["in_proj"], quant)
    z, xbc, dt = zxbcdt.split([di, di + 2 * g * ns, nh], dim=-1)
    width = p["conv_w"].shape[0]
    xp = F.pad(xbc, (0, 0, width - 1, 0))
    xbc = F.silu(sum(xp[:, i:i + n] * p["conv_w"][i] for i in range(width)) + p["conv_b"])
    xs = xbc[..., :di].reshape(b, n, nh, hp)
    B = xbc[..., di:di + g * ns].reshape(b, n, g, ns)
    C = xbc[..., di + g * ns:].reshape(b, n, g, ns)
    dt = F.softplus(dt + p["dt_bias"])                                       # [b, n, H]
    cum = torch.cumsum(dt * -torch.exp(p["A_log"]), dim=1).transpose(1, 2)  # [b, H, n]
    xdt = (xs * dt[..., None]).permute(0, 2, 1, 3)                           # [b, H, n, P]
    per = nh // g
    ys = []
    for grp in range(g):
        cb = torch.einsum("bin,bjn->bij", C[:, :, grp], B[:, :, grp])
        for h0 in range(grp * per, (grp + 1) * per, SSD_HEADS):
            h1 = min((grp + 1) * per, h0 + SSD_HEADS)
            args = (cb, cum[:, h0:h1], xdt[:, h0:h1])
            if torch.is_grad_enabled():
                ys.append(checkpoint(_ssd_heads, *args, use_reentrant=False))
            else:
                ys.append(_ssd_heads(*args))
    y = torch.cat(ys, dim=1).permute(0, 2, 1, 3) + xs * p["D"][:, None]
    y = gate_norm(y.reshape(b, n, di) * F.silu(z), p["gate_norm"], g)
    return _mm(y, p["out_proj"], quant)


def shared_block(p: dict, site: dict, x: Tensor, x0: Tensor, cfg: dict,
                 quant: Optional[str]) -> Tensor:
    """What site ``site`` adds to its mamba layer's input: the shared block
    ``p`` over ``cat(x, x0)``, through the site's linear."""
    s, eps = sizes(cfg), cfg["rms_norm_eps"]
    n = x.shape[1]
    pos = torch.arange(n, device=x.device)
    h = rms_norm(torch.cat([x, x0], dim=-1), p["norm1"], eps)
    q = _mm(h, p["wq"], quant).permute(0, 2, 1, 3)   # [b, h, n, hd]
    k = _mm(h, p["wk"], quant).permute(0, 2, 1, 3)
    v = _mm(h, p["wv"], quant).permute(0, 2, 1, 3)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    o = taylor_attention(q, k, v, cfg["taylor"]["alpha"]).permute(0, 2, 1, 3)
    y = _mm(o.reshape(o.shape[0], n, -1), p["wo"].reshape(-1, s["d"]), quant)
    y = rms_norm(y, p["norm2"], eps)
    gu = torch.cat([_mm(y, p["w_gate"], quant), _mm(y, p["w_up"], quant)], dim=-1)
    gu = gu + _mm(_mm(y, site["adapter_a"], quant), site["adapter_b"], quant)
    g, u = gu.chunk(2, dim=-1)
    y = _mm(F.gelu(g) * u, p["w_down"], quant)
    return _mm(y, site["linear"], quant)


def layer(p: dict, shared: Optional[dict], site: Optional[dict], x: Tensor, x0: Tensor,
          cfg: dict, quant: Optional[str]) -> Tensor:
    """Mamba2 decoder layer i, with its hybrid site where it has one."""
    t = x if shared is None else x + shared_block(shared, site, x, x0, cfg, quant)
    return x + mamba(p, rms_norm(t, p["norm1"], cfg["rms_norm_eps"]), cfg, quant)


def forward(params: dict, tokens: Tensor, cfg: dict, quant: Optional[str] = None) -> Tensor:
    """Logits [b, n, V] in float32.  Under autograd every layer is
    recomputed in the backward (only its inputs are kept)."""
    f32 = lambda tree: {name: t.float() for name, t in tree.items()}
    x0 = params["embed"]["w"].float()[tokens.long()]
    x = x0
    site_of = {i: j for j, i in enumerate(cfg["hybrid_layer_ids"])}
    for i, p in enumerate(params["layers"]):
        j = site_of.get(i)
        shared = None if j is None else f32(params["shared"][j % cfg["num_mem_blocks"]])
        site = None if j is None else f32(params["sites"][j])
        args = (f32(p), shared, site, x, x0, cfg, quant)
        x = checkpoint(layer, *args, use_reentrant=False) if torch.is_grad_enabled() \
            else layer(*args)
    x = rms_norm(x, params["final_norm"]["scale"].float(), cfg["rms_norm_eps"])
    return _mm(x, params["embed"]["w"].float().t(), quant)


def loss(params: dict, tokens: Tensor, labels: Tensor, cfg: dict,
         quant: Optional[str] = None, keep: Optional[int] = None) -> Tensor:
    """Mean next-token NLL over every position (over the first ``keep``
    positions of each row where given)."""
    logits = forward(params, tokens, cfg, quant)[:, :keep]
    labels = labels[:, :keep]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1).long())
