"""Primitive layers: norms, embeddings, RoPE, MLPs (plain functions on tensors).

Params are nested dicts of tensors with the JAX package's names and layouts;
``*_apply(params, x, ...) -> y``.  Initialisers draw from an explicit
``torch.Generator``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def trunc_normal(gen: torch.Generator, shape, std: float, dtype=torch.float32) -> Tensor:
    """``std`` × a standard normal truncated to [-2, 2], drawn on ``gen``'s device."""
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not x.is_meta:  # a meta tensor has no values to draw (``lm.MetaDraws``)
        torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x * std).to(dtype)


def dense_init(gen: torch.Generator, shape, bias: bool = False, in_axes: int = 1,
               dtype=torch.float32):
    """Projection weight with fan-in init; the first ``in_axes`` axes are
    contracted.  ``bias`` adds a zero ``b`` of the output axes' shape."""
    fan_in = math.prod(shape[:in_axes])
    params = {"w": trunc_normal(gen, shape, 1.0 / math.sqrt(fan_in), dtype)}
    if bias:
        params["b"] = torch.zeros(shape[in_axes:], dtype=dtype, device=gen.device)
    return params


def norm_init(d: int, kind: str = "rmsnorm", dtype=torch.float32, device=None):
    """A norm's params: a unit ``scale``, and for layernorm a zero ``bias``."""
    params = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        params["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    elif kind != "rmsnorm":
        raise ValueError(kind)
    return params


def norm_apply(params, x: Tensor, kind: str = "rmsnorm", eps: float = 1e-6) -> Tensor:
    """RMSNorm or LayerNorm over the last axis in float32, cast back to x's
    dtype."""
    dtype = x.dtype
    x = x.float()
    if kind == "rmsnorm":
        y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
        return (y * params["scale"].float()).to(dtype)
    if kind == "layernorm":
        mu = x.mean(dim=-1, keepdim=True)
        var = (x - mu).square().mean(dim=-1, keepdim=True)
        y = (x - mu) * torch.rsqrt(var + eps)
        return (y * params["scale"].float() + params["bias"].float()).to(dtype)
    raise ValueError(kind)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32):
    return {"w": trunc_normal(gen, (vocab, d), d**-0.5, dtype)}


def embed_apply(params, ids: Tensor, dtype=torch.bfloat16) -> Tensor:
    return F.embedding(ids, params["w"]).to(dtype)


def unembed_apply(params, x: Tensor) -> Tensor:
    """Logits, always float32: the hidden state meets the float32 table."""
    return torch.einsum("...d,vd->...v", x.float(), params["w"].float())


def sinusoidal_pos(positions: Tensor, d: int) -> Tensor:
    """Transformer sinusoidal position encoding: [n] -> [n, d] float32
    (sines of the ``d // 2`` frequencies, then their cosines)."""
    half = d // 2
    freqs = torch.exp(-math.log(10000.0)
                      * torch.arange(half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta**exponent)


def apply_rope(x: Tensor, positions: Tensor, theta: float = 10000.0) -> Tensor:
    """x: [..., n, hd] (positions [n] or broadcastable), rotate-half
    convention, computed in float32."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, device=x.device)
    angles = positions[..., :, None].float() * freqs  # [..., n, hd/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)


GATED = ("silu", "geglu", "geglu_erf")


def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str, dtype=torch.float32):
    """Gated MLP (silu, geglu, geglu_erf: w_gate, w_up, w_down) or the plain
    2-matrix gelu MLP with biases (w_up, b_up, w_down, b_down)."""
    if act in GATED:
        return {
            "w_gate": dense_init(gen, (d, d_ff), dtype=dtype)["w"],
            "w_up": dense_init(gen, (d, d_ff), dtype=dtype)["w"],
            "w_down": dense_init(gen, (d_ff, d), dtype=dtype)["w"],
        }
    if act == "gelu":
        return {
            "w_up": dense_init(gen, (d, d_ff), dtype=dtype)["w"],
            "b_up": torch.zeros((d_ff,), dtype=dtype, device=gen.device),
            "w_down": dense_init(gen, (d_ff, d), dtype=dtype)["w"],
            "b_down": torch.zeros((d,), dtype=dtype, device=gen.device),
        }
    raise ValueError(act)


def adapter_init(gen: torch.Generator, d: int, rank: int, out: int, dtype=torch.float32):
    """A rank-``rank`` adapter ``x @ a @ b`` from d to ``out`` (a hybrid
    site's, on its shared MLP's gate_up): a [d, rank], b [rank, out]."""
    return {"a": dense_init(gen, (d, rank), dtype=dtype)["w"],
            "b": dense_init(gen, (rank, out), dtype=dtype)["w"]}


def mlp_apply(params, x: Tensor, act: str, adapter=None) -> Tensor:
    """The MLP in x's dtype; GELU in its tanh form (JAX's ``approximate=True``)
    except under "geglu_erf", the exact (erf) GELU.

    ``adapter`` (a gated MLP's): ``adapter_init``'s pair, whose ``x @ a @ b``
    [..., 2·d_ff] adds to the gate and up projections, the gate's half first.
    Weights with leading expert axes (``[E, d, d_ff]``, biases ``[E, 1,
    d_ff]``) broadcast against ``x`` as a batched product."""
    dtype = x.dtype
    if act in GATED:
        gate = x @ params["w_gate"].to(dtype)
        up = x @ params["w_up"].to(dtype)
        if adapter is not None:
            ab = (x @ adapter["a"].to(dtype)) @ adapter["b"].to(dtype)
            gate, up = gate + ab[..., :gate.shape[-1]], up + ab[..., gate.shape[-1]:]
        if act == "silu":
            g = F.silu(gate)
        else:
            g = F.gelu(gate, approximate="tanh" if act == "geglu" else "none")
        return (g * up) @ params["w_down"].to(dtype)
    if act == "gelu":
        h = F.gelu(x @ params["w_up"].to(dtype) + params["b_up"].to(dtype), approximate="tanh")
        return h @ params["w_down"].to(dtype) + params["b_down"].to(dtype)
    raise ValueError(act)
