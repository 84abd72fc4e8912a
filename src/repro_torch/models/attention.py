"""GQA attention block over the backend registry, plus prefill/decode.

``cfg.attention`` resolves to an ``AttentionBackend``
(``repro_torch.backends``): this module owns the projections
(wq ``[d, h, hd]``, wk/wv ``[d, hk, hd]``, wo ``[h, hd, d]``) and RoPE, and
hands projected heads to the backend's ``apply`` / ``prefill`` /
``prefill_chunk`` / ``decode_step``.  Activations are ``[b, n, d]``;
heads ``[b, h, n, hd]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.backends import resolve_backend
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init

Tensor = torch.Tensor


def attention_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    if cfg.qkv_bias:
        raise NotImplementedError("qkv_bias is not yet ported to torch")
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return {
        "wq": dense_init(gen, (d, h, hd), dtype=dtype),
        "wk": dense_init(gen, (d, hk, hd), dtype=dtype),
        "wv": dense_init(gen, (d, hk, hd), dtype=dtype),
        "wo": dense_init(gen, (h, hd, d), in_axes=2, dtype=dtype),
    }


def _project_q(params, x: Tensor, cfg: ModelConfig, positions: Optional[Tensor]):
    q = torch.einsum("bnd,dhk->bhnk", x, params["wq"]["w"].to(x.dtype))
    if cfg.pos == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(params, x: Tensor, cfg: ModelConfig, positions: Optional[Tensor]):
    k = torch.einsum("bnd,dhk->bhnk", x, params["wk"]["w"].to(x.dtype))
    v = torch.einsum("bnd,dhk->bhnk", x, params["wv"]["w"].to(x.dtype))
    if cfg.pos == "rope" and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _out_proj(params, o: Tensor, x_dtype) -> Tensor:
    return torch.einsum("bhnk,hkd->bnd", o.to(x_dtype), params["wo"]["w"].to(x_dtype))


def attention_apply(
    params, x: Tensor, cfg: ModelConfig, positions: Optional[Tensor] = None
) -> Tensor:
    """Causal self-attention over the full sequence."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    backend = resolve_backend(cfg)
    q = _project_q(params, x, cfg, positions)
    k, v = _project_kv(params, x, cfg, positions)
    o = backend.apply(q, k, v, cfg, causal=True)
    return _out_proj(params, o, x.dtype)


def init_cache(cfg: ModelConfig, batch: int, n_max: int, device=None, dtype=torch.float32):
    """Zero decode cache for one attention block (KV leaves in ``dtype``)."""
    return resolve_backend(cfg).init_cache(cfg, batch, n_max, device, dtype)


def attention_prefill(
    params,
    x: Tensor,
    cfg: ModelConfig,
    n_max: int,
    positions: Optional[Tensor] = None,
) -> Tuple[Tensor, object]:
    """Causal self-attention over the prompt, returning (y, cache)."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    backend = resolve_backend(cfg)
    q = _project_q(params, x, cfg, positions)
    k, v = _project_kv(params, x, cfg, positions)
    o, cache = backend.prefill(q, k, v, cfg, n_max)
    return _out_proj(params, o, x.dtype), cache


def attention_prefill_chunk(params, x: Tensor, cache, cfg: ModelConfig,
                            positions: Tensor) -> Tuple[Tensor, object]:
    """Advance a decode cache by a CHUNK of prompt tokens.

    Projects the chunk, applies RoPE at the chunk's absolute positions and
    hands the state continuation to ``backend.prefill_chunk``.

    Args:
      params: attention block params (wq/wk/wv/wo).
      x: chunk activations ``[b, c, d_model]``.
      cache: decode state to continue from.
      cfg: model config.
      positions: ``[b, c]`` int absolute 0-based positions of the chunk tokens.

    Returns:
      ``(y [b, c, d_model], new_cache)`` — to fp tolerance, what
      ``attention_decode`` over the chunk token by token gives.
    """
    backend = resolve_backend(cfg)
    pos_bc = positions[:, None, :]  # broadcast against [b, h, c, hd] in RoPE
    q = _project_q(params, x, cfg, pos_bc)
    k, v = _project_kv(params, x, cfg, pos_bc)
    o, cache = backend.prefill_chunk(cache, q, k, v, cfg, positions)
    return _out_proj(params, o, x.dtype), cache


def attention_decode(params, x_t: Tensor, cache, cfg: ModelConfig, pos) -> Tuple[Tensor, object]:
    """One decode step against the cache.

    Args:
      params: attention block params (wq/wk/wv/wo).
      x_t: current-token activations ``[b, d_model]``.
      cache: this layer's decode state.
      cfg: model config.
      pos: 0-based position of this token — an int or a ``[b]`` tensor.

    Returns:
      ``(y_t [b, d_model], new_cache)``; the token attends to itself.
    """
    b = x_t.shape[0]
    dtype = x_t.dtype
    backend = resolve_backend(cfg)
    pos_b = torch.as_tensor(pos, dtype=torch.int32, device=x_t.device).expand(b)
    q = torch.einsum("bd,dhk->bhk", x_t, params["wq"]["w"].to(dtype))
    k = torch.einsum("bd,dhk->bhk", x_t, params["wk"]["w"].to(dtype))
    v = torch.einsum("bd,dhk->bhk", x_t, params["wv"]["w"].to(dtype))
    if cfg.pos == "rope":
        p = pos_b[:, None, None]  # broadcast against [b, h, 1, hd]
        q = apply_rope(q[:, :, None, :], p, cfg.rope_theta)[:, :, 0, :]
        k = apply_rope(k[:, :, None, :], p, cfg.rope_theta)[:, :, 0, :]
    o, cache = backend.decode_step(cache, q, k, v, cfg, pos_b)
    y = torch.einsum("bhk,hkd->bd", o.to(dtype), params["wo"]["w"].to(dtype))
    return y, cache
