"""GQA attention block over the backend registry, plus prefill/decode.

``cfg.attention`` resolves to an ``AttentionBackend``
(``repro_torch.backends``): this module owns the projections
(wq ``[d, h, hd]``, wk/wv ``[d, hk, hd]``, wo ``[h, hd, d]``; at a hybrid
site the first axis of wq/wk/wv is ``cfg.attention_width``; with
``qkv_bias`` a ``b`` of ``[h, hd]`` / ``[hk, hd]`` each, added before RoPE)
and RoPE, and
hands projected heads to the backend's ``apply`` / ``prefill`` /
``prefill_chunk`` / ``decode_step``, and for cross-attention (q from the
decoder, k and v from a fixed source without RoPE) to its ``cross_state``
/ ``cross_read``.  Activations are ``[b, n, d]``; heads ``[b, h, n, hd]``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.backends import resolve_backend
from repro_torch.backends.state import CrossCache
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init

Tensor = torch.Tensor


def attention_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32,
                   width: int = 0):
    """Projections from ``width`` (default d_model: a hybrid site's attention
    reads ``cfg.attention_width``) and back to d_model."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    w = width or d
    return {
        "wq": dense_init(gen, (w, h, hd), bias=cfg.qkv_bias, dtype=dtype),
        "wk": dense_init(gen, (w, hk, hd), bias=cfg.qkv_bias, dtype=dtype),
        "wv": dense_init(gen, (w, hk, hd), bias=cfg.qkv_bias, dtype=dtype),
        "wo": dense_init(gen, (h, hd, d), in_axes=2, dtype=dtype),
    }


def _head_bias(p, dtype) -> Tensor:
    """A projection's ``b`` [heads, hd] (``qkv_bias``) as [heads, 1, hd]."""
    return p["b"].to(dtype)[:, None, :]


def _project_q(params, x: Tensor, cfg: ModelConfig, positions: Optional[Tensor]):
    q = torch.einsum("bnd,dhk->bhnk", x, params["wq"]["w"].to(x.dtype))
    if "b" in params["wq"]:  # the bias comes before RoPE, as in the JAX package
        q = q + _head_bias(params["wq"], x.dtype)
    if cfg.pos == "rope" and positions is not None:
        q = apply_rope(q, positions, cfg.rope_theta)
    return q


def _project_kv(params, x: Tensor, cfg: ModelConfig, positions: Optional[Tensor]):
    k = torch.einsum("bnd,dhk->bhnk", x, params["wk"]["w"].to(x.dtype))
    v = torch.einsum("bnd,dhk->bhnk", x, params["wv"]["w"].to(x.dtype))
    if "b" in params["wk"]:
        k = k + _head_bias(params["wk"], x.dtype)
        v = v + _head_bias(params["wv"], x.dtype)
    if cfg.pos == "rope" and positions is not None:
        k = apply_rope(k, positions, cfg.rope_theta)
    return k, v


def _out_proj(params, o: Tensor, x_dtype) -> Tensor:
    return torch.einsum("bhnk,hkd->bnd", o.to(x_dtype), params["wo"]["w"].to(x_dtype))


def attention_heads(params, x: Tensor, cfg: ModelConfig, positions: Tensor):
    """(q [b, h, n, hd], k, v [b, hk, n, hd]) of ``x`` [b, n, width], with
    RoPE at ``positions``: the attention's part before its backend."""
    return (_project_q(params, x, cfg, positions),) + _project_kv(params, x, cfg, positions)


def attention_out(params, o: Tensor, dtype) -> Tensor:
    """The output projection of the backend's ``o`` [b, h, n, hd] in ``dtype``."""
    return _out_proj(params, o, dtype)


def attention_apply(
    params,
    x: Tensor,
    cfg: ModelConfig,
    positions: Optional[Tensor] = None,
    causal: bool = True,
    kv_src: Optional[Tensor] = None,
) -> Tensor:
    """Self-attention over the full sequence (``kv_src=None``; causal unless
    ``causal=False``, as in the encoder), or cross-attention: q from ``x``,
    k and v from ``kv_src`` ``[b, m, d]`` without RoPE, every query reading
    the whole source."""
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)
    backend = resolve_backend(cfg)
    cross = kv_src is not None
    if cross and not backend.supports_cross:
        raise ValueError(
            f"attention backend {backend.name!r} does not support "
            "cross-attention (supports_cross=False)"
        )
    q = _project_q(params, x, cfg, None if cross else positions)
    k, v = _project_kv(params, kv_src if cross else x, cfg, None if cross else positions)
    o = backend.apply(q, k, v, cfg, causal=causal and not cross)
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
    if "b" in params["wq"]:
        q = q + params["wq"]["b"].to(dtype)
        k = k + params["wk"]["b"].to(dtype)
        v = v + params["wv"]["b"].to(dtype)
    if cfg.pos == "rope":
        p = pos_b[:, None, None]  # broadcast against [b, h, 1, hd]
        q = apply_rope(q[:, :, None, :], p, cfg.rope_theta)[:, :, 0, :]
        k = apply_rope(k[:, :, None, :], p, cfg.rope_theta)[:, :, 0, :]
    o, cache = backend.decode_step(cache, q, k, v, cfg, pos_b)
    y = torch.einsum("bhk,hkd->bd", o.to(dtype), params["wo"]["w"].to(dtype))
    return y, cache


def cross_prefill(params, kv_src: Tensor, cfg: ModelConfig) -> CrossCache:
    """The cross-attention read state of a source sequence ``[b, m, d]``,
    computed once per request (its k and v carry no RoPE)."""
    k, v = _project_kv(params, kv_src, cfg, None)
    return CrossCache(kv=resolve_backend(cfg).cross_state(k, v, cfg))


def cross_decode(params, x_t: Tensor, cache: CrossCache, cfg: ModelConfig) -> Tensor:
    """One token's cross-attention ``[b, d_model]`` against the fixed state."""
    dtype = x_t.dtype
    q = torch.einsum("bd,dhk->bhk", x_t, params["wq"]["w"].to(dtype))
    if "b" in params["wq"]:
        q = q + params["wq"]["b"].to(dtype)
    o = resolve_backend(cfg).cross_read(cache.kv, q, cfg)
    return torch.einsum("bhk,hkd->bd", o.to(dtype), params["wo"]["w"].to(dtype))
