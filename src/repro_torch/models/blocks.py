"""Block-kind dispatcher: init / full-sequence apply / prefill / chunked
prefill / decode.

Kinds: ``"attn"`` and ``"shared_attn"`` (pre-norm self-attention + MLP;
the shared block's one set of weights is passed in by ``models/lm.py`` at
each occurrence), ``"moe"`` (pre-norm self-attention + mixture-of-experts
FFN), ``"mamba"`` (pre-norm Mamba2 / SSD, through the block-level ``"ssm"``
backend of the registry) and ``"cross"`` (pre-norm self-attention, then
pre-norm cross-attention to the source ``kv_src``, then the MLP; its decode
cache is the pair ``(self cache, CrossCache)``, the second fixed at
prefill).  A mamba layer at one of Zamba2's hybrid sites runs
``hybrid_apply``: a shared block over the stream and the embeddings, through
the site's own adapter and linear, adds to its mamba block's input.  Only
``block_apply`` returns the MoE load-balance loss; the serving paths drop
it, as in the JAX package.  On a mesh the cross
attention runs through ``spmd.site("cross")``, which reads the source
whole and carries the read state's block in serving.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.backends import get_backend, resolve_backend
from repro_torch.backends.state import CrossCache
from repro_torch.distributed import spmd
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm
from repro_torch.models.config import BLOCK_KINDS, ModelConfig
from repro_torch.models.layers import (
    adapter_init,
    dense_init,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
)

Tensor = torch.Tensor


def _check_kind(kind: str) -> None:
    if kind not in BLOCK_KINDS:
        raise ValueError(f"unknown block kind {kind!r}")


def block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype=torch.float32):
    _check_kind(kind)
    norm = lambda: norm_init(cfg.d_model, cfg.norm, dtype, device=gen.device)
    if kind == "mamba":
        return {"norm1": norm(), "mamba": ssm.mamba_init(gen, cfg, dtype)}
    params = {"norm1": norm(), "attn": attn.attention_init(gen, cfg, dtype)}
    if kind == "cross":
        params.update(norm_c=norm(), cross=attn.attention_init(gen, cfg, dtype))
    params["norm2"] = norm()
    if kind == "moe":
        params["moe"] = moe_mod.moe_init(gen, cfg, dtype)
    else:
        params["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype)
    return params


def _ffn(params, kind: str, h: Tensor, cfg: ModelConfig) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's FFN on ``h`` [b, n, d]: (y, the MoE aux loss or None)."""
    if kind == "moe":
        return moe_mod.moe_apply(params["moe"], h, cfg)
    return spmd.site("mlp", _mlp, params["mlp"], h, cfg), None


def _mlp(p, h: Tensor, cfg: ModelConfig, positions) -> Tensor:
    return mlp_apply(p, h, cfg.act)


def _mamba(p, h: Tensor, cfg: ModelConfig, positions) -> Tensor:
    return get_backend("ssm").apply(p, h, cfg)


def _cross(p, h: Tensor, cfg: ModelConfig, src: Tensor) -> Tensor:
    return attn.attention_apply(p, h, cfg, kv_src=src)


def _cross_prefill(p, h: Tensor, cfg: ModelConfig, src: Tensor, state):
    """The cross read of ``h`` and the source's read state (the backend's,
    unwrapped: the site cuts it to this rank's block)."""
    return _cross(p, h, cfg, src), attn.cross_prefill(p, src, cfg).kv


def _cross_read(p, h: Tensor, cfg: ModelConfig, src, state):
    """Each token of ``h`` [b, c, d] reads the fixed state; it comes back
    as it was."""
    cache = CrossCache(kv=state)
    y = torch.stack([attn.cross_decode(p, h[:, i], cache, cfg) for i in range(h.shape[1])],
                    dim=1)
    return y, state


def block_apply(
    params, kind: str, x: Tensor, cfg: ModelConfig, positions: Optional[Tensor] = None,
    kv_src: Optional[Tensor] = None, causal: bool = True,
) -> Tuple[Tensor, Tensor]:
    """Full-sequence forward (``causal=False`` for the encoder's blocks;
    ``kv_src`` is a cross block's source).  Returns (x, aux_loss).  Inside
    a mesh's ``distributed.spmd.region`` ``x`` is the residual stream's
    blocks, and each mixer and MLP runs through ``spmd.site``."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(spmd.on_stream(params["norm1"]), x, cfg.norm, eps)
    if kind == "mamba":
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x + spmd.site("mamba", _mamba, params["mamba"], h, cfg), aux
    x = x + spmd.site("attn", lambda p, h, c, pos: attn.attention_apply(p, h, c, pos, causal),
                      params["attn"], h, cfg, positions, causal=causal)
    if kind == "cross":
        h = norm_apply(spmd.on_stream(params["norm_c"]), x, cfg.norm, eps)
        x = x + spmd.site("cross", _cross, params["cross"], h, cfg, kv_src)
    h = norm_apply(spmd.on_stream(params["norm2"]), x, cfg.norm, eps)
    y, aux = _ffn(params, kind, h, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + y, aux


def shared_block_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    """One shared block of the hybrid sites (``cfg.sites``): an RMSNorm and
    attention over ``cfg.attention_width``, an RMSNorm and the gated MLP
    over d_model, no biases."""
    w, d = cfg.attention_width, cfg.d_model
    return {
        "norm1": norm_init(w, cfg.norm, dtype, device=gen.device),
        "attn": attn.attention_init(gen, cfg, dtype, width=w),
        "norm2": norm_init(d, cfg.norm, dtype, device=gen.device),
        "mlp": mlp_init(gen, d, cfg.d_ff, cfg.act, dtype),
    }


def site_init(gen: torch.Generator, cfg: ModelConfig, dtype=torch.float32):
    """A hybrid site's own leaves: its adapter on the shared MLP's gate_up
    and its d_model × d_model linear."""
    d = cfg.d_model
    return {
        "adapter": adapter_init(gen, d, cfg.sites.adapter_rank, 2 * cfg.d_ff, dtype),
        "linear": dense_init(gen, (d, d), dtype=dtype),
    }


def site_apply(shared, site, x: Tensor, x0: Tensor, cfg: ModelConfig,
               positions: Tensor) -> Tensor:
    """What a hybrid site adds to its mamba block's input: the shared block
    over ``cat(x, x0)`` (no residual), through the site's linear.  Spans:
    ``hybrid.pre`` (the concatenation, its norm, q/k/v and RoPE) and
    ``hybrid.post`` (o, the norm, the adapted MLP and the linear); the
    attention backend's call lies between them."""
    with spans.span("hybrid.pre"):
        h = norm_apply(shared["norm1"], torch.cat([x, x0], dim=-1), cfg.norm, cfg.norm_eps)
        q, k, v = attn.attention_heads(shared["attn"], h, cfg, positions)
    o = resolve_backend(cfg).apply(q, k, v, cfg, causal=True)
    with spans.span("hybrid.post"):
        y = attn.attention_out(shared["attn"], o, x.dtype)
        y = norm_apply(shared["norm2"], y, cfg.norm, cfg.norm_eps)
        y = mlp_apply(shared["mlp"], y, cfg.act, adapter=site["adapter"])
        return y @ site["linear"]["w"].to(x.dtype)


def hybrid_apply(params, shared, site, x: Tensor, x0: Tensor, cfg: ModelConfig,
                 positions: Tensor) -> Tuple[Tensor, Tensor]:
    """A mamba layer at a hybrid site: ``x + mamba(norm(x + s))``, ``s`` the
    site's ``site_apply``; (x, a zero aux loss) as ``block_apply``."""
    s = site_apply(shared, site, x, x0, cfg, positions)
    h = norm_apply(params["norm1"], x + s, cfg.norm, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + _mamba(params["mamba"], h, cfg, positions), aux


def _mamba_prefill(p, h: Tensor, cfg: ModelConfig, n_max: int):
    return get_backend("ssm").prefill(p, h, cfg, n_max)


def _mamba_tokens(p, h: Tensor, cfg: ModelConfig, cache):
    """The token recurrence over ``h`` [b, c, d] (a chunk, as the JAX
    package runs it, not the chunked SSD)."""
    backend, ys = get_backend("ssm"), []
    for i in range(h.shape[1]):
        y_t, cache = backend.decode_step(p, h[:, i], cache, cfg, None)
        ys.append(y_t)
    return torch.stack(ys, dim=1), cache


def block_prefill(
    params, kind: str, x: Tensor, cfg: ModelConfig, n_max: int,
    positions: Optional[Tensor] = None, kv_src: Optional[Tensor] = None,
):
    """Returns (x, cache): a ``MambaCache`` for a mamba block, the pair
    ``(self cache, CrossCache)`` for a cross block, the attention backend's
    state otherwise.  Inside a serve engine's ``spmd.region`` the cache is
    this rank's block of it."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(spmd.on_stream(params["norm1"]), x, cfg.norm, eps)
    if kind == "mamba":
        y, cache = spmd.site("mamba", lambda p, h, c, pos, st: _mamba_prefill(p, h, c, n_max),
                             params["mamba"], h, cfg, state=None)
        return x + y, cache
    y, cache = spmd.site(
        "attn", lambda p, h, c, pos, st: attn.attention_prefill(p, h, c, n_max, pos),
        params["attn"], h, cfg, positions, state=None)
    x = x + y
    if kind == "cross":
        hc = norm_apply(spmd.on_stream(params["norm_c"]), x, cfg.norm, eps)
        y, kv = spmd.site("cross", _cross_prefill, params["cross"], hc, cfg, kv_src,
                          state=None)
        x = x + y
        cache = (cache, CrossCache(kv=kv))
    h2 = norm_apply(spmd.on_stream(params["norm2"]), x, cfg.norm, eps)
    return x + _ffn(params, kind, h2, cfg)[0], cache


def block_decode(params, kind: str, x_t: Tensor, cache, cfg: ModelConfig, pos):
    """One-token step.  Returns (x_t, new_cache)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(spmd.on_stream(params["norm1"]), x_t, cfg.norm, eps)
    if kind == "mamba":
        y, cache = spmd.site(
            "mamba", lambda p, h, c, pos, st: get_backend("ssm").decode_step(p, h, st, c, pos),
            params["mamba"], h, cfg, pos, state=cache)
        return x_t + y, cache
    if kind == "cross":
        cache, ccache = cache
    y, cache = spmd.site(
        "attn", lambda p, h, c, pos, st: attn.attention_decode(p, h, st, c, pos),
        params["attn"], h, cfg, pos, state=cache)
    x_t = x_t + y
    if kind == "cross":
        hc = norm_apply(spmd.on_stream(params["norm_c"]), x_t, cfg.norm, eps)
        y, kv = spmd.site("cross", _cross_read, params["cross"], hc[:, None], cfg,
                          state=ccache.kv)
        x_t = x_t + y[:, 0]
        cache = (cache, CrossCache(kv=kv))
    h2 = norm_apply(spmd.on_stream(params["norm2"]), x_t, cfg.norm, eps)
    # the FFN sees the token as a length-1 sequence [b, 1, d]
    return x_t + _ffn(params, kind, h2[:, None, :], cfg)[0][:, 0, :], cache


def block_prefill_chunk(params, kind: str, x: Tensor, cache, cfg: ModelConfig,
                        positions: Tensor):
    """Advance one block's decode cache by a chunk of prompt tokens: the
    residual structure of ``block_decode`` over ``c`` tokens at once.  A
    mamba block runs its token recurrence (``decode_step``) over the chunk,
    as the JAX package does, not the chunked SSD; a cross block's chunk
    tokens each read its fixed source state.

    Args:
      params: block params.
      kind: block kind.
      x: chunk activations ``[b, c, d_model]``.
      cache: this block's decode cache.
      cfg: model config.
      positions: ``[b, c]`` absolute positions of the chunk tokens.

    Returns:
      ``(x [b, c, d_model], new_cache)``.
    """
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(spmd.on_stream(params["norm1"]), x, cfg.norm, eps)
    if kind == "mamba":
        y, cache = spmd.site("mamba", lambda p, h, c, pos, st: _mamba_tokens(p, h, c, st),
                             params["mamba"], h, cfg, state=cache)
        return x + y, cache
    if kind == "cross":
        cache, ccache = cache
    y, cache = spmd.site(
        "attn", lambda p, h, c, pos, st: attn.attention_prefill_chunk(p, h, st, c, pos),
        params["attn"], h, cfg, positions, state=cache)
    x = x + y
    if kind == "cross":
        hc = norm_apply(spmd.on_stream(params["norm_c"]), x, cfg.norm, eps)
        y, kv = spmd.site("cross", _cross_read, params["cross"], hc, cfg, state=ccache.kv)
        x = x + y
        cache = (cache, CrossCache(kv=kv))
    h2 = norm_apply(spmd.on_stream(params["norm2"]), x, cfg.norm, eps)
    return x + _ffn(params, kind, h2, cfg)[0], cache
