"""Exact-softmax attention backend (dense + flash execution).

The baseline the paper approximates.  One "torch" impl with an internal
dense/flash split: short sequences use the dense path, long chunk-multiple
sequences the online-softmax loop over key chunks (same numerics, bounded
memory).  Decode state is a fixed-capacity per-row KV cache; a cross
block's source state is its projected K/V, read whole by every token.
"""

from __future__ import annotations

import torch

from repro_torch.backends.base import AttentionBackend
from repro_torch.backends.state import KVCache, tree_slot_health
from repro_torch.core import flash_softmax_attention, softmax_attention, softmax_decode_step

Tensor = torch.Tensor

# Sequence length above which the flash loop replaces the dense path (and
# the dense n×n score tile stops being a rounding error in memory).
_FLASH_MIN_SEQ = 2048


def _zero_kv(cfg, batch: int, n: int, device, dtype) -> KVCache:
    """An empty cache of ``n`` entries per row (k and v are distinct
    tensors: the slot operations write them in place)."""
    shape = (batch, cfg.n_kv_heads, n, cfg.resolved_head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _kv_prefill_cache(k: Tensor, v: Tensor, n_max: int) -> KVCache:
    """Prompt K/V written into a zeroed n_max-capacity cache (shared by the
    softmax and linear_elu backends)."""
    b, hk, n, hd = k.shape
    cache_k = k.new_zeros((b, hk, n_max, hd))
    cache_v = v.new_zeros((b, hk, n_max, v.shape[-1]))
    cache_k[:, :, :n] = k
    cache_v[:, :, :n] = v
    return KVCache(k=cache_k, v=cache_v,
                   length=torch.full((b,), n, dtype=torch.int32, device=k.device))


def _write_at(cache: Tensor, x: Tensor, idx: Tensor) -> Tensor:
    """A copy of ``cache`` [b, hk, n, ·] with entry ``idx[r]`` of row r set
    to ``x[r]`` ([b, hk, ·]); ``cache`` itself is left as it is."""
    b, hk, width = x.shape
    index = idx.long().reshape(b, 1, 1, 1).expand(b, hk, 1, width)
    return cache.scatter(2, index, x[:, :, None, :].to(cache.dtype))


def _kv_decode_step(cache: KVCache, q: Tensor, k: Tensor, v: Tensor, pos: Tensor):
    """Write this token's k/v at each row's position, then read with the
    exact softmax over the valid prefix.

    Retired slots keep a frozen pos; BOTH the write index and the length
    are clamped to capacity so a retired slot can neither write out of
    bounds nor claim more valid entries than the cache holds (its slot is
    fully overwritten on re-admission)."""
    n_max = cache.k.shape[2]
    idx = pos.clamp(max=n_max - 1)
    cache = KVCache(k=_write_at(cache.k, k, idx), v=_write_at(cache.v, v, idx),
                    length=(pos + 1).clamp(max=n_max).to(torch.int32))
    return softmax_decode_step(q, cache.k, cache.v, cache.length), cache


class SoftmaxBackend(AttentionBackend):
    """Exact softmax attention: the flash loop for long sequences, KV-cache
    decode."""

    name = "softmax"
    state_kind = "kv"
    supports_cross = True
    impls = ("torch",)
    supports_paged_kv = True

    def init_cache(self, cfg, batch, n_max, device, dtype):
        return _zero_kv(cfg, batch, n_max, device, dtype)

    def apply(self, q, k, v, cfg, *, causal=True):
        n = k.shape[2]
        if n > _FLASH_MIN_SEQ and n % cfg.attn_chunk == 0:
            return flash_softmax_attention(
                q, k, v, causal=causal, chunk=max(cfg.attn_chunk, 512)
            )
        return softmax_attention(q, k, v, causal=causal)

    def prefill(self, q, k, v, cfg, n_max):
        return self.apply(q, k, v, cfg, causal=True), _kv_prefill_cache(k, v, n_max)

    def decode_step(self, cache, q, k, v, cfg, pos):
        return _kv_decode_step(cache, q, k, v, pos)

    def state_health(self, cache, cfg):
        """Finite K/V entries AND a ``length`` within ``[0, n_max]``: an
        out-of-range length makes the masked read use garbage (or nothing),
        a corruption even though the int leaf can never be NaN.

        Returns:
          ``[b]`` bool — True where the row's cache is usable.
        """
        n_max = cache.k.shape[2]
        return tree_slot_health(cache) & (cache.length >= 0) & (cache.length <= n_max)

    def init_cross_cache(self, cfg, batch, n_src, device, dtype):
        cache = _zero_kv(cfg, batch, n_src, device, dtype)
        return cache._replace(length=cache.length.fill_(n_src))

    def cross_state(self, k, v, cfg):
        length = torch.full((k.shape[0],), k.shape[2], dtype=torch.int32, device=k.device)
        return KVCache(k=k, v=v, length=length)

    def cross_read(self, state, q, cfg):
        return softmax_decode_step(q, state.k, state.v, state.length)
