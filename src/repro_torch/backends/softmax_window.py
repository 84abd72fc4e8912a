"""Sliding-window exact-softmax backend with an O(window) ring-buffer KV.

Each query attends exactly to the last ``cfg.attn_window`` tokens
(inclusive), so decode state stays bounded: the KV ring holds
``min(attn_window, n_max)`` entries per kv head whatever the context length.

Ring semantics: the token at absolute position ``p`` writes slot ``p % W``.
``KVCache.length`` holds the TOTAL tokens seen (unclamped, unlike the
full-softmax backend): the valid-slot mask ``arange(W) < length`` is right
both while the ring fills (a prefix of it valid) and once it has wrapped
(all W slots valid), and softmax does not care about the slots' order,
since RoPE is applied to k at its ABSOLUTE position before it enters the
backend.
"""

from __future__ import annotations

import math

import torch

from repro_torch.backends.base import AttentionBackend
from repro_torch.backends.softmax import _write_at, _zero_kv
from repro_torch.backends.state import KVCache, tree_slot_health
from repro_torch.core import softmax_decode_step
from repro_torch.core.softmax import NEG_INF

Tensor = torch.Tensor


def _window_of(cfg, n_max: int) -> int:
    """Ring capacity: the window, clamped to the cache's token budget (a
    ring larger than ``n_max`` can never wrap)."""
    return min(cfg.attn_window, n_max)


def window_attention(q: Tensor, k: Tensor, v: Tensor, window: int, scale=None) -> Tensor:
    """Banded-causal softmax: query ``i`` attends to ``j`` with
    ``i - window < j <= i``.

    Args:
      q: ``[b, h, n, d]`` queries.
      k: ``[b, hk, n, d]`` keys (GQA: ``h % hk == 0``).
      v: ``[b, hk, n, dv]`` values.
      window: band width in tokens (inclusive of the query's own position).
      scale: logit scale (default ``1/sqrt(d)``).

    Returns:
      ``[b, h, n, dv]`` attention output.
    """
    b, h, n, d = q.shape
    h_kv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qg = q.reshape(b, h_kv, h // h_kv, n, d)
    s = torch.einsum("bkgid,bkjd->bkgij", qg.float(), k.float()) * scale
    iq = torch.arange(n, device=q.device)[:, None]
    jk = torch.arange(n, device=q.device)[None, :]
    band = (jk <= iq) & (jk > iq - window)
    s = s.masked_fill(~band, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgij,bkjv->bkgiv", p, v.float())
    return o.reshape(b, h, n, v.shape[-1]).to(v.dtype)


def _ring_from_sequence(k: Tensor, v: Tensor, w: int) -> KVCache:
    """The post-prefill ring: slot ``s`` holds the LAST token whose absolute
    position is ``≡ s (mod w)`` — exactly the cache that ``n`` calls of the
    decode step's ``pos % w`` write would have left."""
    b, hk, n, hd = k.shape
    s = torch.arange(w, device=k.device)
    p = torch.remainder(s - n, w) + n - w  # last pos written to slot s (< 0: never)
    never = (p < 0)[None, None, :, None]
    idx = p.clamp(0, n - 1)
    return KVCache(
        k=k.index_select(2, idx).masked_fill(never, 0),
        v=v.index_select(2, idx).masked_fill(never, 0),
        length=torch.full((b,), n, dtype=torch.int32, device=k.device),
    )


class SoftmaxWindowBackend(AttentionBackend):
    """Sliding-window softmax: banded-causal apply, O(window) KV ring decode.
    ``length`` counts TOTAL tokens seen (it may exceed the ring capacity);
    the read mask and the ``pos % W`` write both derive from it, so the
    prefill → decode handoff is exact."""

    name = "softmax_window"
    state_kind = "kv"
    impls = ("torch",)
    supports_paged_kv = False  # the ring is O(window) already

    @property
    def bounded_state(self) -> bool:
        """True — the ring holds at most ``attn_window`` tokens."""
        return True

    def init_cache(self, cfg, batch, n_max, device, dtype):
        return _zero_kv(cfg, batch, _window_of(cfg, n_max), device, dtype)

    def apply(self, q, k, v, cfg, *, causal=True):
        if not causal:
            raise ValueError(
                "softmax_window is causal-only (non-causal windowed attention "
                "is ill-defined); use the softmax backend for encoder blocks"
            )
        return window_attention(q, k, v, cfg.attn_window)

    def prefill(self, q, k, v, cfg, n_max):
        out = self.apply(q, k, v, cfg, causal=True)
        return out, _ring_from_sequence(k, v, _window_of(cfg, n_max))

    def decode_step(self, cache, q, k, v, cfg, pos):
        idx = torch.remainder(pos, cache.k.shape[2])
        cache = KVCache(k=_write_at(cache.k, k, idx), v=_write_at(cache.v, v, idx),
                        length=(pos + 1).to(torch.int32))
        return softmax_decode_step(q, cache.k, cache.v, cache.length), cache

    def state_health(self, cache, cfg):
        """Finite K/V and a non-negative token count.  There is NO upper bound
        on ``length``: it counts total tokens seen, which rightly exceeds the
        ring capacity once the window wraps.

        Returns:
          ``[b]`` bool — True where the row's ring is usable.
        """
        return tree_slot_health(cache) & (cache.length >= 0)
