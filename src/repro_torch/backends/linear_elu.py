"""Katharopoulos et al. (2020) elu+1 linear-attention backend — the paper's
comparison point.

Training and eval run the elu-feature linear attention; decode keeps the
KV cache and the exact-softmax read, as the JAX package does (the baseline
is a train-time quality comparison, not a serving backend: its feature-map
read has no O(1) decode state here).
"""

from __future__ import annotations

from repro_torch.backends.base import AttentionBackend
from repro_torch.backends.softmax import _kv_decode_step, _kv_prefill_cache, _zero_kv
from repro_torch.core import linear_attention


class LinearEluBackend(AttentionBackend):
    """elu(x)+1 linear attention (train/eval); KV-cache softmax decode."""

    name = "linear_elu"
    state_kind = "kv"
    impls = ("torch",)
    supports_paged_kv = True

    def init_cache(self, cfg, batch, n_max, device, dtype):
        return _zero_kv(cfg, batch, n_max, device, dtype)

    def apply(self, q, k, v, cfg, *, causal=True):
        return linear_attention(q, k, v, causal=causal)

    def prefill(self, q, k, v, cfg, n_max):
        return self.apply(q, k, v, cfg, causal=True), _kv_prefill_cache(k, v, n_max)

    def decode_step(self, cache, q, k, v, cfg, pos):
        return _kv_decode_step(cache, q, k, v, pos)
