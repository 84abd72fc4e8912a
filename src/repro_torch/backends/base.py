"""The attention-backend protocol: one contract for every way attention is
computed.

A backend is a stateless singleton describing ONE attention algorithm: how
to run it over a full sequence (``apply``), how to prefill a prompt into a
decode state (``prefill``), how to advance that state by one token
(``decode_step``) or by a chunk of prompt tokens (``prefill_chunk``) and
how to check a state's health.  The model layer and
the serve engine resolve backends exclusively through
``repro_torch.backends.registry``.  Methods take projected heads: q
``[b, h, n, d]``, k/v ``[b, hk, n, ·]`` (single-token: ``[b, h, d]``).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.backends.state import tree_slot_health

Tensor = torch.Tensor


class AttentionBackend:
    """Base class + protocol of one attention algorithm."""

    name: str = ""
    state_kind: str = "kv"  # "kv" | "moments"
    impls: Tuple[str, ...] = ("torch",)

    @property
    def bounded_state(self) -> bool:
        """True when the decode state is O(1) in context length: moments
        are, a full KV cache is not; a bounded KV ring (``softmax_window``)
        overrides this.  The per-layer gate behind
        ``ModelConfig.supports_long_context``."""
        return self.state_kind != "kv"

    def validate(self, cfg) -> None:
        """Raise ``ValueError`` for configs this backend cannot execute."""
        if cfg.attn_impl != "auto" and cfg.attn_impl not in self.impls:
            raise ValueError(
                f"attention backend {self.name!r} has impls {self.impls}; "
                f"attn_impl={cfg.attn_impl!r} is not one of them"
            )

    def resolve_impl(self, cfg, device: torch.device) -> str:
        """Concrete impl for a run on ``device``: ``cfg.attn_impl`` unless
        "auto"."""
        if cfg.attn_impl != "auto":
            return cfg.attn_impl
        return self.impls[0]

    def init_cache(self, cfg, batch: int, n_max: int, device, dtype: torch.dtype) -> Any:
        """Zero decode state for ``batch`` rows; KV leaves in ``dtype``
        (moment states stay float32)."""
        raise NotImplementedError(self.name)

    def apply(self, q: Tensor, k: Tensor, v: Tensor, cfg, *, causal: bool = True) -> Tensor:
        """Full-sequence attention.  Returns ``[b, h, n, dv]``."""
        raise NotImplementedError(self.name)

    def prefill(self, q: Tensor, k: Tensor, v: Tensor, cfg, n_max: int):
        """Causal full-sequence pass that also returns the decode state:
        ``(out [b, h, n, dv], cache)``."""
        raise NotImplementedError(self.name)

    def decode_step(self, cache, q: Tensor, k: Tensor, v: Tensor, cfg, pos: Tensor):
        """One autoregressive step (the new token attends to itself).
        Returns ``(out [b, h, dv], new_cache)``."""
        raise NotImplementedError(self.name)

    def prefill_chunk(self, cache, q: Tensor, k: Tensor, v: Tensor, cfg, pos: Tensor):
        """Advance a decode state by a CHUNK of prompt tokens in one call.

        The chunked-prefill building block: ``decode_step`` applied token by
        token over the chunk.  Backends override it with a batched form when
        one exists (the Taylor chunk scan continues from ``cache``).

        Args:
          cache: decode state to continue from (``init_cache`` zeros or the
            state of the previous chunk).
          q: chunk queries ``[b, h, c, d]``.
          k: chunk keys ``[b, hk, c, d]`` (``h % hk == 0``).
          v: chunk values ``[b, hk, c, dv]``.
          cfg: model config.
          pos: ``[b, c]`` int32 absolute 0-based positions of the chunk tokens.

        Returns:
          ``(out [b, h, c, dv], new_cache)`` — ``out[:, :, i]`` attends to
          every chunk token ``<= i`` plus everything already in ``cache``.
        """
        outs = []
        for i in range(q.shape[2]):
            o, cache = self.decode_step(cache, q[:, :, i], k[:, :, i], v[:, :, i], cfg,
                                        pos[:, i])
            outs.append(o)
        return torch.stack(outs, dim=2), cache

    def state_health(self, cache, cfg) -> Tensor:
        """``[b]`` bool: True where every floating leaf of the row is finite."""
        return tree_slot_health(cache)
