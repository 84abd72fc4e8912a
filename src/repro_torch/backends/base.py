"""The attention-backend protocol: one contract for every way attention is
computed.

A backend is a stateless singleton describing ONE attention algorithm: how
to run it over a full sequence (``apply``), how to prefill a prompt into a
decode state (``prefill``), how to advance that state by one token
(``decode_step``) or by a chunk of prompt tokens (``prefill_chunk``), how
to check a state's health and, where ``supports_cross``, how to read a
fixed source as cross-attention (``init_cross_cache``, ``cross_state``,
``cross_read``).  The model layer and
the serve engine resolve backends exclusively through
``repro_torch.backends.registry``.

Two protocol levels (the ``level`` flag):

  * ``"qkv"``   — the methods take projected heads: q ``[b, h, n, d]``,
    k/v ``[b, hk, n, ·]`` (single-token: ``[b, h, d]``).  Every attention
    backend; only these can be ``ModelConfig.attention``.
  * ``"block"`` — the backend fuses its own projections, so the methods
    take the block's params and ``[b, n, d_model]`` activations (the SSM
    backend: a block kind, not an attention choice).
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.backends.state import tree_slot_health

Tensor = torch.Tensor


class AttentionBackend:
    """Base class + protocol of one attention algorithm."""

    name: str = ""
    level: str = "qkv"  # "qkv" | "block"
    state_kind: str = "kv"  # "kv" | "moments" | "ssm"
    # Can serve as the cross-attention of "cross" blocks (encoder-decoder and
    # VLM models); ``validate`` refuses a model with cross blocks otherwise.
    supports_cross: bool = False
    # Has a mergeable state, so its full-sequence attention can shard the
    # sequence over a mesh axis (``apply_cp``; ``attn_sharding="cp"``).
    supports_cp: bool = False
    impls: Tuple[str, ...] = ("torch",)
    # Serve-layer slot-state representations: which compact encodings of
    # this backend's decode state the engine may hold between dispatches
    # (``serve/state_repr.py``).  Compute always runs dense; these flags
    # only gate what ``ServeEngine(state_dtype=..., kv_page_size=...)``
    # accepts.
    state_dtypes: Tuple[str, ...] = ("dense",)
    supports_paged_kv: bool = False
    # The decode state's leaves whose last dim is the value head dim d_v:
    # where the kv heads do not divide a mesh's "model" axis, a serve
    # engine splits these by their d_v columns (``cache_pspec``'s fallback)
    # and gathers the others around each step (``distributed/spmd.py``).
    value_leaves: Tuple[str, ...] = ("v",)

    @property
    def bounded_state(self) -> bool:
        """True when the decode state is O(1) in context length: moments
        and an SSM state are, a full KV cache is not; a bounded KV ring (``softmax_window``)
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
        if self._uses_cross(cfg) and not self.supports_cross:
            raise ValueError(
                f"attention backend {self.name!r} does not support "
                f"cross-attention (supports_cross=False) but the model has "
                f"cross blocks: {cfg.pattern + cfg.tail}"
            )
        if cfg.attn_sharding == "cp" and not self.supports_cp:
            raise ValueError(
                f"attention backend {self.name!r} does not support context "
                "parallelism (supports_cp=False); use attn_sharding='tp'"
            )

    @staticmethod
    def _uses_cross(cfg) -> bool:
        """True for a model with cross blocks or an encdec/vlm family."""
        kinds = cfg.pattern + cfg.tail + cfg.encoder_pattern
        return "cross" in kinds or cfg.family in ("vlm", "encdec")

    def resolve_impl(self, cfg, device: torch.device) -> str:
        """Concrete impl for a run on ``device``: ``cfg.attn_impl`` unless
        "auto"."""
        if cfg.attn_impl != "auto":
            return cfg.attn_impl
        return self.impls[0]

    def draft_config(self, cfg):
        """Cheaper same-weights config for speculative self-drafting, or
        ``None`` when this backend has none (the serve layer then rejects
        ``draft="order1"`` requests at submit time)."""
        return None

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

    def merge_state(self, a, b):
        """Merge the states of two CONSECUTIVE sequence shards (context
        parallelism).  Only meaningful when ``supports_cp``."""
        raise NotImplementedError(
            f"attention backend {self.name!r} has no mergeable state "
            "(supports_cp=False)"
        )

    def apply_cp(self, q: Tensor, k: Tensor, v: Tensor, cfg, mesh, axis: str,
                 dp_axis=None) -> Tensor:
        """Context-parallel full-sequence attention over whole tensors: the
        sequence sharded over mesh ``axis``, O(1) state exchanged.  Only when
        ``supports_cp``."""
        raise NotImplementedError(
            f"attention backend {self.name!r} does not support context "
            "parallelism"
        )

    def state_health(self, cache, cfg) -> Tensor:
        """``[b]`` bool: True where every floating leaf of the row is finite."""
        return tree_slot_health(cache)

    # -- decode-state sharding (mesh serving) --------------------------------

    def cache_pspec(self, cfg):
        """Logical axes of this backend's decode state: a tree congruent to
        ``init_cache``'s output whose leaves are ``P``s of logical names
        ("dp" the slot axis, "tp" the head axis), resolved against a mesh
        by ``distributed.sharding.slot_cache_specs``.  Where the head dim
        does not divide, the resolver moves "tp" to the leaf's last dim
        (MQA: d_v).  The default is the KV-cache layout; O(1)-state
        backends override it beside ``init_cache``."""
        from repro_torch.backends.state import kv_cache_pspec  # noqa: PLC0415 (cycle)

        return kv_cache_pspec()

    def cross_cache_pspec(self, cfg):
        """Logical axes of the cross-attention read state: every backend's
        cross state mirrors its decode state, so ``cache_pspec``."""
        return self.cache_pspec(cfg)

    def init_cross_cache(self, cfg, batch: int, n_src: int, device, dtype: torch.dtype):
        """Zero cross-attention state for a source of ``n_src`` tokens."""
        raise NotImplementedError(
            f"attention backend {self.name!r} does not support cross-attention")

    def cross_state(self, k: Tensor, v: Tensor, cfg):
        """The cross-attention read state of projected source k/v
        ``[b, hk, n_src, ·]``."""
        raise NotImplementedError(
            f"attention backend {self.name!r} does not support cross-attention")

    def cross_read(self, state, q: Tensor, cfg) -> Tensor:
        """One decode step's cross-attention: q ``[b, h, d]`` against the
        fixed state.  Returns ``[b, h, dv]``."""
        raise NotImplementedError(
            f"attention backend {self.name!r} does not support cross-attention")
