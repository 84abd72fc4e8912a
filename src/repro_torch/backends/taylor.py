"""The paper's order-1/2 Taylor linear-attention backend.

Two impls, selected by ``ModelConfig.attn_impl``:

  * ``"torch"`` — the plain PyTorch chunked scan / parallel form of
    ``core/taylor.py`` (every TaylorConfig variant: decay, ``sym_state``,
    ``minus_one``, and the non-causal single-state form).
  * ``"cuda"``  — the hand-written CUDA kernels of
    ``kernels/taylor_attention`` for the full-sequence forward and its
    gradient (``apply``, through ``taylor_attention_kernel_trainable``: the
    backward kernel pair inside its envelope, d_v ≤ 128, and the torch
    recompute outside it).  Causal self-attention only, head dim ≤ 128,
    full second moment, no decay, standard (+1) expansion; a forced "cuda"
    outside this envelope is rejected by ``validate``.

``"auto"`` picks the kernel on a CUDA device inside the envelope and the
PyTorch paths otherwise.  Prefill, chunked prefill and decode always run
the moment-state paths of ``core/taylor.py`` (prefill needs the chunk
scan's state handoff; decode is state-bound), as in the JAX package.
"""

from __future__ import annotations

import torch

from repro_torch.backends.base import AttentionBackend
from repro_torch.core import (
    init_taylor_state,
    taylor_attention,
    taylor_attention_chunked,
    taylor_attention_noncausal,
    taylor_decode_step,
    taylor_prefill_state,
)
from repro_torch.kernels.taylor_attention.kernel import MAX_HEAD_DIM
from repro_torch.kernels.taylor_attention.ops import taylor_attention_kernel_trainable


def _kernel_fits(cfg) -> bool:
    """One envelope for both "auto" selection and forced-"cuda" validation."""
    t = cfg.taylor
    return (
        not t.minus_one
        and not t.sym_state
        and t.decay == 1.0
        and cfg.resolved_head_dim <= MAX_HEAD_DIM
    )


class TaylorBackend(AttentionBackend):
    """Order-1/2 Taylor linear attention (PyTorch scan + CUDA kernels)."""

    name = "taylor"
    state_kind = "moments"
    impls = ("torch", "cuda")

    def validate(self, cfg):
        super().validate(cfg)
        t = cfg.taylor
        if cfg.attn_impl != "cuda":
            return
        if t.decay != 1.0:
            raise ValueError(
                "attn_impl='cuda': the CUDA kernels implement the undecayed "
                "recurrence; decay != 1.0 needs attn_impl='torch' (or 'auto')"
            )
        if t.minus_one:
            raise ValueError(
                "attn_impl='cuda': the kernel hardcodes the standard (+1) "
                "expansion; the minus_one variant needs attn_impl='torch'"
            )
        if t.sym_state:
            raise ValueError(
                "attn_impl='cuda': the CUDA kernels use the full second "
                "moment; sym_state is a decode-memory optimisation — use "
                "attn_impl='torch' (or 'auto')"
            )
        if cfg.resolved_head_dim > MAX_HEAD_DIM:
            raise ValueError(
                f"attn_impl='cuda': head_dim {cfg.resolved_head_dim} > "
                f"{MAX_HEAD_DIM} exceeds the kernel's shared-memory envelope "
                "(use attn_impl='torch')"
            )

    def resolve_impl(self, cfg, device: torch.device) -> str:
        if cfg.attn_impl != "auto":
            return cfg.attn_impl
        if device.type == "cuda" and _kernel_fits(cfg):
            return "cuda"
        return "torch"

    # -- protocol ------------------------------------------------------------

    def init_cache(self, cfg, batch, n_max, device, dtype):
        hd = cfg.resolved_head_dim
        return init_taylor_state(batch, cfg.n_kv_heads, hd, hd, cfg.taylor,
                                 device=device)

    def apply(self, q, k, v, cfg, *, causal=True):
        if not causal:
            return taylor_attention_noncausal(q, k, v, cfg.taylor)
        if self.resolve_impl(cfg, q.device) == "cuda":
            return taylor_attention_kernel_trainable(
                q, k, v, cfg.taylor, chunk=cfg.attn_chunk, backward="auto"
            )
        return taylor_attention(q, k, v, cfg.taylor, causal=True, chunk=cfg.attn_chunk)

    def prefill(self, q, k, v, cfg, n_max):
        n = q.shape[2]
        if n % cfg.attn_chunk == 0 and n > cfg.attn_chunk:
            return taylor_attention_chunked(
                q, k, v, cfg.taylor, chunk=cfg.attn_chunk, return_state=True
            )
        o = taylor_attention(q, k, v, cfg.taylor, causal=True)
        return o, taylor_prefill_state(k, v, cfg.taylor)

    def decode_step(self, cache, q, k, v, cfg, pos):
        return taylor_decode_step(cache, q, k, v, cfg.taylor)

    def prefill_chunk(self, cache, q, k, v, cfg, pos):
        """Chunk-scan continuation: one intra-chunk tile plus the read of the
        carried moment state (``initial_state``), for every variant the
        torch paths cover (decay, ``sym_state``).  ``pos`` is unused: the
        moment state is position-free and RoPE is applied by the model
        layer.  Returns ``(out [b, h, c, dv], new TaylorState)``."""
        del pos
        return taylor_attention_chunked(
            q, k, v, cfg.taylor, chunk=q.shape[2], initial_state=cache, return_state=True
        )

    def state_health(self, cache, cfg):
        """Finite moments AND a non-negative token count ``n0`` per row
        (full or ``sym_state``-packed second moments alike)."""
        return super().state_health(cache, cfg) & (cache.n0 >= 0).all(dim=-1)
