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
    full second moment, no decay, standard (+1) expansion, and no model
    with cross blocks (the JAX package keeps its Pallas kernels off the
    encoder-decoder and VLM families too); a forced "cuda" outside this
    envelope is rejected by ``validate``.

``"auto"`` picks the kernel on a CUDA device inside the envelope and the
PyTorch paths otherwise.  Under ``attn_sharding="cp"`` inside a sharding
context, ``apply`` runs the context-parallel chunk scan on the rank's
sequence block (``core/context_parallel.py``) and no kernel: the kernel
has no state handoff, and the envelope excludes cp as the reference's
does.  Prefill, chunked prefill and decode always run
the moment-state paths of ``core/taylor.py`` (prefill needs the chunk
scan's state handoff; decode is state-bound), as in the JAX package.
A cross block's source state is the moment state of its whole source
(``cross_state``), read by each decoder token (``cross_read``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.backends.base import AttentionBackend
from repro_torch.core import (
    TaylorState,
    init_taylor_state,
    merge_states,
    taylor_attention,
    taylor_attention_chunked,
    taylor_attention_noncausal,
    taylor_decode_step,
    taylor_prefill_state,
    taylor_state_read,
)
from repro_torch.device import on_card
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
        and cfg.attn_sharding != "cp"
        and not AttentionBackend._uses_cross(cfg)
    )


class TaylorBackend(AttentionBackend):
    """Order-1/2 Taylor linear attention (PyTorch scan + CUDA kernels)."""

    name = "taylor"
    state_kind = "moments"
    supports_cross = True
    supports_cp = True
    impls = ("torch", "cuda")
    # The O(1) moment state may be held int8/fp8-quantised between serve
    # dispatches, with per-head power-of-two scales; absorbs and reads run
    # in float32 (serve/state_repr.py).
    state_dtypes = ("dense", "int8", "fp8")
    value_leaves = ("s0", "s1", "s2")

    def validate(self, cfg):
        super().validate(cfg)
        t = cfg.taylor
        if t.decay != 1.0 and cfg.attn_sharding == "cp":
            raise ValueError(
                "taylor decay is incompatible with context parallelism: "
                "shard-state merge is addition, which a decayed state "
                "violates (shard b must discount shard a by γ^len)"
            )
        if t.decay != 1.0 and self._uses_cross(cfg):
            raise ValueError(
                "taylor decay is causal-self-attention only, but the model has "
                "cross/encoder blocks (a position-decayed global source state "
                "is ill-defined)"
            )
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
        if cfg.attn_sharding == "cp":
            raise ValueError(
                "attn_impl='cuda': context parallelism runs the torch chunked "
                "scan (the kernel has no state handoff); use attn_impl='auto' "
                "or 'torch' with attn_sharding='cp'"
            )
        if self._uses_cross(cfg):
            raise ValueError(
                "attn_impl='cuda': the kernel is causal-self-attention only, "
                "but the model has cross blocks — use attn_impl='auto' or 'torch'"
            )

    def resolve_impl(self, cfg, device: torch.device) -> str:
        if cfg.attn_impl != "auto":
            return cfg.attn_impl
        if on_card(device) and _kernel_fits(cfg):
            return "cuda"
        return "torch"

    def draft_config(self, cfg):
        """Order-1 same-weights self-draft (the paper's order hierarchy).

        Drops the second-moment terms: the draft state is ``(n0, s0, z1,
        s1)`` only, and the target's weights are reused as they are (the
        Taylor feature map has no parameters).

        Returns:
          ``cfg`` with ``taylor.order = 1`` and ``attn_impl = "torch"``
          (the draft only prefills and decodes, which run the moment-state
          paths), or ``None`` when the target is already order 1 or has a
          hybrid schedule (the order hierarchy covers the taylor layers
          only).
        """
        if cfg.taylor.order < 2 or cfg.attention_schedule:
            return None
        return cfg.replace(taylor=dataclasses.replace(cfg.taylor, order=1), attn_impl="torch")

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
        if cfg.attn_sharding == "cp":
            o = self._maybe_cp(q, k, v, cfg)
            if o is not None:
                return o
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

    def merge_state(self, a, b):
        return merge_states(a, b)

    def cache_pspec(self, cfg):
        """Logical axes of the ``TaylorState`` moments: slots over "dp", kv
        heads over "tp"; where the kv heads do not divide (MQA) the
        resolver puts "tp" on each leaf's last dim instead (d_v of s0, s1,
        s2; the key dim of z1, z2)."""
        from repro_torch.distributed.api import P  # noqa: PLC0415

        t = cfg.taylor
        second = t.order >= 2
        # sym_state packs z2/s2 to [b, k, D2(, v)]; same leading axes
        z2 = P("dp", "tp", None) if t.sym_state else P("dp", "tp", None, None)
        s2 = P("dp", "tp", None, None) if t.sym_state else P("dp", "tp", None, None, None)
        return TaylorState(n0=P("dp", "tp"), s0=P("dp", "tp", None), z1=P("dp", "tp", None),
                           s1=P("dp", "tp", None, None), z2=z2 if second else None,
                           s2=s2 if second else None)

    def apply_cp(self, q, k, v, cfg, mesh, axis, dp_axis=None):
        from repro_torch.core.context_parallel import (  # noqa: PLC0415 (cycle)
            taylor_attention_context_parallel,
        )

        return taylor_attention_context_parallel(
            q, k, v, cfg.taylor, mesh, axis, chunk=cfg.attn_chunk, dp_axis=dp_axis
        )

    def _maybe_cp(self, q, k, v, cfg):
        """Context parallelism inside a sharding context, where ``q``/``k``/
        ``v`` are this rank's sequence blocks (``distributed/spmd.py`` splits
        the sequence over the "sp" axis only when each block divides into
        chunks); ``None`` outside one, and the caller runs the unsharded
        scan."""
        from repro_torch.core.context_parallel import taylor_cp_local  # noqa: PLC0415
        from repro_torch.distributed import api as dist  # noqa: PLC0415 (cycle)

        ctx = dist.active()
        if ctx is None:
            return None
        mesh, rules = ctx
        seq_ax = rules.get("sp") or rules.get("tp")
        if seq_ax is None or q.shape[2] % cfg.attn_chunk != 0:
            return None
        return taylor_cp_local(q, k, v, cfg.taylor, mesh, seq_ax, cfg.attn_chunk)

    # -- cross-attention -----------------------------------------------------

    def init_cross_cache(self, cfg, batch, n_src, device, dtype):
        hd = cfg.resolved_head_dim
        return init_taylor_state(batch, cfg.n_kv_heads, hd, hd, cfg.taylor, device=device)

    def cross_state(self, k, v, cfg):
        return taylor_prefill_state(k, v, cfg.taylor)

    def cross_read(self, state, q, cfg):
        return taylor_state_read(state, q, cfg.taylor)
