"""Mamba2 (SSD) as a block-level backend.

SSD is linear attention with a per-step decay (``models/ssm.py``), so its
recurrent state sits in the same registry as the attention states: the
mamba blocks of ``models/blocks.py`` and the caches of ``models/lm.py``
resolve it through ``get_backend("ssm")``.

``level = "block"``: Mamba fuses its own projections, conv and gating, so
the protocol methods take the BLOCK params and ``[b, n, d_model]``
activations instead of projected q/k/v.  "ssm" is therefore a block kind
(``pattern=("mamba", ...)``), never ``ModelConfig.attention``:
``resolve_backend`` rejects it there.

Its states merge across sequence shards with decay weights, not by the
plain sum of the Taylor moments, so ``merge_state`` raises.
"""

from __future__ import annotations

from repro_torch.backends.base import AttentionBackend
from repro_torch.backends.state import tree_slot_health


class SSMBackend(AttentionBackend):
    """Mamba2/SSD block backend: O(1) ``[b, H, P, N]`` recurrent state."""

    name = "ssm"
    level = "block"
    state_kind = "ssm"
    impls = ("torch",)

    def init_cache(self, cfg, batch, n_max, device, dtype):
        """Zero ``MambaCache``: conv in ``dtype``, the SSD state float32."""
        from repro_torch.models.ssm import mamba_init_cache  # noqa: PLC0415 (cycle)

        return mamba_init_cache(cfg, batch, device, dtype)

    def apply(self, params, x, cfg, *, causal=True):
        """The block's full-sequence SSD (chunk ``cfg.attn_chunk``)."""
        from repro_torch.models import ssm  # noqa: PLC0415 (cycle)

        if not causal:
            raise NotImplementedError("SSD is a causal recurrence")
        return ssm.mamba_apply(params, x, cfg, chunk=cfg.attn_chunk)

    def prefill(self, params, x, cfg, n_max):
        """``(y [b, n, d_model], MambaCache)`` of a prompt."""
        from repro_torch.models import ssm  # noqa: PLC0415 (cycle)

        return ssm.mamba_prefill(params, x, cfg)

    def decode_step(self, params, x_t, cache, cfg, pos):
        """One token ``x_t`` [b, d_model]: ``(y_t, new MambaCache)``."""
        from repro_torch.models import ssm  # noqa: PLC0415 (cycle)

        return ssm.mamba_decode_step(params, x_t, cache, cfg)

    def state_health(self, cache, cfg):
        """SSD-state health: the conv window and the ``[b, H, P, N]`` state
        finite.  SSD's decay keeps a healthy state bounded, so a NaN/Inf here
        is injected or overflowed: quarantine either way.

        Returns:
          ``[b]`` bool — True where the row's state is usable.
        """
        return tree_slot_health(cache)

    def cache_pspec(self, cfg):
        """Logical axes of the ``MambaCache``: slots over "dp", the conv
        channels of ``conv [b, W-1, channels]`` and the SSD heads of ``ssd
        [b, H, P, N]`` over "tp"."""
        from repro_torch.distributed.api import P  # noqa: PLC0415
        from repro_torch.models.ssm import MambaCache  # noqa: PLC0415 (cycle)

        return MambaCache(conv=P("dp", None, "tp"), ssd=P("dp", "tp", None, None))

    def merge_state(self, a, b):
        raise NotImplementedError(
            "SSD states merge with decay weighting, not addition "
            "(core/ssd_context_parallel.py)"
        )
