"""Model layer of the port: config, layers, attention, MoE, Mamba2 (SSD),
blocks, and the decoder-only, encoder-decoder and VLM assembly."""

from repro_torch.models.config import (
    ModelConfig,
    MoEConfig,
    SiteConfig,
    SSMConfig,
    count_active_params,
    count_params,
    schedule_runs,
)
from repro_torch.models.lm import (
    lm_apply,
    lm_decode_step,
    lm_init,
    lm_init_caches,
    lm_prefill,
    lm_prefill_chunk,
    lm_state_bytes,
    lm_verify_chunk,
)

__all__ = [
    "ModelConfig",
    "MoEConfig",
    "SiteConfig",
    "SSMConfig",
    "count_active_params",
    "count_params",
    "lm_apply",
    "lm_decode_step",
    "lm_init",
    "lm_init_caches",
    "lm_prefill",
    "lm_prefill_chunk",
    "lm_state_bytes",
    "lm_verify_chunk",
    "schedule_runs",
]
