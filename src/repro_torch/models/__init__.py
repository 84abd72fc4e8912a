"""Model layer of the port: config, layers, attention, blocks, decoder LM."""

from repro_torch.models.config import ModelConfig, count_params, schedule_runs
from repro_torch.models.lm import (
    lm_apply,
    lm_decode_step,
    lm_init,
    lm_init_caches,
    lm_prefill,
    lm_prefill_chunk,
    lm_state_bytes,
)

__all__ = [
    "ModelConfig",
    "count_params",
    "lm_apply",
    "lm_decode_step",
    "lm_init",
    "lm_init_caches",
    "lm_prefill",
    "lm_prefill_chunk",
    "lm_state_bytes",
    "schedule_runs",
]
