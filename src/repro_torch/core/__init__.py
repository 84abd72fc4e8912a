"""Core: the paper's higher-order (Taylor) linear attention, in PyTorch."""

from repro_torch.core.feature_map import TaylorConfig, layernorm_no_affine, poly_scores
from repro_torch.core.taylor import (
    TaylorState,
    chunked_num_den,
    init_taylor_state,
    merge_states,
    taylor_attention,
    taylor_attention_chunked,
    taylor_attention_parallel,
    taylor_attention_recurrent,
    taylor_decode_step,
    taylor_prefill_state,
    taylor_state_read,
)

__all__ = [
    "TaylorConfig",
    "TaylorState",
    "chunked_num_den",
    "init_taylor_state",
    "layernorm_no_affine",
    "merge_states",
    "poly_scores",
    "taylor_attention",
    "taylor_attention_chunked",
    "taylor_attention_parallel",
    "taylor_attention_recurrent",
    "taylor_decode_step",
    "taylor_prefill_state",
    "taylor_state_read",
]
