"""Core: the paper's higher-order (Taylor) linear attention and its
baselines (exact softmax, elu+1 linear attention), in PyTorch."""

from repro_torch.core.feature_map import (
    TaylorConfig,
    elu_features,
    layernorm_no_affine,
    poly_scores,
    symvec,
    taylor_features,
)
from repro_torch.core.linear import linear_attention
from repro_torch.core.softmax import (
    flash_softmax_attention,
    softmax_attention,
    softmax_decode_step,
)
from repro_torch.core.taylor import (
    TaylorState,
    chunked_num_den,
    decay_gammas,
    init_taylor_state,
    merge_states,
    taylor_attention,
    taylor_attention_chunked,
    taylor_attention_noncausal,
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
    "decay_gammas",
    "elu_features",
    "flash_softmax_attention",
    "init_taylor_state",
    "layernorm_no_affine",
    "linear_attention",
    "merge_states",
    "poly_scores",
    "softmax_attention",
    "softmax_decode_step",
    "symvec",
    "taylor_attention",
    "taylor_attention_chunked",
    "taylor_attention_noncausal",
    "taylor_attention_parallel",
    "taylor_attention_recurrent",
    "taylor_decode_step",
    "taylor_features",
    "taylor_prefill_state",
    "taylor_state_read",
]
