"""Causal Taylor attention: CUDA kernels, their wrappers and plain versions."""

from repro_torch.kernels.taylor_attention.kernel import taylor_bwd, taylor_fwd
from repro_torch.kernels.taylor_attention.ops import (
    taylor_attention_kernel,
    taylor_attention_kernel_trainable,
)
from repro_torch.kernels.taylor_attention.ref import (
    taylor_attention_bwd_ref,
    taylor_attention_ref,
)

__all__ = [
    "taylor_attention_bwd_ref",
    "taylor_attention_kernel",
    "taylor_attention_kernel_trainable",
    "taylor_attention_ref",
    "taylor_bwd",
    "taylor_fwd",
]
