"""Causal Taylor attention: CUDA forward kernel, its wrapper and plain version."""

from repro_torch.kernels.taylor_attention.kernel import taylor_fwd
from repro_torch.kernels.taylor_attention.ops import taylor_attention_kernel
from repro_torch.kernels.taylor_attention.ref import taylor_attention_ref

__all__ = ["taylor_attention_kernel", "taylor_attention_ref", "taylor_fwd"]
