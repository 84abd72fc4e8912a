"""Attention backends of the port: the registry, the paper's Taylor backend,
its baselines (exact softmax, sliding-window softmax, elu+1 linear) and the
block-level Mamba2 (SSD) backend."""

from repro_torch.backends.base import AttentionBackend
from repro_torch.backends.linear_elu import LinearEluBackend
from repro_torch.backends.registry import (
    available_backends,
    get_backend,
    register_backend,
    resolve_backend,
    state_backend,
)
from repro_torch.backends.softmax import SoftmaxBackend
from repro_torch.backends.softmax_window import SoftmaxWindowBackend
from repro_torch.backends.ssm import SSMBackend
from repro_torch.backends.state import KVCache, tree_slot_health
from repro_torch.backends.taylor import TaylorBackend

register_backend(TaylorBackend())
register_backend(SoftmaxBackend())
register_backend(LinearEluBackend())
register_backend(SoftmaxWindowBackend())
register_backend(SSMBackend())

__all__ = [
    "AttentionBackend",
    "KVCache",
    "LinearEluBackend",
    "SoftmaxBackend",
    "SoftmaxWindowBackend",
    "SSMBackend",
    "TaylorBackend",
    "available_backends",
    "get_backend",
    "register_backend",
    "resolve_backend",
    "state_backend",
    "tree_slot_health",
]
