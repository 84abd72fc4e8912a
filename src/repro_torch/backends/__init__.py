"""Attention backends of the port (registry + the Taylor backend)."""

from repro_torch.backends.base import AttentionBackend
from repro_torch.backends.registry import get_backend, register_backend, resolve_backend
from repro_torch.backends.taylor import TaylorBackend

register_backend(TaylorBackend())

__all__ = [
    "AttentionBackend",
    "TaylorBackend",
    "get_backend",
    "register_backend",
    "resolve_backend",
]
