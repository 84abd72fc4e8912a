"""Attention-backend registry: the single resolution point for
``ModelConfig.attention``.  A name that is not registered (a backend of the
JAX package not yet ported) raises "not yet ported"."""

from __future__ import annotations

from typing import Dict

from repro_torch.backends.base import AttentionBackend

_REGISTRY: Dict[str, AttentionBackend] = {}


def register_backend(backend: AttentionBackend) -> AttentionBackend:
    """Register a backend under ``backend.name`` (names are unique)."""
    if not backend.name:
        raise ValueError("backend must set a non-empty .name")
    if backend.name in _REGISTRY:
        raise ValueError(f"attention backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> AttentionBackend:
    """Look up a registered backend by name."""
    if name not in _REGISTRY:
        raise ValueError(
            f"attention backend {name!r} is not yet ported to torch "
            f"(registered: {sorted(_REGISTRY)})"
        )
    return _REGISTRY[name]


def resolve_backend(cfg) -> AttentionBackend:
    """Resolve ``cfg.attention`` to a backend validated against ``cfg``."""
    backend = get_backend(cfg.attention)
    backend.validate(cfg)
    return backend
