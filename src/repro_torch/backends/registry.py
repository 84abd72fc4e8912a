"""Attention-backend registry: the single resolution point for
``ModelConfig.attention`` and for every name of
``ModelConfig.attention_schedule``.  A backend of the JAX package that is
not yet ported raises "not yet ported"; any other unregistered name raises
"unknown attention backend", as in the JAX package."""

from __future__ import annotations

from typing import Dict

from repro_torch.backends.base import AttentionBackend

_REGISTRY: Dict[str, AttentionBackend] = {}
# Backends of the JAX package that the port does not have yet.
_NOT_YET_PORTED = ("ssm",)


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
    if name in _NOT_YET_PORTED:
        raise ValueError(
            f"attention backend {name!r} is not yet ported to torch "
            f"(registered: {sorted(_REGISTRY)})"
        )
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown attention backend {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def available_backends() -> Dict[str, AttentionBackend]:
    """Snapshot of the registry: ``{name: backend}`` (insertion order)."""
    return dict(_REGISTRY)


def resolve_backend(cfg) -> AttentionBackend:
    """Resolve ``cfg.attention`` to a backend validated against ``cfg``."""
    backend = get_backend(cfg.attention)
    backend.validate(cfg)
    return backend
