"""Attention-backend registry: the single resolution point for
``ModelConfig.attention``, for every name of
``ModelConfig.attention_schedule`` and for the block-level ``"ssm"``
backend of the mamba blocks.  An unregistered name raises "unknown
attention backend", as in the JAX package."""

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
            f"unknown attention backend {name!r}; registered: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[name]


def available_backends() -> Dict[str, AttentionBackend]:
    """Snapshot of the registry: ``{name: backend}`` (insertion order)."""
    return dict(_REGISTRY)


def resolve_backend(cfg) -> AttentionBackend:
    """Resolve ``cfg.attention`` to a backend validated against ``cfg``;
    a block-level backend cannot be one."""
    backend = get_backend(cfg.attention)
    if backend.level != "qkv":
        raise ValueError(
            f"backend {backend.name!r} is {backend.level}-level and cannot "
            "serve as ModelConfig.attention (use it as a block kind instead)"
        )
    backend.validate(cfg)
    return backend


def state_backend(kind: str, cfg) -> AttentionBackend:
    """The backend holding the decode state of a block of ``kind`` under the
    layer config ``cfg``: the block-level "ssm" one for a mamba block, else
    ``resolve_backend(cfg)``."""
    return get_backend("ssm") if kind == "mamba" else resolve_backend(cfg)
