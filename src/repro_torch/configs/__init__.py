"""Architecture registry of the port.

Each ``configs/<arch>.py`` exports ``CONFIG`` (the published config) and
``reduced()`` (a tiny same-family config for CPU tests), with the JAX
package's values.  ``ARCHS`` lists all ten architectures of the JAX
package's registry, in its order: the dense, MoE and Mamba2 decoders, the
encoder-decoder whisper-medium and the VLM llama-3.2-vision-11b.
"""

from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.models.config import ModelConfig

ARCHS = (
    "zamba2-7b",
    "granite-20b",
    "qwen2-1.5b",
    "gemma-7b",
    "smollm-135m",
    "kimi-k2-1t-a32b",
    "qwen2-moe-a2.7b",
    "whisper-medium",
    "mamba2-780m",
    "llama-3.2-vision-11b",
)


def _module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown architecture {arch!r} (have {ARCHS})")
    return importlib.import_module(
        f"repro_torch.configs.{arch.replace('-', '_').replace('.', '_')}"
    )


def get_config(arch: str, backend: Optional[str] = None, **overrides) -> ModelConfig:
    """Full published config, with ``overrides`` replaced.  ``backend``
    overrides the attention backend ("softmax" = the architecture's own
    baseline, "taylor" = the paper's technique applied to it)."""
    cfg = _module(arch).CONFIG
    if backend is not None:
        cfg = cfg.replace(attention=backend)
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg


def get_reduced(arch: str, **overrides) -> ModelConfig:
    cfg = _module(arch).reduced()
    if overrides:
        cfg = cfg.replace(**overrides)
    return cfg
