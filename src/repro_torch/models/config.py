"""Model configuration of the port (the uniform fields of the JAX package's
``repro.models.config.ModelConfig``).

A model is a repeating ``pattern`` of blocks applied ``n_groups`` times plus
an optional ``tail``.  This slice runs decoder-only models of ``"attn"``
blocks on the ``taylor`` backend; per-layer schedules, MoE, SSM,
encoder-decoder and VLM fields are not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.feature_map import TaylorConfig

BLOCK_KINDS = ("attn",)
ATTN_IMPLS = ("auto", "torch", "cuda")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # "lm" (the only family ported)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    # depth = n_groups * len(pattern) + len(tail)
    pattern: Tuple[str, ...]
    n_groups: int
    tail: Tuple[str, ...] = ()

    head_dim: int = 0              # 0 → d_model // n_heads
    act: str = "silu"              # "silu"
    norm: str = "rmsnorm"          # "rmsnorm"
    norm_eps: float = 1e-6
    qkv_bias: bool = False
    tie_embeddings: bool = False
    pos: str = "rope"              # "rope" | "none"
    rope_theta: float = 10000.0
    embed_scale: bool = False      # gemma-style sqrt(d_model) embedding scale
    logit_softcap: float = 0.0

    # --- attention backend ---
    attention: str = "softmax"     # resolved through repro_torch.backends
    taylor: TaylorConfig = TaylorConfig()
    attn_chunk: int = 128          # chunk of the taylor chunked scan
    # Execution engine within the backend (mirrors the JAX package's
    # "auto" | "xla" | "pallas"):
    #   "auto"  — the CUDA kernel on a CUDA device inside its envelope,
    #             else the plain PyTorch paths
    #   "torch" — force the plain PyTorch paths (the reference)
    #   "cuda"  — force the CUDA kernel; configs outside its envelope raise
    attn_impl: str = "auto"

    # --- numerics ---
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    max_seq: int = 131072

    def __post_init__(self):
        for kind in self.pattern + self.tail:
            if kind not in BLOCK_KINDS:
                raise ValueError(
                    f"block kind {kind!r} is not yet ported (have {BLOCK_KINDS})"
                )
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(
                f"attn_impl must be auto|torch|cuda, got {self.attn_impl!r}"
            )

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def n_layers(self) -> int:
        return self.n_groups * len(self.pattern) + len(self.tail)

    def layer_cfg(self, backend: str) -> "ModelConfig":
        """Config view for one layer run with ``attention`` set to ``backend``
        (``self`` when already uniform on it)."""
        if backend == self.attention:
            return self
        return dataclasses.replace(self, attention=backend)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)
