"""Model configuration of the port (the uniform fields of the JAX package's
``repro.models.config.ModelConfig``).

A model is a repeating ``pattern`` of blocks applied ``n_groups`` times plus
an optional ``tail``.  The port runs decoder-only models of ``"attn"``
blocks on the ``taylor``, ``softmax``, ``softmax_window`` and ``linear_elu``
backends; per-layer schedules, MoE, SSM, encoder-decoder and VLM fields
are not yet ported.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core.feature_map import TaylorConfig

BLOCK_KINDS = ("attn",)
ATTN_IMPLS = ("auto", "torch", "cuda")
REMATS = ("none", "full", "dots_saveable")


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
    # Sliding-window size (tokens) of the ``softmax_window`` backend's
    # O(window) ring-buffer KV cache.
    attn_window: int = 128

    # --- numerics / training ---
    dtype: str = "bfloat16"        # activation dtype
    param_dtype: str = "float32"
    # "full": each block's activations are recomputed in the backward
    # (torch.utils.checkpoint per block); "none": all are kept;
    # "dots_saveable" is not yet ported (lm_apply raises)
    remat: str = "full"
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
        if self.attn_window < 1:
            raise ValueError(f"attn_window must be >= 1, got {self.attn_window}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got {self.remat!r}")

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


def count_params(cfg: ModelConfig) -> int:
    """Exact parameter count of ``lm_init(cfg)``, from the shapes alone."""
    d, h, hk, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    block = (
        2 * d                              # norm1, norm2
        + d * h * hd + 2 * d * hk * hd     # wq, wk, wv
        + h * hd * d                       # wo
        + 3 * d * cfg.d_ff                 # SiLU-gated MLP
    )
    embed = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return embed + d + cfg.n_layers * block
