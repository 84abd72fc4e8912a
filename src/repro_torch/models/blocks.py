"""Block-kind dispatcher: init / full-sequence apply / prefill / decode.

Only the ``"attn"`` kind (pre-norm self-attention + MLP) is ported.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import mlp_apply, mlp_init, norm_apply, norm_init

Tensor = torch.Tensor


def _check_kind(kind: str) -> None:
    if kind != "attn":
        raise NotImplementedError(f"block kind {kind!r} is not yet ported to torch")


def block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, dtype=torch.float32):
    _check_kind(kind)
    return {
        "norm1": norm_init(cfg.d_model, dtype, device=gen.device),
        "attn": attn.attention_init(gen, cfg, dtype),
        "norm2": norm_init(cfg.d_model, dtype, device=gen.device),
        "mlp": mlp_init(gen, cfg.d_model, cfg.d_ff, cfg.act, dtype),
    }


def block_apply(
    params, kind: str, x: Tensor, cfg: ModelConfig, positions: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor]:
    """Full-sequence forward.  Returns (x, aux_loss)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(params["norm1"], x, cfg.norm, eps)
    x = x + attn.attention_apply(params["attn"], h, cfg, positions)
    h = norm_apply(params["norm2"], x, cfg.norm, eps)
    x = x + mlp_apply(params["mlp"], h, cfg.act)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


def block_prefill(
    params, kind: str, x: Tensor, cfg: ModelConfig, n_max: int,
    positions: Optional[Tensor] = None,
):
    """Returns (x, cache)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(params["norm1"], x, cfg.norm, eps)
    y, cache = attn.attention_prefill(params["attn"], h, cfg, n_max, positions)
    x = x + y
    h2 = norm_apply(params["norm2"], x, cfg.norm, eps)
    return x + mlp_apply(params["mlp"], h2, cfg.act), cache


def block_decode(params, kind: str, x_t: Tensor, cache, cfg: ModelConfig, pos):
    """One-token step.  Returns (x_t, new_cache)."""
    _check_kind(kind)
    eps = cfg.norm_eps
    h = norm_apply(params["norm1"], x_t, cfg.norm, eps)
    y, cache = attn.attention_decode(params["attn"], h, cache, cfg, pos)
    x_t = x_t + y
    h2 = norm_apply(params["norm2"], x_t, cfg.norm, eps)
    return x_t + mlp_apply(params["mlp"], h2, cfg.act), cache
