"""Frozen model work of a training step: the matmul parameters a token
passes through, and the step's model FLOPs.

Model FLOPs = 6 × (matmul parameters per token) × tokens, plus the frozen
counts of the Taylor forward and backward pair (``counts/taylor.py``) once
per attention layer.  The matmul parameters are every projection a token's
forward passes through, per occurrence (a shared block counts at each
place it runs), with the head and without the embedding lookup.
Recomputation (remat) is not work and is not counted; neither are the
SSD scan's own operations, the causal conv, the norms or the elementwise
work, so ``mfu`` undercounts a mamba model's work.
"""

from __future__ import annotations

from portbench.counts import taylor
from portbench.weights import layer_kinds, n_params, ssm_sizes


def _attn_matmul(cfg: dict) -> int:
    d, h, hk, hd, f = (cfg[k] for k in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff"))
    mlp = (2 if cfg["act"] == "gelu" else 3) * d * f
    return d * h * hd + 2 * d * hk * hd + h * hd * d + mlp


def _mamba_matmul(cfg: dict) -> int:
    d = cfg["d_model"]
    di, nh, _, g, ns = ssm_sizes(cfg)
    return d * (2 * di + 2 * g * ns + nh) + di * d


def matmul_params(cfg: dict) -> int:
    """Matmul parameters per token, per occurrence, head included."""
    blocks = sum(_mamba_matmul(cfg) if k == "mamba" else _attn_matmul(cfg)
                 for k in layer_kinds(cfg))
    return blocks + cfg["d_model"] * cfg["vocab"]


def attention_layers(cfg: dict) -> int:
    return sum(k != "mamba" for k in layer_kinds(cfg))


def param_count(cfg: dict) -> int:
    """Every parameter once (a shared block once)."""
    return n_params(cfg)


def train_step_flops(cfg: dict, batch: int, seq: int, itemsize: int = 2) -> float:
    """Model FLOPs of one optimizer step over ``batch`` × ``seq`` tokens."""
    hk, g, hd = cfg["n_kv_heads"], cfg["n_heads"] // cfg["n_kv_heads"], cfg["head_dim"]
    fwd_ops, _ = taylor.fwd(batch * hk, g, seq, hd, hd, itemsize)
    bwd_ops, _ = taylor.bwd(batch * hk, g, seq, hd, hd, itemsize)["pair"]
    return (6 * matmul_params(cfg) * batch * seq
            + attention_layers(cfg) * (fwd_ops + bwd_ops))
