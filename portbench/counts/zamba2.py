"""Frozen model work of a Zamba2 training step: 6 × the matmul parameters a
token passes through, the Taylor attention of every site (``counts/taylor.py``
at the sites' launch) and the SSD of every mamba layer, forward and
backward.  Recomputation (remat) is not work and is not counted; neither
are the causal conv, the norms or the elementwise work.

The matmul parameters are every projection a token's forward passes
through, per occurrence: each mamba layer's in_proj and out_proj, at each
site the shared block it runs (q, k, v, o, gate_up, down) with the site's
adapter and linear, and the tied head; not the embedding lookup.

The SSD's work is counted in its chunked form at the configuration's
``chunk_size`` Q, causal pairs only, per layer and sequence of n:
the scores C·B of each chunk per B/C group, ``G · n · (Q + 1) · N``; the
weighted sums of x within the chunk per head, ``H · n · (Q + 1) · P``; each
chunk's state and its read per head, ``2 · H · n · 2 · P · N``.  The
backward is twice the forward.
"""

from __future__ import annotations

from portbench.counts import taylor
from portbench.weights_zamba2 import sizes


def matmul_params(cfg: dict) -> int:
    """Matmul parameters per token, per occurrence, head included."""
    s = sizes(cfg)
    d, di, G, N, H = s["d"], s["di"], s["G"], s["N"], s["H"]
    w, h, hk, hd, f, r = s["w"], s["h"], s["hk"], s["hd"], s["f"], s["r"]
    mamba = d * (2 * di + 2 * G * N + H) + di * d
    site = w * h * hd + 2 * w * hk * hd + h * hd * d + 3 * d * f + d * r + r * 2 * f + d * d
    return (cfg["num_hidden_layers"] * mamba + len(cfg["hybrid_layer_ids"]) * site
            + d * s["V"])


def ssd_flops(cfg: dict, batch: int, seq: int) -> float:
    """The SSD's forward operations in one layer over ``batch`` × ``seq``."""
    s = sizes(cfg)
    q, G, N, H, P = cfg["chunk_size"], s["G"], s["N"], s["H"], s["P"]
    tokens = batch * seq
    return tokens * (G * (q + 1) * N + H * (q + 1) * P + 4 * H * P * N)


def train_step_flops(cfg: dict, batch: int, seq: int, itemsize: int = 2) -> float:
    """Model FLOPs of one optimizer step over ``batch`` × ``seq`` tokens."""
    hk, hd = cfg["num_key_value_heads"], cfg["attention_head_dim"]
    g = cfg["num_attention_heads"] // hk
    fwd_ops, _ = taylor.fwd(batch * hk, g, seq, hd, hd, itemsize)
    bwd_ops, _ = taylor.bwd(batch * hk, g, seq, hd, hd, itemsize)["pair"]
    return (6 * matmul_params(cfg) * batch * seq
            + len(cfg["hybrid_layer_ids"]) * (fwd_ops + bwd_ops)
            + 3 * cfg["num_hidden_layers"] * ssd_flops(cfg, batch, seq))
