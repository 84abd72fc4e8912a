"""Plain PyTorch version of the Taylor-attention forward kernel.

Semantics: causal order-``order`` Taylor linear attention over
PRE-NORMALISED q/k (LayerNorm is the caller's job, as for the kernel),
with GQA grouping and the kernel's denominator clamp
``where(|den| < 1e-6, 1e-6, den)`` (not ``core.taylor._safe_div``'s
sign-keeping one).  O(n²) in memory: a reference, not an execution path.

  q: [B, HK, G, N, D]   k: [B, HK, N, D]   v: [B, HK, N, DV]
  out: [B, HK, G, N, DV] in v's dtype
"""

from __future__ import annotations

import torch


def taylor_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    alpha: float = 3.0,
    order: int = 2,
) -> torch.Tensor:
    """O(n²) reference for the kernel (grouped layout, no LayerNorm).

    Args:
      q: queries ``[B, HK, G, N, D]`` (pre-normalised, grouped).
      k: keys ``[B, HK, N, D]``.
      v: values ``[B, HK, N, DV]``.
      alpha: logit down-scale (scores are ``q·k / (alpha·√D)``).
      order: Taylor order of the exp expansion (1 or 2).

    Returns:
      Causally-masked normalised attention output ``[B, HK, G, N, DV]``.
    """
    n, d = q.shape[-2], q.shape[-1]
    a = 1.0 / (alpha * d**0.5)
    s = torch.einsum("bkgid,bkjd->bkgij", q.float(), k.float()) * a
    p = 1.0 + s
    if order >= 2:
        p = p + 0.5 * s.square()
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    p = torch.where(mask, p, 0.0)
    num = torch.einsum("bkgij,bkjv->bkgiv", p, v.float())
    den = p.sum(dim=-1)
    den = torch.where(den.abs() < 1e-6, 1e-6, den)
    return (num / den[..., None]).to(v.dtype)
