"""Plain PyTorch versions of the Taylor-attention kernels (forward and backward).

Semantics: causal order-``order`` Taylor linear attention over
PRE-NORMALISED q/k (LayerNorm is the caller's job, as for the kernels),
with GQA grouping and the kernels' denominator clamp
``where(|den| < 1e-6, 1e-6, den)`` (not ``core.taylor._safe_div``'s
sign-keeping one, which the torch gradient oracle ``core.taylor_vjp``
keeps: the two differ only where |den| < 1e-6).  O(n²) in memory:
references, not execution paths.

  q: [B, HK, G, N, D]   k: [B, HK, N, D]   v: [B, HK, N, DV]
  out, dout: [B, HK, G, N, DV]
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
DEN_EPS = 1e-6


def _up(x: Tensor) -> Tensor:
    """x in float32, or float64 if it is float64 (a float64 oracle run)."""
    return x if x.dtype == torch.float64 else x.float()


def _scores(q: Tensor, k: Tensor, alpha: float, order: int):
    """(s, p, causal mask): scaled logits, masked Taylor weights."""
    n, d = q.shape[-2], q.shape[-1]
    a = 1.0 / (alpha * d**0.5)
    s = torch.einsum("bkgid,bkjd->bkgij", _up(q), _up(k)) * a
    p = 1.0 + s
    if order >= 2:
        p = p + 0.5 * s.square()
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    return s, torch.where(mask, p, 0.0), mask


def _clamp(den: Tensor) -> Tensor:
    return torch.where(den.abs() < DEN_EPS, DEN_EPS, den)


def taylor_attention_ref(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    alpha: float = 3.0,
    order: int = 2,
) -> Tensor:
    """O(n²) reference for the forward kernel (grouped layout, no LayerNorm).

    Args:
      q: queries ``[B, HK, G, N, D]`` (pre-normalised, grouped).
      k: keys ``[B, HK, N, D]``.
      v: values ``[B, HK, N, DV]``.
      alpha: logit down-scale (scores are ``q·k / (alpha·√D)``).
      order: Taylor order of the exp expansion (1 or 2).

    Returns:
      Causally-masked normalised attention output ``[B, HK, G, N, DV]``.
    """
    _, p, _ = _scores(q, k, alpha, order)
    num = torch.einsum("bkgij,bkjv->bkgiv", p, _up(v))
    den = _clamp(p.sum(dim=-1))
    return (num / den[..., None]).to(v.dtype)


def taylor_bwd_dq_ref(
    q: Tensor, k: Tensor, v: Tensor, dout: Tensor, out: Tensor,
    alpha: float = 3.0, order: int = 2,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Plain version of backward pass 1: ``(dq, den, dden)``, all float32.

    den is recomputed with the kernels' clamp; the numerator is not: the
    denominator cotangent ``dden = -Σ_v dout·out / den`` comes from the
    SAVED forward output, as in the kernels.
    """
    d = q.shape[-1]
    a = 1.0 / (alpha * d**0.5)
    s, p, mask = _scores(q, k, alpha, order)
    den = _clamp(p.sum(dim=-1))
    do = _up(dout)
    dnum = do / den[..., None]
    dden = -(do * _up(out)).sum(dim=-1) / den
    ds = _dscores(dnum, dden, v, s, mask, a, order)
    dq = torch.einsum("bkgij,bkjd->bkgid", ds, _up(k))
    return dq, den, dden


def _dscores(dnum, dden, v, s, mask, a, order):
    """ds = causal(dp · d/ds[1 + s + s²/2]) · a with dp = dnum·Vᵀ + dden."""
    dp = torch.einsum("bkgiv,bkjv->bkgij", dnum, _up(v)) + dden[..., None]
    if order >= 2:
        dp = dp * (1.0 + s)
    return torch.where(mask, dp, 0.0) * a


def taylor_bwd_dkv_ref(
    q: Tensor, k: Tensor, v: Tensor, dout: Tensor, den: Tensor, dden: Tensor,
    alpha: float = 3.0, order: int = 2,
) -> Tuple[Tensor, Tensor]:
    """Plain version of backward pass 2: ``(dk, dv)`` float32, from pass 1's
    (den, dden) rows."""
    d = q.shape[-1]
    a = 1.0 / (alpha * d**0.5)
    s, p, mask = _scores(q, k, alpha, order)
    dnum = _up(dout) / den[..., None]
    ds = _dscores(dnum, dden, v, s, mask, a, order)
    dk = torch.einsum("bkgij,bkgid->bkjd", ds, _up(q))
    dv = torch.einsum("bkgij,bkgiv->bkjv", p, dnum)
    return dk, dv


def taylor_attention_bwd_ref(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    dout: Tensor,
    out: Tensor,
    alpha: float = 3.0,
    order: int = 2,
) -> Tuple[Tensor, Tensor, Tensor]:
    """O(n²) reference for the backward kernel pair (grouped layout).

    Args:
      q: queries ``[B, HK, G, N, D]`` (pre-normalised, grouped).
      k: keys ``[B, HK, N, D]``.
      v: values ``[B, HK, N, DV]``.
      dout: output cotangent ``[B, HK, G, N, DV]``.
      out: the saved forward output ``[B, HK, G, N, DV]``.
      alpha: logit down-scale of the forward.
      order: Taylor order (1 or 2).

    Returns:
      ``(dq [B, HK, G, N, D], dk [B, HK, N, D], dv [B, HK, N, DV])`` float32.
    """
    dq, den, dden = taylor_bwd_dq_ref(q, k, v, dout, out, alpha, order)
    dk, dv = taylor_bwd_dkv_ref(q, k, v, dout, den, dden, alpha, order)
    return dq, dk, dv
