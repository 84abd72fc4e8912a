"""Decomposable feature maps for linear-complexity attention (PyTorch).

The paper's order-2 Taylor feature map: with
``s = (q · k) / (alpha * sqrt(d))`` (q, k LayerNorm'd without affine),

    exp(s)  ≈  1 + s + s²/2  =  phi(q) · phi(k)

where ``phi(x) = [1, x * sqrt(a), symvec(x ⊗ x) * a / sqrt(2)]`` and
``a = 1 / (alpha * sqrt(d))``.  ``symvec`` is the weighted upper-triangular
vectorisation of the symmetric outer product (off-diagonal entries carry a
factor sqrt(2)), so ``symvec(q⊗q) · symvec(k⊗k) = (q·k)²`` with feature
dimension d(d+1)/2 instead of d².  The quadratic paths never materialise
phi: they evaluate the polynomial on the scaled logits (``poly_scores``) or
contract against running moments; ``sym_state`` keeps those moments packed
in the ``symvec`` basis.

All functions operate on the last axis and broadcast over leading axes.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class TaylorConfig:
    """Configuration of the paper's attention approximation.

    Attributes:
      order: Taylor order of the exp() expansion (1 or 2; the paper uses 2).
      alpha: extra logit down-scaling ``alpha > 1`` (the paper chooses 3).
      normalize_qk: LayerNorm (no affine) on q and k before the dot product.
      minus_one: drop the constant 1 from the expansion (the paper's §3
        variant); forfeits the positivity guarantee, so off by default.
      sym_state: store the second moments z2/s2 in the symmetric-compressed
        ``symvec`` basis (d(d+1)/2 rows instead of d², exact): half the
        decode state.  The training path keeps the full form (the custom
        backward and the CUDA kernels are written for it).
      decay: gated moment-state decay in (0, 1].  Token j's contribution to
        the state read at position i is weighted ``γ_h^(i-j)`` with
        per-kv-head rates ``γ_h = decay^((h+1)/h_kv)`` (``decay_gammas`` in
        ``core/taylor.py``).  ``1.0`` is bit-identical to the undecayed
        recurrence: every decay branch is guarded in Python.  Decayed
        configs are causal self-attention only, and run the torch paths
        (the CUDA kernels implement the undecayed recurrence).
    """

    order: int = 2
    alpha: float = 3.0
    normalize_qk: bool = True
    minus_one: bool = False
    sym_state: bool = False
    decay: float = 1.0

    def __post_init__(self):
        if self.order not in (1, 2):
            raise ValueError(f"Taylor order must be 1 or 2, got {self.order}")
        if self.alpha <= 0:
            raise ValueError(f"alpha must be positive, got {self.alpha}")
        if not 0.0 < self.decay <= 1.0:
            raise ValueError(f"decay must be in (0, 1], got {self.decay}")

    def scale(self, d: int) -> float:
        """The logit scale a = 1 / (alpha * sqrt(d))."""
        return 1.0 / (self.alpha * math.sqrt(d))

    def feature_dim(self, d: int) -> int:
        base = 0 if self.minus_one else 1
        if self.order == 1:
            return base + d
        return base + d + (d * (d + 1)) // 2


def layernorm_no_affine(x: Tensor, eps: float = 1e-6) -> Tensor:
    """LayerNorm without the element-wise affine rescaling, in float32."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps)


@functools.lru_cache(maxsize=None)
def _triu_indices(d: int) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """Row and column indices of the upper triangle (diagonal included) of a
    d×d matrix, row-major (numpy's ``triu_indices`` order)."""
    rows = tuple(i for i in range(d) for _ in range(i, d))
    cols = tuple(j for i in range(d) for j in range(i, d))
    return rows, cols


def symvec(x: Tensor) -> Tensor:
    """Weighted upper-triangular vectorisation of x ⊗ x.

    Returns features ``psi(x)`` of dim d(d+1)/2 with
    ``psi(q) · psi(k) = (q · k)²`` exactly: diagonal entries x_m²,
    off-diagonal entries sqrt(2)·x_m·x_l (m < l).
    """
    rows, cols, w = _symvec_index(x.shape[-1], x.device)
    feats = x[..., rows] * x[..., cols]
    return feats * w.to(feats.dtype)


@functools.lru_cache(maxsize=None)
def _symvec_index(d: int, device: torch.device):
    """``symvec``'s gather indices and weights on ``device``, made once (a
    decode step calls it in every layer)."""
    rows, cols = _triu_indices(d)
    rows = torch.tensor(rows, device=device)
    cols = torch.tensor(cols, device=device)
    return rows, cols, torch.where(rows == cols, 1.0, math.sqrt(2.0))


def taylor_features(x: Tensor, cfg: TaylorConfig, d: Optional[int] = None) -> Tensor:
    """The paper's feature map phi(x) with phi(q)·phi(k) = 1 + s + s²/2.

    Args:
      x: [..., d] (already LayerNorm'd where ``cfg.normalize_qk`` asks; the
        caller does that).
      cfg: TaylorConfig.
      d: dimension of the scale (default ``x.shape[-1]``; pass the true head
        dim when x was zero-padded).

    Returns:
      float32 features [..., ``cfg.feature_dim(d)``].
    """
    d = d if d is not None else x.shape[-1]
    a = cfg.scale(d)
    x = x.float()
    parts = []
    if not cfg.minus_one:
        parts.append(torch.ones(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device))
    parts.append(x * math.sqrt(a))
    if cfg.order >= 2:
        parts.append(symvec(x) * (a / math.sqrt(2.0)))
    return torch.cat(parts, dim=-1)


def elu_features(x: Tensor) -> Tensor:
    """Katharopoulos et al. (2020) baseline feature map: elu(x) + 1, in float32."""
    return torch.nn.functional.elu(x.float()) + 1.0


def poly_scores(s: Tensor, cfg: TaylorConfig) -> Tensor:
    """Taylor-expanded attention weights from raw scaled logits s."""
    out = s if cfg.minus_one else 1.0 + s
    if cfg.order >= 2:
        out = out + 0.5 * s.square()
    return out
