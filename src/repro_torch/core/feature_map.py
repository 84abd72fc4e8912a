"""Decomposable feature maps for linear-complexity attention (PyTorch).

The paper's order-2 Taylor feature map: with
``s = (q · k) / (alpha * sqrt(d))`` (q, k LayerNorm'd without affine),

    exp(s)  ≈  1 + s + s²/2  =  phi(q) · phi(k)

The quadratic paths never materialise phi: they evaluate the polynomial on
the scaled logits (``poly_scores``) or contract against running moments.

All functions operate on the last axis and broadcast over leading axes.
"""

from __future__ import annotations

import dataclasses
import math

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
      sym_state: symmetric-compressed second moments (not yet ported:
        the functions that would read it raise ``NotImplementedError``).
      decay: gated moment-state decay rate in (0, 1] (not yet ported:
        ``decay != 1`` raises ``NotImplementedError`` where it would apply).
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


def elu_features(x: Tensor) -> Tensor:
    """Katharopoulos et al. (2020) baseline feature map: elu(x) + 1, in float32."""
    return torch.nn.functional.elu(x.float()) + 1.0


def poly_scores(s: Tensor, cfg: TaylorConfig) -> Tensor:
    """Taylor-expanded attention weights from raw scaled logits s."""
    out = s if cfg.minus_one else 1.0 + s
    if cfg.order >= 2:
        out = out + 0.5 * s.square()
    return out
