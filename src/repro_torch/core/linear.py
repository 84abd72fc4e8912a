"""Feature-map linear attention (the Katharopoulos et al. 2020 baseline).

``linear_attention(q, k, v, phi)`` computes

    out_i = phi(q_i) · S_i / (phi(q_i) · z_i),   S_i = Σ_{j≤i} phi(k_j) ⊗ v_j

over explicit features: the elu+1 baseline with ``phi = elu_features``.
The production Taylor path lives in ``core/taylor.py`` and the kernels.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.feature_map import elu_features, layernorm_no_affine

Tensor = torch.Tensor
FeatureFn = Callable[[Tensor], Tensor]


def _group(q: Tensor, h_kv: int) -> Tensor:
    b, h, n, d = q.shape
    return q.reshape(b, h_kv, h // h_kv, n, d)


def linear_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    phi: FeatureFn = elu_features,
    causal: bool = True,
    normalize_qk: bool = False,
    eps: float = 1e-6,
) -> Tensor:
    """Linear attention with an arbitrary feature map.

    The causal path takes cumulative sums over explicit features: O(n·D·d_v)
    memory, as in the JAX package.  Denominators below ``eps`` in magnitude
    are replaced by ``eps``.
    """
    b, h, n, d = q.shape
    h_kv = k.shape[1]
    if normalize_qk:
        q = layernorm_no_affine(q).to(q.dtype)
        k = layernorm_no_affine(k).to(k.dtype)
    fq = phi(_group(q, h_kv))  # [b, hk, g, n, D]
    fk = phi(k)  # [b, hk, n, D]
    v32 = v.float()
    if causal:
        kv = torch.einsum("bkjf,bkjv->bkjfv", fk, v32)
        S = torch.cumsum(kv, dim=2)  # [b, hk, n, D, v]
        z = torch.cumsum(fk, dim=2)  # [b, hk, n, D]
        num = torch.einsum("bkgnf,bknfv->bkgnv", fq, S)
        den = torch.einsum("bkgnf,bknf->bkgn", fq, z)
    else:
        S = torch.einsum("bkjf,bkjv->bkfv", fk, v32)
        z = fk.sum(dim=2)
        num = torch.einsum("bkgnf,bkfv->bkgnv", fq, S)
        den = torch.einsum("bkgnf,bkf->bkgn", fq, z)
    den = torch.where(den.abs() < eps, eps, den)
    out = num / den[..., None]
    return out.reshape(b, h, n, v.shape[-1]).to(v.dtype)
