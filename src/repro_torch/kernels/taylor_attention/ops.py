"""Wrapper around the Taylor-attention forward kernel.

Handles everything the raw kernel (``kernel.taylor_fwd``) does not:

  * LayerNorm (no affine) of q/k — the paper's prescription;
  * GQA reshaping ([b, h, n, d] + [b, hk, n, d] -> grouped kernel layout);
  * zero-padding to what the CUDA kernel's tiles need (``kernel.TILES``):
    the head dim up to 16/32/64/128, d_v to a multiple of the value tile,
    the sequence to a multiple of the chunk.  Zero features and zero
    key/value rows are exact no-ops; the logit scale keeps the TRUE head
    dim (``_effective_alpha``).

Training needs the backward kernels, which are not yet ported: a call on
tensors that require grad raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.feature_map import layernorm_no_affine
from repro_torch.kernels.taylor_attention.kernel import TILES, taylor_fwd


class KernelDims(NamedTuple):
    """True and padded dimensions of one kernel launch."""

    b: int
    h: int
    hk: int
    g: int
    n: int
    d: int
    dv: int
    n_pad: int
    d_pad: int
    dv_pad: int


def _round_up(size: int, mult: int) -> int:
    return ((size + mult - 1) // mult) * mult


def _layout_dims(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> KernelDims:
    """KernelDims from shapes alone."""
    b, h, n, d = q.shape
    hk = k.shape[1]
    if h % hk:
        raise ValueError(f"q heads {h} not divisible by kv heads {hk}")
    fits = [t for t in sorted(TILES) if t >= d]
    if not fits:
        raise ValueError(
            f"head dim {d} exceeds the kernel's maximum {max(TILES)}"
        )
    d_pad = fits[0]
    dvt, chunk = TILES[d_pad]
    return KernelDims(
        b=b, h=h, hk=hk, g=h // hk, n=n, d=d, dv=v.shape[-1],
        n_pad=_round_up(n, chunk), d_pad=d_pad,
        dv_pad=_round_up(v.shape[-1], dvt),
    )


def _pad(x: torch.Tensor, axis: int, target: int) -> torch.Tensor:
    extra = target - x.shape[axis]
    if extra == 0:
        return x
    pad = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, extra]
    return F.pad(x, pad)


def _kernel_layout(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """[b,h,n,d] q + [b,hk,n,·] k/v  ->  padded [b·hk, ...] kernel layout."""
    dims = _layout_dims(q, k, v)
    qg = q.reshape(dims.b, dims.hk, dims.g, dims.n, dims.d)
    qg = _pad(_pad(qg, 4, dims.d_pad), 3, dims.n_pad)
    kp = _pad(_pad(k, 3, dims.d_pad), 2, dims.n_pad)
    vp = _pad(_pad(v, 3, dims.dv_pad), 2, dims.n_pad)
    bk = dims.b * dims.hk
    return (
        qg.reshape(bk, dims.g, dims.n_pad, dims.d_pad),
        kp.reshape(bk, dims.n_pad, dims.d_pad),
        vp.reshape(bk, dims.n_pad, dims.dv_pad),
        dims,
    )


def _effective_alpha(alpha: float, dims: KernelDims) -> float:
    """The kernel derives its scale from the PADDED head dim; compensate so
    the logits use the TRUE head dim d."""
    if dims.d == dims.d_pad:
        return alpha
    return alpha * (dims.d**0.5) / (dims.d_pad**0.5)


def taylor_attention_kernel(
    q: torch.Tensor,  # [b, h, n, d]
    k: torch.Tensor,  # [b, hk, n, d]
    v: torch.Tensor,  # [b, hk, n, dv]
    alpha: float = 3.0,
    order: int = 2,
    normalize_qk: bool = True,
) -> torch.Tensor:
    """Causal Taylor linear attention through the forward kernel.

    Args:
      q: queries ``[b, h, n, d]``.
      k: keys ``[b, hk, n, d]`` with ``h % hk == 0`` (GQA/MQA).
      v: values ``[b, hk, n, dv]``.
      alpha: the paper's logit scale — scores are ``q·k / (alpha·√d)``
        with the TRUE head dim d.
      order: Taylor expansion order of exp, 1 or 2.
      normalize_qk: apply the affine-free LayerNorm to q and k first.

    Returns:
      Attention output ``[b, h, n, dv]`` in v's dtype.  CUDA tensors run
      the CUDA kernel, CPU tensors its plain PyTorch version.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "taylor_attention_kernel is forward-only until the backward "
            "kernels are ported; call it under torch.no_grad()"
        )
    if normalize_qk:
        q = layernorm_no_affine(q).to(q.dtype)
        k = layernorm_no_affine(k).to(k.dtype)
    qp, kp, vp, dims = _kernel_layout(q, k, v)
    out = taylor_fwd(qp, kp, vp, alpha=_effective_alpha(alpha, dims), order=order)
    out = out.reshape(dims.b, dims.hk, dims.g, dims.n_pad, dims.dv_pad)
    out = out[:, :, :, : dims.n, : dims.dv]
    return out.reshape(dims.b, dims.h, dims.n, dims.dv)
