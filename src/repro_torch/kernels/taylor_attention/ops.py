"""Wrappers around the Taylor-attention kernels.

Handles everything the raw kernels (``kernel.taylor_fwd``,
``kernel.taylor_bwd``) do not:

  * LayerNorm (no affine) of q/k — the paper's prescription;
  * GQA reshaping ([b, h, n, d] + [b, hk, n, d] -> grouped kernel layout);
  * zero-padding to what the CUDA kernels' tiles need (``kernel.TILES``):
    the head dim up to 16/32/64/128, d_v to a multiple of the value tile,
    the sequence to a multiple of the chunk.  Zero features and zero
    key/value rows are exact no-ops; the logit scale keeps the TRUE head
    dim (``_effective_alpha``).

``taylor_attention_kernel`` is the forward alone and refuses tensors that
require grad; ``taylor_attention_kernel_trainable`` is the training entry
point, whose backward is the CUDA kernel pair inside its envelope and the
torch recompute (``core/taylor_vjp.py``) outside it.

The glue on each side of the kernels' ops is the spans ``attention.prep``
(q/k LayerNorm, layouts, padding, casts) and ``attention.post`` (slicing
and casts back) of ``repro_torch.spans``; neither encloses an op.  The
LayerNorm's backward, which autograd runs, falls outside them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.core.feature_map import TaylorConfig, layernorm_no_affine
from repro_torch.kernels.taylor_attention.kernel import TILES, taylor_bwd, taylor_fwd


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


def _grouped_value_layout(x: torch.Tensor, dims: KernelDims) -> torch.Tensor:
    """[b,h,n,dv]-shaped tensors (out, dout) -> the padded grouped layout,
    under the SAME contract as ``_kernel_layout`` pads v."""
    x = x.reshape(dims.b, dims.hk, dims.g, dims.n, dims.dv)
    x = _pad(_pad(x, 4, dims.dv_pad), 3, dims.n_pad)
    return x.reshape(dims.b * dims.hk, dims.g, dims.n_pad, dims.dv_pad)


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
            "taylor_attention_kernel is forward-only; train through "
            "taylor_attention_kernel_trainable"
        )
    if normalize_qk:
        q = layernorm_no_affine(q).to(q.dtype)
        k = layernorm_no_affine(k).to(k.dtype)
    return _forward_kernel(q, k, v, alpha, order)


def _forward_kernel(q, k, v, alpha: float, order: int) -> torch.Tensor:
    """The forward kernel on pre-normalised q/k, in and out of its layout."""
    with spans.span("attention.prep"):
        qp, kp, vp, dims = _kernel_layout(q, k, v)
    out = taylor_fwd(qp, kp, vp, alpha=_effective_alpha(alpha, dims), order=order)
    with spans.span("attention.post"):
        out = out.reshape(dims.b, dims.hk, dims.g, dims.n_pad, dims.dv_pad)
        out = out[:, :, :, : dims.n, : dims.dv]
        return out.reshape(dims.b, dims.h, dims.n, dims.dv)


def _kernel_bwd_ok(cfg: TaylorConfig, dims: KernelDims) -> bool:
    """The CUDA backward's envelope, the reference's (``_pallas_bwd_ok``):
    d ≤ 128 and d_v ≤ 128 after padding, full (non-symmetric) second
    moment."""
    return dims.d_pad <= 128 and dims.dv_pad <= 128 and not cfg.sym_state


def _bwd_torch(q, k, v, dout, cfg: TaylorConfig, chunk: int):
    """The torch recompute backward (``core/taylor_vjp.py``) on pre-normalised
    q/k.  The sequence is padded at its end to a multiple of ``chunk`` (zero
    k/v/dout rows change no real row's gradient)."""
    from repro_torch.core.taylor_vjp import _bwd_rule  # noqa: PLC0415 (cycle)

    b, h, n, d = q.shape
    hk = k.shape[1]
    n_pad = _round_up(n, chunk)
    qg = _pad(q.reshape(b, hk, h // hk, n, d), 3, n_pad)
    dog = _pad(dout.reshape(b, hk, h // hk, n, v.shape[-1]), 3, n_pad)
    # the recompute is written for the FULL second moment; sym_state is an
    # exact compression, so dropping it changes nothing.
    bcfg = dataclasses.replace(cfg, sym_state=False)
    dq, dk, dv = _bwd_rule(bcfg, chunk, qg, _pad(k, 2, n_pad), _pad(v, 2, n_pad), dog)
    return (dq[:, :, :, :n].reshape(q.shape), dk[:, :, :n], dv[:, :, :n])


class _TrainableKernel(torch.autograd.Function):
    """Forward: the CUDA kernel; backward: the CUDA pair or the torch
    recompute.  Takes pre-normalised q/k; saves (q, k, v, out)."""

    @staticmethod
    def forward(ctx, q, k, v, cfg: TaylorConfig, chunk: int, backward: str):
        out = _forward_kernel(q, k, v, cfg.alpha, cfg.order)
        ctx.cfg, ctx.chunk, ctx.backward = cfg, chunk, backward
        # out is a residual: pass 1 derives the denominator cotangent from it
        # instead of recomputing the numerator.
        ctx.save_for_backward(q, k, v, out)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        cfg = ctx.cfg
        dims = _layout_dims(q, k, v)
        if ctx.backward == "cuda":
            if not _kernel_bwd_ok(cfg, dims):  # not assert: survives -O
                raise ValueError(f"CUDA backward envelope exceeded: {dims} / {cfg}")
        elif ctx.backward == "torch" or not _kernel_bwd_ok(cfg, dims):
            return (*_bwd_torch(q, k, v, dout, cfg, ctx.chunk), None, None, None)

        with spans.span("attention.prep"):
            qp, kp, vp, _ = _kernel_layout(q, k, v)
            # dout/out padded under the SAME contract as v: padded dout rows
            # and columns are zero, so every gradient of a padded row vanishes.
            doutp = _grouped_value_layout(dout.to(v.dtype), dims)
            outp = _grouped_value_layout(out, dims)
        dq, dk, dv = taylor_bwd(qp, kp, vp, doutp, outp,
                                alpha=_effective_alpha(cfg.alpha, dims), order=cfg.order)
        with spans.span("attention.post"):
            dq = dq.reshape(dims.b, dims.hk, dims.g, dims.n_pad, dims.d_pad)
            dq = dq[:, :, :, : dims.n, : dims.d].reshape(q.shape).to(q.dtype)
            dk = dk.reshape(dims.b, dims.hk, dims.n_pad, dims.d_pad)
            dk = dk[:, :, : dims.n, : dims.d].to(k.dtype)
            dv = dv.reshape(dims.b, dims.hk, dims.n_pad, dims.dv_pad)
            dv = dv[:, :, : dims.n, : dims.dv].to(v.dtype)
        return dq, dk, dv, None, None, None


def taylor_attention_kernel_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    cfg: Optional[TaylorConfig] = None,
    chunk: int = 128,
    backward: str = "auto",
) -> torch.Tensor:
    """Differentiable Taylor attention: CUDA forward + two-pass backward.

    Training entry point.  Its gradient is the CUDA kernel pair
    (``csrc/taylor_bwd.cu``) whenever the config fits the pair's envelope
    (d ≤ 128 and d_v ≤ 128 after padding, full second moment), and the
    exact torch recompute (``core/taylor_vjp.py``) otherwise; the choice is
    made from the shapes and config, before any launch.  On CPU tensors
    both kernels run their plain versions (``ref.py``).

    Args:
      q: queries ``[b, h, n, d]``.
      k: keys ``[b, hk, n, d]`` with ``h % hk == 0`` (GQA/MQA).
      v: values ``[b, hk, n, dv]``.
      cfg: TaylorConfig (alpha/order/normalize_qk).  ``minus_one`` is
        rejected: the kernels hardcode the +1 expansion.
      chunk: chunk of the torch recompute backward.
      backward: "auto" (the CUDA pair inside its envelope, else torch),
        "cuda" (force; raises outside the envelope) or "torch" (force the
        recompute oracle).

    Returns:
      Attention output ``[b, h, n, dv]`` in v's dtype, differentiable
      w.r.t. q, k and v.  LayerNorm runs outside the autograd Function, so
      autograd differentiates it.
    """
    cfg = cfg or TaylorConfig()
    if backward not in ("auto", "cuda", "torch"):
        raise ValueError(f"backward must be auto|cuda|torch, got {backward!r}")
    if cfg.minus_one:
        raise NotImplementedError(
            "taylor_attention_kernel_trainable does not support minus_one; "
            "use taylor_attention_chunked"
        )
    if cfg.normalize_qk:
        with spans.span("attention.prep"):
            q = layernorm_no_affine(q).to(q.dtype)
            k = layernorm_no_affine(k).to(k.dtype)
    return _TrainableKernel.apply(q, k, v, cfg, chunk, backward)
