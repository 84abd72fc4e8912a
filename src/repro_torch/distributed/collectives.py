"""Differentiable collectives over one axis of a mesh.

On a mesh every rank holds its local block of each parameter and
activation, and the layout changes that GSPMD inserts in the JAX package
are the explicit calls below (made by the layout hooks of
``distributed/spmd.py``).  Each one
is an autograd function whose backward is the collective's transpose:

  * ``all_gather``      — blocks -> the whole dim.  Backward: a
    reduce-scatter when the ranks' computations after it differ (their
    gradients are partial sums, ``grad="sum"``), or the rank's own slice
    when they are identical (``grad="slice"``).
  * ``reduce_scatter``  — partial sums -> summed blocks.  Backward: an
    all-gather.
  * ``all_reduce``      — partial sums -> the sum on every rank.  Backward:
    identity.
  * ``sum_grad``        — identity forward; backward sums the gradient
    over the axis (a replicated tensor entering per-rank work).
  * ``scatter``         — a replicated tensor -> the rank's block.
    Backward: an all-gather.
  * ``all_to_all``      — ``jax.lax.all_to_all(..., tiled=True)``: ``x``
    split along one dim into a piece per rank, piece j sent to rank j, the
    pieces received concatenated along another dim in rank order.
    Backward: the same exchange with the two dims swapped.
  * ``scale_grad``      — identity forward; backward multiplies the
    gradient by a constant.

They use ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_reduce`` and ``all_to_all_single`` of ``torch.distributed`` (c10d),
which ``gloo`` carries for CPU and CUDA tensors and ``nccl`` for CUDA ones.
An all-to-all moves its payload as bytes (a ``uint8`` view), so one call
carries bf16, int8 and float32 alike on either backend.  (The functional
collectives' all-gather, which DTensor's redistribution calls, crashes
under ``gloo`` with CUDA tensors.)  An axis of size 1 makes every call the
identity.

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh`` or the
single-rank ``launch.mesh.SingleMesh``.  ``calls`` counts the c10d calls
this process made, by kind (the serve engine reports collectives per
token from it); ``sent_bytes`` the bytes each all-to-all sent, by kind.
"""

from __future__ import annotations

from collections import Counter
from typing import Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Axis = Union[str, Tuple[str, ...]]

calls: Counter = Counter()
sent_bytes: Counter = Counter()


def _names(axis: Axis) -> Tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def axis_size(mesh, axis: Axis) -> int:
    out = 1
    for name in _names(axis):
        out *= mesh.size(mesh.mesh_dim_names.index(name))
    return out


def axis_rank(mesh, axis: Axis) -> int:
    """This rank's coordinate along ``axis`` (row-major over a tuple)."""
    out = 0
    for name in _names(axis):
        i = mesh.mesh_dim_names.index(name)
        out = out * mesh.size(i) + mesh.get_local_rank(i)
    return out


def axis_group(mesh, axis: Axis):
    names = _names(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def _gather(x: Tensor, dim: int, mesh, axis: Axis) -> Tensor:
    if x.dtype == torch.bool or (x.is_floating_point() and x.element_size() == 1):
        return _gather(x.view(torch.uint8), dim, mesh, axis).view(x.dtype)  # bools, fp8: bytes
    n = axis_size(mesh, axis)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
    calls["all_gather"] += 1
    dist.all_gather_into_tensor(out, xt, group=axis_group(mesh, axis))
    return out.movedim(0, dim)


def _reduce_scatter(x: Tensor, dim: int, mesh, axis: Axis) -> Tensor:
    n = axis_size(mesh, axis)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
    calls["reduce_scatter"] += 1
    dist.reduce_scatter_tensor(out, xt, group=axis_group(mesh, axis))
    return out.movedim(0, dim)


def _all_reduce(x: Tensor, mesh, axis: Axis) -> Tensor:
    x = x.clone()
    calls["all_reduce"] += 1
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x


def _all_to_all(x: Tensor, split_dim: int, concat_dim: int, mesh, axis: Axis) -> Tensor:
    n = axis_size(mesh, axis)
    xt = x.movedim(split_dim, 0)
    pieces = xt.reshape((n, xt.shape[0] // n) + xt.shape[1:]).contiguous()
    out = torch.empty_like(pieces)
    calls["all_to_all"] += 1
    sent_bytes["all_to_all"] += pieces.numel() * pieces.element_size()
    dist.all_to_all_single(out.view(torch.uint8), pieces.view(torch.uint8),
                           group=axis_group(mesh, axis))
    # out[j] is rank j's piece for this rank: put the pieces side by side
    # along ``concat_dim`` in rank order
    out = out.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(out.shape)
    shape[concat_dim:concat_dim + 2] = [shape[concat_dim] * shape[concat_dim + 1]]
    return out.reshape(shape)


def _slice(x: Tensor, dim: int, mesh, axis: Axis) -> Tensor:
    n = axis_size(mesh, axis)
    return x.chunk(n, dim=dim)[axis_rank(mesh, axis)]


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis, grad):
        ctx.args = (dim, mesh, axis, grad)
        return _gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis, grad = ctx.args
        if grad == "sum":
            return _reduce_scatter(g, dim, mesh, axis), None, None, None, None
        return _slice(g, dim, mesh, axis).contiguous(), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return _reduce_scatter(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return _gather(g, dim, mesh, axis), None, None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return _all_reduce(g, mesh, axis), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, mesh, axis):
        ctx.args = (split_dim, concat_dim, mesh, axis)
        return _all_to_all(x, split_dim, concat_dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, mesh, axis = ctx.args
        return _all_to_all(g, concat_dim, split_dim, mesh, axis), None, None, None, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis)
        return _slice(x, dim, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis = ctx.args
        return _gather(g, dim, mesh, axis), None, None, None


def _trivial(mesh, axis) -> bool:
    return axis is None or axis_size(mesh, axis) == 1


def all_gather(x: Tensor, dim: int, mesh, axis: Axis, grad: str = "sum") -> Tensor:
    if grad not in ("sum", "slice"):
        raise ValueError(grad)
    return x if _trivial(mesh, axis) else _AllGather.apply(x, dim, mesh, axis, grad)


def reduce_scatter(x: Tensor, dim: int, mesh, axis: Axis) -> Tensor:
    return x if _trivial(mesh, axis) else _ReduceScatter.apply(x, dim, mesh, axis)


def all_reduce(x: Tensor, mesh, axis: Axis) -> Tensor:
    return x if _trivial(mesh, axis) else _AllReduce.apply(x, mesh, axis)


def sum_grad(x: Tensor, mesh, axis: Axis) -> Tensor:
    return x if _trivial(mesh, axis) else _SumGrad.apply(x, mesh, axis)


def scatter(x: Tensor, dim: int, mesh, axis: Axis) -> Tensor:
    return x if _trivial(mesh, axis) else _Scatter.apply(x, dim, mesh, axis)


def all_to_all(x: Tensor, split_dim: int, concat_dim: int, mesh, axis: Axis) -> Tensor:
    return (x if _trivial(mesh, axis) else
            _AllToAll.apply(x, split_dim, concat_dim, mesh, axis))


def all_to_all_values(x: Tensor, split_dim: int, concat_dim: int, mesh, axis: Axis) -> Tensor:
    """``all_to_all`` outside autograd."""
    return x if _trivial(mesh, axis) else _all_to_all(x.detach(), split_dim, concat_dim, mesh,
                                                      axis)


def scale_grad(x: Tensor, factor: float) -> Tensor:
    return x if factor == 1 else _ScaleGrad.apply(x, factor)


def all_reduce_values(x: Tensor, mesh, axis: Axis) -> Tensor:
    """The sum over ``axis`` of a tensor outside autograd (metrics, norms)."""
    return x if _trivial(mesh, axis) else _all_reduce(x.detach(), mesh, axis)


def gather_values(x: Tensor, dim: int, mesh, axis: Axis) -> Tensor:
    """The whole of a dim sharded over ``axis``, outside autograd."""
    return x if _trivial(mesh, axis) else _gather(x.detach(), dim, mesh, axis)


def slice_values(x: Tensor, dim: int, mesh, axis: Axis) -> Tensor:
    """This rank's block of ``x`` along ``dim``, outside autograd."""
    return x if _trivial(mesh, axis) else _slice(x, dim, mesh, axis)
