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

A mesh here is a ``torch.distributed.device_mesh.DeviceMesh``, the
single-rank ``launch.mesh.SingleMesh`` or an ``AbstractMesh``:
one rank of a mesh that has no processes, over which every collective
communicates nothing and returns a tensor of its result's shape (the dry
run traces a rank's program on meta tensors that way).  ``calls`` counts
the collectives this process issued (over an abstract mesh too), by kind
(the serve engine reports collectives per token from it); ``sent_bytes``
the bytes each all-to-all sent, by kind.

``recording()`` collects a ``Record`` of every collective made while it is
open, on any mesh, real or abstract, in any thread (the card runs the
backward on a thread of its own): its kind, the bytes of its result on
this rank, its group's size and its site.  The site is the stack of names
that ``named`` pushes (the model's layer, the ``distributed.spmd`` hook:
``"layer3/attn"``); a collective of a backward keeps the site of the
forward call it transposes, with ``"/bwd"`` added.
``analysis/collectives.py`` and ``analysis/roofline.py`` read records.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from collections import Counter
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Tensor = torch.Tensor
Axis = Union[str, Tuple[str, ...]]

calls: Counter = Counter()
sent_bytes: Counter = Counter()


class AbstractMesh:
    """One rank, at ``coords``, of a ``shape`` mesh over ``axes`` that has no
    processes.  It answers what a ``DeviceMesh`` answers of its shape and of
    this rank's place; the collectives below communicate nothing over it
    (their results hold no data: trace on meta tensors)."""

    def __init__(self, shape: Sequence[int], axes: Sequence[str],
                 coords: Optional[Sequence[int]] = None):
        self.mesh_shape = tuple(int(s) for s in shape)
        self.mesh_dim_names = tuple(axes)
        self.coords = tuple(coords) if coords is not None else (0,) * len(self.mesh_shape)
        if not (len(self.mesh_shape) == len(self.mesh_dim_names) == len(self.coords)) or any(
                not 0 <= c < s for c, s in zip(self.coords, self.mesh_shape)):
            raise ValueError(f"bad abstract mesh: shape {shape}, axes {axes}, coords {coords}")

    def size(self, dim: Optional[int] = None) -> int:
        return math.prod(self.mesh_shape) if dim is None else self.mesh_shape[dim]

    def get_local_rank(self, dim: int = 0) -> int:
        return self.coords[dim]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.mesh_shape

    def __repr__(self) -> str:
        return (f"AbstractMesh({dict(zip(self.mesh_dim_names, self.mesh_shape))}, "
                f"coords={self.coords})")


class Record(NamedTuple):
    """One collective as this rank saw it."""

    kind: str    # "all-gather", "reduce-scatter", "all-reduce" or "all-to-all"
    nbytes: int  # bytes of its result on this rank
    group: int   # ranks in its group
    site: str    # where it was called: the ``named`` stack, "/"-joined ("-" if empty)


_LOGS: List[List[Record]] = []  # the open recordings
_SITE: contextvars.ContextVar[Tuple[str, ...]] = contextvars.ContextVar(
    "repro_torch_collective_site", default=())


@contextlib.contextmanager
def recording():
    """Yields a list that receives a ``Record`` of each collective made until
    the block ends."""
    log: List[Record] = []
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


@contextlib.contextmanager
def named(name: str):
    """Within it, the collectives' site has ``name`` as its last part."""
    token = _SITE.set(_SITE.get() + (name,))
    try:
        yield
    finally:
        _SITE.reset(token)


def current_site() -> str:
    return "/".join(_SITE.get()) or "-"


def _communicate(kind: str, fn, result: Tensor, *args, mesh, axis: Axis,
                 site: Optional[str]) -> None:
    """Counts and records one collective of result ``result``, then runs
    ``fn(result, *args, group=...)`` over ``axis``: nothing over an
    ``AbstractMesh``."""
    calls[kind.replace("-", "_")] += 1
    if _LOGS:
        rec = Record(kind, result.numel() * result.element_size(), axis_size(mesh, axis),
                     current_site() if site is None else site)
        for log in _LOGS:
            log.append(rec)
    if not isinstance(mesh, AbstractMesh):
        fn(result, *args, group=axis_group(mesh, axis))


def _bwd(site: str) -> str:
    return site + "/bwd"


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


def _gather(x: Tensor, dim: int, mesh, axis: Axis, site: Optional[str] = None) -> Tensor:
    if x.dtype == torch.bool or (x.is_floating_point() and x.element_size() == 1):
        # bools, fp8: bytes
        return _gather(x.view(torch.uint8), dim, mesh, axis, site).view(x.dtype)
    n = axis_size(mesh, axis)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((n * xt.shape[0],) + xt.shape[1:])
    _communicate("all-gather", dist.all_gather_into_tensor, out, xt, mesh=mesh, axis=axis,
                 site=site)
    return out.movedim(0, dim)


def _reduce_scatter(x: Tensor, dim: int, mesh, axis: Axis,
                    site: Optional[str] = None) -> Tensor:
    n = axis_size(mesh, axis)
    xt = x.movedim(dim, 0).contiguous()
    out = xt.new_empty((xt.shape[0] // n,) + xt.shape[1:])
    _communicate("reduce-scatter", dist.reduce_scatter_tensor, out, xt, mesh=mesh, axis=axis,
                 site=site)
    return out.movedim(0, dim)


def _all_reduce(x: Tensor, mesh, axis: Axis, site: Optional[str] = None) -> Tensor:
    x = x.clone()
    _communicate("all-reduce", dist.all_reduce, x, mesh=mesh, axis=axis, site=site)
    return x


def _all_to_all(x: Tensor, split_dim: int, concat_dim: int, mesh, axis: Axis,
                site: Optional[str] = None) -> Tensor:
    n = axis_size(mesh, axis)
    xt = x.movedim(split_dim, 0)
    pieces = xt.reshape((n, xt.shape[0] // n) + xt.shape[1:]).contiguous()
    out = torch.empty_like(pieces)
    sent_bytes["all_to_all"] += pieces.numel() * pieces.element_size()
    # as bytes (the record counts the same bytes)
    _communicate("all-to-all", dist.all_to_all_single, out.view(torch.uint8),
                 pieces.view(torch.uint8), mesh=mesh, axis=axis, site=site)
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
        ctx.args = (dim, mesh, axis, grad, current_site())
        return _gather(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis, grad, site = ctx.args
        if grad == "sum":
            return _reduce_scatter(g, dim, mesh, axis, _bwd(site)), None, None, None, None
        return _slice(g, dim, mesh, axis).contiguous(), None, None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, mesh, axis):
        ctx.args = (dim, mesh, axis, current_site())
        return _reduce_scatter(x, dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis, site = ctx.args
        return _gather(g, dim, mesh, axis, _bwd(site)), None, None, None


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
        ctx.args = (mesh, axis, current_site())
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, site = ctx.args
        return _all_reduce(g, mesh, axis, _bwd(site)), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split_dim, concat_dim, mesh, axis):
        ctx.args = (split_dim, concat_dim, mesh, axis, current_site())
        return _all_to_all(x, split_dim, concat_dim, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim, mesh, axis, site = ctx.args
        return (_all_to_all(g, concat_dim, split_dim, mesh, axis, _bwd(site)),
                None, None, None, None)


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
        ctx.args = (dim, mesh, axis, current_site())
        return _slice(x, dim, mesh, axis).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, mesh, axis, site = ctx.args
        return _gather(g, dim, mesh, axis, _bwd(site)), None, None, None


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
