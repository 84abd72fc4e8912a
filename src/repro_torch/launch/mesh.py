"""Meshes over the ranks of a ``torch.distributed`` process group.

The port's counterpart of the JAX package's ``launch/mesh.py``: a
``DeviceMesh`` with the reference's axis names ("data", "model"; "pod"
first on a multi-pod mesh), one rank per device.  The caller initialises
the process group (``nccl`` for one card a rank, ``gloo`` for ranks that
share a card or run on the CPU) and sets each rank's CUDA device.  A mesh
is built only from ranks that exist: one that needs more ranks than the
group has raises (``make_host_mesh`` shrinks first, as the reference
does), and so does one that would leave ranks outside it.  Without a
process group (one process) the mesh is the 1×1 ``SingleMesh``.

``AbstractMesh`` (``distributed/collectives.py``) stands for one rank of a
mesh that has no processes (rank (0, 0) of the 16×16 production mesh,
say): the collectives over it communicate nothing and return tensors of
their results' shapes.  The dry run (``launch/dryrun.py``) traces a rank's
program on it.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.distributed.collectives import AbstractMesh


class SingleMesh:
    """The 1×1 (or 1×1×1) mesh of a single process: every axis has size 1,
    so every collective over it is the identity."""

    def __init__(self, axis_names: Sequence[str]):
        self.mesh_dim_names = tuple(axis_names)

    def size(self, dim: Optional[int] = None) -> int:
        return 1

    def get_local_rank(self, dim: int = 0) -> int:
        return 0

    @property
    def shape(self) -> Tuple[int, ...]:
        return (1,) * len(self.mesh_dim_names)

    def __repr__(self) -> str:
        return f"SingleMesh({dict.fromkeys(self.mesh_dim_names, 1)})"


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """``make_production_mesh``'s shape and axes as an ``AbstractMesh`` (its
    first rank)."""
    return AbstractMesh(*_production_topology(multi_pod))


def _production_topology(multi_pod: bool):
    """(shape, axes) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def world_size() -> int:
    """Ranks in the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...], device=None):
    need = math.prod(shape)
    n = world_size()
    if need != n:
        raise ValueError(f"a {'×'.join(map(str, shape))} mesh needs {need} ranks, but the "
                         f"process group has {n}")
    if n == 1:
        return SingleMesh(axes)
    from torch.distributed.device_mesh import init_device_mesh  # noqa: PLC0415

    return init_device_mesh(resolve_device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The reference's production topology: 16×16 = 256 ranks as ("data",
    "model"); multi-pod = 2×16×16 = 512 with a leading "pod" axis.  Raises
    with fewer ranks."""
    return _mesh(*_production_topology(multi_pod), device)


def make_host_mesh(data: int = 1, model: int = 1, device=None):
    """A small mesh over the ranks that exist: ``data × model`` when the
    process group has that many ranks, else (as the reference) ``(ranks, 1)``
    (1×1 in a single process)."""
    n = world_size()
    if data * model > n:
        data, model = n, 1
    return _mesh((data, model), ("data", "model"), device)


def make_serve_mesh(slots: int = 1, model: int = 1, device=None):
    """Serving mesh for ``ServeEngine(mesh=)``: "data" shards the engine's
    slots, "model" its heads and ``d_ff``.  Unlike ``make_host_mesh`` it
    refuses to shrink."""
    n = world_size()
    if slots * model > n:
        raise ValueError(f"make_serve_mesh({slots}×{model}) needs {slots * model} ranks "
                         f"but only {n} are in the process group")
    return _mesh((slots, model), ("data", "model"), device)


def mesh_shape(mesh) -> dict:
    """``{axis: size}`` of a mesh, as the reference prints it."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def set_rank_device(device=None) -> torch.device:
    """This rank's device: on CUDA, card ``rank % cards`` (ranks share a card
    when there are more ranks than cards) made current; else the CPU."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        rank = dist.get_rank() if dist.is_initialized() else 0
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev
