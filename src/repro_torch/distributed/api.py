"""Logical-axis sharding API over ``torch.distributed`` device meshes.

Models and the sharded step name layouts with *logical* axis names ("dp",
"fsdp", "tp", "ep", "sp", None).  A ``sharding_rules`` context binds
logical names to the physical mesh axes ("data", "model"; "pod" on a
multi-pod mesh); outside the context nothing is sharded, so every
unsharded path runs as it did.  Parameters get their specs from
rule-based path matching in ``distributed/sharding.py``.

The counterparts of the JAX package's types:

  * ``P`` — a partition spec: one entry per tensor dim, each a physical
    axis name, a tuple of names, ``None`` (replicated) or
    ``P.UNCONSTRAINED`` (left as the tensor has it).
  * ``resolve_axes`` — the spec that the reference's ``constrain`` hands
    to the partitioner: logical axes resolved under the rules, with its
    divisibility drop and one-axis-once rule.  The port has no
    partitioner: every tensor of its sharded step is a rank's local block
    (no DTensor), and the layout hooks of ``distributed/spmd.py`` reach
    the resolved layout with explicit collectives
    (``distributed/collectives.py``).
  * ``shard_map`` — whole tensors cut into each rank's blocks, a function
    run on the blocks with collectives of its own, its outputs gathered
    back whole.

A mesh is any object with ``mesh_dim_names`` and ``size(dim)`` (a
``DeviceMesh``, or ``launch.mesh.SingleMesh``) or with ``axis_names`` and
a ``shape`` dict (a stand-in that derives specs for meshes larger than
the machine).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Mapping, Optional, Sequence, Tuple, Union

# logical name -> physical mesh axis (or tuple of axes)
Rules = Mapping[str, Union[str, Tuple[str, ...], None]]

# Default logical names:
#   dp  — data parallel (batch dim)           -> ("pod", "data") on prod meshes
#   fsdp— parameter sharding dim              -> "data"
#   tp  — tensor parallel (heads / ffn / vocab)-> "model"
#   ep  — expert parallel                     -> "model"
#   sp  — sequence parallelism of the residual stream -> "model"
DEFAULT_RULES: Rules = {
    "dp": ("pod", "data"),
    "fsdp": "data",
    "tp": "model",
    "ep": "model",
    "sp": "model",
}

SINGLE_POD_RULES: Rules = {
    "dp": "data",
    "fsdp": "data",
    "tp": "model",
    "ep": "model",
    "sp": "model",
}

_ACTIVE: contextvars.ContextVar[Optional[Tuple[Any, Rules]]] = contextvars.ContextVar(
    "repro_torch_sharding_rules", default=None
)


class P:
    """A partition spec: ``P("data", None)`` shards dim 0 over "data".

    Its entries equal the JAX package's ``PartitionSpec``'s one for one
    (``tuple(spec)``).  It is a leaf of the port's trees (not a tuple), so
    a tree of specs mirrors a tree of tensors."""

    UNCONSTRAINED = "*"
    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        try:
            return self.entries == tuple(other)
        except TypeError:
            return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def _axis_size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return mesh.size(axis_names(mesh).index(name))
    return mesh.shape[name]


def mesh_axis_size(mesh, name: Union[str, Tuple[str, ...], None]) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        out = 1
        for n in name:
            out *= _axis_size(mesh, n)
        return out
    return _axis_size(mesh, name)


def rules_for_mesh(mesh, **overrides) -> Rules:
    base = dict(DEFAULT_RULES if "pod" in axis_names(mesh) else SINGLE_POD_RULES)
    base.update(overrides)
    return base


@contextlib.contextmanager
def sharding_rules(mesh, rules: Optional[Rules] = None):
    token = _ACTIVE.set((mesh, rules if rules is not None else rules_for_mesh(mesh)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[Tuple[Any, Rules]]:
    return _ACTIVE.get()


def logical_to_spec(axes: Sequence[Optional[str]], rules: Rules) -> P:
    resolved = []
    for name in axes:
        if name is None:
            resolved.append(None)
        elif name == "*":  # left as the tensor has it
            resolved.append(P.UNCONSTRAINED)
        else:
            resolved.append(rules.get(name))
    return P(*resolved)


def resolve_axes(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
                 rules: Rules) -> P:
    """Logical axes -> a physical spec for ``shape``: an axis whose dim does
    not divide by its physical axis size is dropped (batch-1 decode, an
    encoder's 1500 frames), and one physical axis appears only once."""
    resolved = []
    for name, size in zip(axes, shape):
        if name == "*":
            resolved.append(P.UNCONSTRAINED)
            continue
        phys = rules.get(name) if name else None
        if phys is not None and size % mesh_axis_size(mesh, phys) != 0:
            phys = None
        resolved.append(phys)
    seen = set()
    final = []
    for phys in resolved:
        if phys == P.UNCONSTRAINED:
            final.append(phys)
            continue
        key = tuple(phys) if isinstance(phys, tuple) else phys
        if phys is not None and key in seen:
            phys = None
        if phys is not None:
            seen.add(key)
        final.append(phys)
    return P(*final)


def entry_names(entry) -> Tuple[str, ...]:
    """The physical axis names of one spec entry (none for ``None``)."""
    if entry is None or entry == P.UNCONSTRAINED:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def shard_map(f, mesh, in_specs, out_specs):
    """``f`` run on each rank's local blocks of whole tensors.

    Every rank passes the same whole inputs; each is cut to the rank's
    block along the dims that ``in_specs`` shard (``None`` for a non-tensor
    argument), ``f`` runs on the blocks with collectives of its own, and
    its outputs (one spec, or a tuple of them) are gathered back whole
    along the dims that ``out_specs`` shard.  Differentiable, with the
    reference's transposes: a block's gradient is gathered back whole, and
    the gradient of an input left whole over an axis that other inputs are
    split over is summed over that axis."""
    from repro_torch.distributed import collectives as col  # noqa: PLC0415

    split = {name for spec in in_specs if spec is not None
             for entry in spec for name in entry_names(entry)}

    def place_in(x, spec):
        if spec is None:
            return x
        own = {name for entry in spec for name in entry_names(entry)}
        for name in sorted(split - own):
            x = col.sum_grad(x, mesh, name)
        for dim, entry in enumerate(spec):
            if entry_names(entry):
                x = col.scatter(x, dim, mesh, entry)
        return x

    def place_out(y, spec):
        for dim, entry in enumerate(spec):
            if entry_names(entry):
                y = col.all_gather(y, dim, mesh, entry, grad="slice")
        return y

    single = isinstance(out_specs, P)

    def wrapped(*args):
        outs = f(*(place_in(x, s) for x, s in zip(args, in_specs)))
        if single:
            return place_out(outs, out_specs)
        return tuple(place_out(y, s) for y, s in zip(outs, out_specs))

    return wrapped
