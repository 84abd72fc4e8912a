"""Distributed runtime: logical sharding rules, param specs, the sharded step."""

from repro_torch.distributed.api import (
    DEFAULT_RULES,
    SINGLE_POD_RULES,
    logical_to_spec,
    mesh_axis_size,
    resolve_axes,
    rules_for_mesh,
    sharding_rules,
)

__all__ = [
    "DEFAULT_RULES",
    "SINGLE_POD_RULES",
    "logical_to_spec",
    "mesh_axis_size",
    "resolve_axes",
    "rules_for_mesh",
    "sharding_rules",
]
