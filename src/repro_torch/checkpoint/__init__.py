"""Fault-tolerant checkpointing, and checkpoints in the JAX trainer's layout."""

from repro_torch.checkpoint.from_jax import restore_jax_checkpoint, to_jax_layout_state
from repro_torch.checkpoint.store import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_saves,
)

__all__ = [
    "latest_step",
    "restore_checkpoint",
    "restore_jax_checkpoint",
    "save_checkpoint",
    "to_jax_layout_state",
    "wait_for_saves",
]
