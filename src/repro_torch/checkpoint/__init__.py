"""Fault-tolerant checkpointing."""

from repro_torch.checkpoint.store import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_saves,
)

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint", "wait_for_saves"]
