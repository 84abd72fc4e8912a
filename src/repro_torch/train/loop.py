"""Fault-tolerant training loop.

The process may be re-launched after any failure; the loop resumes from
the newest *committed* checkpoint (torn saves are invisible by
construction).  The data pipeline is stateless in the step index, so
resume is sample-exact.  Checkpoints are written every
``checkpoint_every`` steps (asynchronously unless ``async_save`` is off)
and on exit.

``max_wall_seconds`` stops the loop cleanly mid-run (a simulated
preemption in tests); a second invocation continues to the target step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    wait_for_saves,
)
from repro_torch.train.step import TrainState


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 100
    log_every: int = 10
    keep: int = 3
    async_save: bool = True
    max_wall_seconds: Optional[float] = None


def run_training(
    step_fn: Callable,
    state: TrainState,
    batch_at: Callable[[int], Dict[str, torch.Tensor]],
    loop: TrainLoopConfig,
    log: Callable[[str], None] = print,
) -> TrainState:
    """Run ``step_fn`` from the newest committed step (or ``state``) up to
    ``loop.total_steps``; returns the final state."""
    if loop.checkpoint_dir and latest_step(loop.checkpoint_dir) is not None:
        state = restore_checkpoint(loop.checkpoint_dir, state,
                                   step=latest_step(loop.checkpoint_dir))
        log(f"[loop] resumed from checkpoint step {int(state.step)}")
    start_step = int(state.step)

    t0 = time.monotonic()
    for step in range(start_step, loop.total_steps):
        state, metrics = step_fn(state, batch_at(step))
        if loop.log_every and (step + 1) % loop.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            log(f"[loop] step {step + 1}/{loop.total_steps} " +
                " ".join(f"{k}={v:.4f}" for k, v in sorted(m.items())))
        if (
            loop.checkpoint_dir
            and loop.checkpoint_every
            and (step + 1) % loop.checkpoint_every == 0
        ):
            save_checkpoint(loop.checkpoint_dir, step + 1, state,
                            block=not loop.async_save, keep=loop.keep)
        if loop.max_wall_seconds and time.monotonic() - t0 > loop.max_wall_seconds:
            log(f"[loop] wall-clock budget hit at step {step + 1} (simulated preemption)")
            break

    if loop.checkpoint_dir:
        wait_for_saves()
        final = int(state.step)
        if latest_step(loop.checkpoint_dir) != final:
            save_checkpoint(loop.checkpoint_dir, final, state, block=True, keep=loop.keep)
    return state
