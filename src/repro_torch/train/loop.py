"""Fault-tolerant training loop.

The process may be re-launched after any failure; the loop resumes from
the newest *committed* checkpoint (torn saves are invisible by
construction).  The data pipeline is stateless in the step index, so
resume is sample-exact.  Checkpoints are written every
``checkpoint_every`` steps (asynchronously unless ``async_save`` is off)
and on exit.

``max_wall_seconds`` stops the loop cleanly mid-run (a simulated
preemption in tests); a second invocation continues to the target step.

On a mesh (``state_placements``: the state's ``Placements``) every rank
runs the loop: checkpoints hold the whole state, written by rank 0 and
waited for by every rank, and the restore cuts them to this mesh.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

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
    state_placements=None,
) -> TrainState:
    """Run ``step_fn`` from the newest committed step (or ``state``) up to
    ``loop.total_steps``; returns the final state.  With
    ``state_placements`` the state's leaves are this rank's blocks."""
    sharded = state_placements is not None
    save = lambda step, block: save_checkpoint(loop.checkpoint_dir, step, state,
                                                block=block or sharded, keep=loop.keep,
                                                placements=state_placements)
    if loop.checkpoint_dir and latest_step(loop.checkpoint_dir) is not None:
        state = restore_checkpoint(loop.checkpoint_dir, state,
                                   step=latest_step(loop.checkpoint_dir),
                                   placements=state_placements)
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
            save(step + 1, not loop.async_save)
        if loop.max_wall_seconds and _any_rank(time.monotonic() - t0 > loop.max_wall_seconds,
                                               sharded, state.step.device):
            log(f"[loop] wall-clock budget hit at step {step + 1} (simulated preemption)")
            break

    if loop.checkpoint_dir:
        wait_for_saves()
        final = int(state.step)
        if latest_step(loop.checkpoint_dir) != final:
            save(final, True)
    return state


def _any_rank(flag: bool, sharded: bool, device) -> bool:
    """``flag`` of any rank (every rank takes the same branch on a mesh)."""
    if not sharded or not dist.is_initialized():
        return flag
    t = torch.tensor(float(flag), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())
