"""Fault tolerance demo: training survives a (simulated) preemption.

The port's counterpart of the JAX package's ``examples/train_resume.py``:
reduced qwen2-1.5b on bigram data trains ``STEPS`` (30) steps
uninterrupted; then a second run with a checkpoint every third of them (10)
is stopped at half of them (15), and a third invocation of the same loop
resumes from the newest committed checkpoint and finishes.  The data
pipeline is stateless in the step index, so the resumed weights must equal
the uninterrupted run's (max |Δ| < 1e-5).  It runs on the CUDA card; pass
``--device cpu`` for the CPU.  ``run(device, steps)`` is the demo at
another length.

  PYTHONPATH=src python -m repro_torch.train_resume --device cpu
"""

from __future__ import annotations

import argparse
import shutil
import tempfile

import torch

from repro_torch.configs import get_reduced
from repro_torch.data import make_task
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, constant
from repro_torch.train import TrainLoopConfig, make_train_step, run_training, train_state_init
from repro_torch.tree import tree_leaves

STEPS = 30
SEQ_LEN, BATCH = 32, 4


def main(argv=None) -> float:
    """Runs the demo; returns the max param divergence of the resumed run."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    return run(resolve_device(args.device))


def run(device, steps: int = STEPS) -> float:
    """The demo with ``steps`` (at least 6) steps a full run, a checkpoint
    every ``steps // 3`` and the stop at ``steps // 2``; returns the max
    param divergence of the resumed run."""
    every, stop = steps // 3, steps // 2

    cfg = get_reduced("qwen2-1.5b")
    task = make_task("bigram", cfg.vocab, SEQ_LEN, BATCH, seed=0)

    def batch_at(s):
        return {k: torch.from_numpy(v).to(device) for k, v in task.batch_at(s).items()}

    opt = adamw(constant(1e-3))
    step = make_train_step(cfg, opt)

    def fresh():
        return train_state_init(torch.Generator().manual_seed(0), cfg, opt, device=device)

    # --- uninterrupted reference ---
    ref = run_training(step, fresh(), batch_at,
                       TrainLoopConfig(total_steps=steps, log_every=every))

    # --- interrupted + resumed ---
    ckpt = tempfile.mkdtemp(prefix="repro_torch_resume_")
    try:
        print(f"\n[phase 1] training with checkpoint_every={every}, killed at step ~{stop}")
        run_training(step, fresh(), batch_at,
                     TrainLoopConfig(total_steps=stop, checkpoint_dir=ckpt,
                                     checkpoint_every=every, log_every=every,
                                     async_save=False))
        print("\n[phase 2] rerunning the same command — auto-resume:")
        resumed = run_training(step, fresh(), batch_at,
                               TrainLoopConfig(total_steps=steps, checkpoint_dir=ckpt,
                                               checkpoint_every=every, log_every=every,
                                               async_save=False))
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    diff = max(float((a.float() - b.float()).abs().max())
               for a, b in zip(tree_leaves(ref.params), tree_leaves(resumed.params)))
    print(f"\nmax param divergence vs uninterrupted run: {diff:.2e}")
    if not diff < 1e-5:
        raise SystemExit("resume is not exact!")
    print("resume is exact ✓")
    return diff


if __name__ == "__main__":
    main()
