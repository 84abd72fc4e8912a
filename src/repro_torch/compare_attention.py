"""The paper's comparison: train identical models with softmax / taylor-2 /
taylor-1 / elu-linear attention on associative recall and report the loss
gap.

The port's counterpart of the JAX package's ``examples/compare_attention.py``
(same task, model, optimizer and variants; the weights come from the port's
own seeded init).  It runs on the CUDA card (the Taylor variants through the
hand-written kernels); pass ``--device cpu`` to run the plain PyTorch paths
on the CPU.

  PYTHONPATH=src python -m repro_torch.compare_attention --steps 300
"""

from __future__ import annotations

import argparse
import math
from typing import Dict

import torch

from repro_torch.configs import get_reduced
from repro_torch.core.feature_map import TaylorConfig
from repro_torch.data import make_task
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import make_train_step, train_state_init


def train(cfg, task, steps: int, device, seed: int = 0) -> float:
    """Final-step training loss of ``cfg`` after ``steps`` AdamW steps."""
    opt = adamw(cosine_warmup(2e-3, steps // 10, steps), weight_decay=0.0)
    state = train_state_init(torch.Generator().manual_seed(seed), cfg, opt, device=device)
    step = make_train_step(cfg, opt)
    loss = None
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in task.batch_at(s).items()}
        state, m = step(state, batch)
        loss = m["loss"]
    return float(loss)


def variants() -> Dict[str, object]:
    """The four configs compared, by their printed name."""
    base = get_reduced("smollm-135m").replace(n_groups=2)
    return {
        "softmax    (exact)            ": base.replace(attention="softmax"),
        "taylor-2   (the paper)        ": base.replace(attention="taylor",
                                                        taylor=TaylorConfig(order=2)),
        "taylor-1   (linear transformer)": base.replace(attention="taylor",
                                                        taylor=TaylorConfig(order=1)),
        "elu-linear (Katharopoulos'20) ": base.replace(attention="linear_elu"),
    }


def main(argv=None) -> Dict[str, float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfgs = variants()
    vocab = next(iter(cfgs.values())).vocab
    task = make_task("copy", vocab, 64, 8, seed=7)
    print(f"associative recall, {args.steps} steps, vocab={vocab} "
          f"(uniform floor = {math.log(float(vocab)):.3f}) on {device}")
    losses = {}
    for name, cfg in cfgs.items():
        losses[name] = train(cfg, task, args.steps, device)
        print(f"  {name}: final loss = {losses[name]:.4f}")
    return losses


if __name__ == "__main__":
    main()
