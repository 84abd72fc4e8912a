"""Quickstart: train a small LM with the paper's Taylor-linear attention.

The port's counterpart of the JAX package's ``examples/quickstart.py``:
config -> bigram data -> AdamW with cosine warmup -> fault-tolerant
training loop -> greedy generation.  It runs on the CUDA card (the Taylor
attention forward and backward on the hand-written kernels); pass
``--device cpu`` to run the plain PyTorch paths on the CPU.  The reduced
smollm config (~0.1M params) is the default; ``--full-135m`` trains the
full SmolLM-135M geometry (random weights).

  PYTHONPATH=src python -m repro_torch.quickstart --device cpu
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, get_reduced
from repro_torch.data import make_task
from repro_torch.device import resolve_device
from repro_torch.models import count_params
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.serve import generate
from repro_torch.train import TrainLoopConfig, make_train_step, run_training, train_state_init


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-135m", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config("smollm-135m") if args.full_135m else get_reduced("smollm-135m")
    print(f"model: {cfg.name} ({count_params(cfg):,} params), "
          f"attention={cfg.attention} (order-{cfg.taylor.order}, α={cfg.taylor.alpha}) "
          f"on {device}")

    task = make_task("bigram", cfg.vocab, args.seq, args.batch, seed=0)
    opt = adamw(cosine_warmup(2e-3, args.steps // 10, args.steps))
    state = train_state_init(torch.Generator().manual_seed(0), cfg, opt, device=device)
    step = make_train_step(cfg, opt)

    loop = TrainLoopConfig(
        total_steps=args.steps, checkpoint_dir=args.ckpt_dir,
        checkpoint_every=100, log_every=20,
    )

    def batch_at(s):
        return {k: torch.from_numpy(v).to(device) for k, v in task.batch_at(s).items()}

    state = run_training(step, state, batch_at, loop)

    prompt = torch.from_numpy(task.batch_at(10_000)["tokens"][:2, :16]).long()
    out = generate(state.params, {"tokens": prompt.to(device)}, cfg, steps=12, device=device)
    print("prompt :", prompt[0].tolist())
    print("greedy :", out[0].tolist())


if __name__ == "__main__":
    main()
