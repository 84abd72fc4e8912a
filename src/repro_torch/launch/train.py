"""Training launcher: the port of the JAX package's ``repro.launch.train``.

Runs training on one device with the full substrate: the fault-tolerant
loop, checkpoints and deterministic data.  It runs on the CUDA card unless
``--device cpu`` is given (``--reduced`` configs are CPU-sized).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \\
      --steps 200 --batch 8 --seq 256 --data bigram --ckpt-dir /tmp/ckpt --device cpu

Re-invoking the same command after an interruption resumes from the newest
committed checkpoint (exactly: the data pipeline is stateless in step).
The mesh flags (``--mesh-data``/``--mesh-model`` > 1, ``--production-mesh``,
``--multi-pod``) raise: sharded training is not ported yet.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data import make_task
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, count_params
from repro_torch.optim import cosine_warmup, make_optimizer
from repro_torch.train import TrainLoopConfig, make_train_step, run_training, train_state_init


def build_optimizer(name: str, lr: float, warmup: int, total: int, cfg: ModelConfig):
    """The optimizer ``name`` at its defaults over ``cosine_warmup(lr, warmup,
    total)``; ``cfg`` gives Adafactor the model's stacking."""
    return make_optimizer(name, cosine_warmup(lr, warmup, total), cfg=cfg)


def main(argv=None):
    """Parses ``argv`` (the reference's flags plus ``--device``), trains and
    returns the final ``TrainState``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS, required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--backend", choices=("softmax", "taylor", "linear_elu"))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--optimizer", default="adamw",
                    choices=("adamw", "adafactor", "sgdm"))
    ap.add_argument("--data", default="bigram", choices=("bigram", "copy", "uniform"))
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh-data", type=int, default=1)
    ap.add_argument("--mesh-model", type=int, default=1)
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--max-wall-seconds", type=float, default=None)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)

    if args.mesh_data > 1 or args.mesh_model > 1 or args.production_mesh or args.multi_pod:
        raise NotImplementedError(
            "--mesh-data/--mesh-model > 1, --production-mesh and --multi-pod are not yet "
            "ported to torch (ROADMAP queue 1 item 6)")
    device = resolve_device(args.device)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.backend and not cfg.is_attention_free:
        cfg = cfg.replace(attention=args.backend)
    if args.seq % cfg.attn_chunk != 0:
        cfg = cfg.replace(attn_chunk=min(args.seq, cfg.attn_chunk))

    print(f"[train] {cfg.name} ({count_params(cfg):,} params) on mesh "
          f"{{'data': 1, 'model': 1}} ({device}) backend={cfg.attention}")

    task = make_task(args.data, cfg.vocab, args.seq, args.batch, seed=args.seed)
    optimizer = build_optimizer(args.optimizer, args.lr, args.warmup, args.steps, cfg)
    # weights drawn on the device (a CUDA generator draws billions in seconds)
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def batch_at(step: int):
        b = dict(task.batch_at(step))
        b.update(task.extras_at(step, cfg))
        return {k: torch.from_numpy(v).to(device) for k, v in b.items()}

    loop = TrainLoopConfig(
        total_steps=args.steps,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        log_every=args.log_every,
        max_wall_seconds=args.max_wall_seconds,
    )
    t0 = time.monotonic()
    # the initial state is not bound here: the loop frees it after the first
    # step (or the restore), as the reference's jitted step donates it
    state = run_training(make_train_step(cfg, optimizer),
                         train_state_init(gen, cfg, optimizer, device=device), batch_at, loop)
    dt = time.monotonic() - t0
    print(f"[train] done: step={int(state.step)} wall={dt:.1f}s")
    return state


if __name__ == "__main__":
    main()
