"""Training launcher: the port of the JAX package's ``repro.launch.train``.

Runs training with the full substrate: sharded state, the fault-tolerant
loop, checkpoints and deterministic data.  It runs on the CUDA card unless
``--device cpu`` is given (``--reduced`` configs are CPU-sized).

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --reduced \\
      --steps 200 --batch 8 --seq 256 --data bigram --ckpt-dir /tmp/ckpt --device cpu

Re-invoking the same command after an interruption resumes from the newest
committed checkpoint (exactly: the data pipeline is stateless in step).

On a mesh every rank runs this command: a ``torchrun``-style launch
(``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT`` in the
environment; ``--dist-backend``: ``nccl`` for one card a rank, ``gloo`` for
ranks that share a card or the CPU) or a process group the caller set up.
``--mesh-data``/``--mesh-model`` make a host mesh over the ranks
(``launch.mesh.make_host_mesh``: one process shrinks to 1×1 and trains on
one device); ``--production-mesh`` (``--multi-pod``) asks for 256 (512)
ranks and raises with fewer.  Every model and optimizer trains on a mesh:
MoE experts over "model" (the reference's ``ep_a2a``), the cross-attention
families with their encoder or projector, and Adafactor with its
statistics over the global stacked leaves.
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.data import make_task
from repro_torch.device import resolve_device
from repro_torch.distributed import api as dist_api
from repro_torch.distributed.api import P
from repro_torch.distributed.sharding import (
    Placements,
    batch_specs,
    block_shape,
    distribute_tree,
    opt_state_specs,
    param_specs,
)
from repro_torch.launch.mesh import (
    SingleMesh,
    make_host_mesh,
    make_production_mesh,
    mesh_shape,
    set_rank_device,
)
from repro_torch.models import lm_init
from repro_torch.models.lm import init_generator
from repro_torch.models.config import ModelConfig, count_params
from repro_torch.optim import cosine_warmup, make_optimizer
from repro_torch.train import TrainLoopConfig, make_train_step, run_training, train_state_init
from repro_torch.train.step import TrainState, make_sharded_train_step
from repro_torch.tree import tree_map


def build_optimizer(name: str, lr: float, warmup: int, total: int, cfg: ModelConfig):
    """The optimizer ``name`` at its defaults over ``cosine_warmup(lr, warmup,
    total)``; ``cfg`` gives Adafactor the model's stacking."""
    return make_optimizer(name, cosine_warmup(lr, warmup, total), cfg=cfg)


def make_sharded_state_and_step(cfg: ModelConfig, optimizer, mesh, rules, batch_shapes,
                                seed: int = 0, device=None):
    """The train state on ``mesh``, its step, and where both live.

    Every rank draws the same whole params from ``seed`` on ``device`` (a
    CUDA generator on a card; on the meta device the shapes alone, which the
    dry run traces), so a sharded run starts from the weights of
    an unsharded run of the same seed; each rank keeps its blocks
    (``param_specs``) and its blocks of a fresh optimizer state: the whole
    state's shapes (``optimizer.init`` of the whole params on the meta
    device) cut by ``opt_state_specs``, matched against the tree the state
    follows (``optimizer.state_layout``: Adafactor's stacked one).  A fresh
    state is zeros, and its blocks follow the whole leaves' shapes, so
    Adafactor's factored statistics are the whole leaf's even where a
    block's dim is 1.

    Returns:
      ``(state, step_fn, state_placements, batch_placements)``:
      ``step_fn(state, batch)`` takes the whole batch (the same on every
      rank) and returns ``(state, metrics)``; the placements are
      ``distributed.sharding.Placements`` of the ``TrainState`` and of
      ``batch_shapes``.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    params = lm_init(init_generator(seed, device), cfg, device=device)
    pspecs = param_specs(params, mesh, rules)
    meta = tree_map(lambda p: torch.empty_like(p, device="meta"), params)
    oshapes = optimizer.init(meta)
    like = optimizer.state_layout(meta)
    ospecs = opt_state_specs(oshapes, param_specs(like, mesh, rules), like, mesh, rules)
    local = distribute_tree(params, Placements(mesh, pspecs))
    del params
    opt_state = tree_map(lambda x, spec: torch.zeros(block_shape(x.shape, spec, mesh),
                                                     dtype=x.dtype, device=device),
                         oshapes, ospecs)
    state = TrainState(step=torch.zeros((), dtype=torch.int32, device=device), params=local,
                       opt_state=opt_state)
    placements = Placements(mesh, TrainState(step=P(), params=pspecs, opt_state=ospecs))
    batch_placements = Placements(mesh, batch_specs(batch_shapes, mesh, rules))
    return (state, make_sharded_train_step(cfg, optimizer, placements, rules), placements,
            batch_placements)


def _init_process_group(backend) -> None:
    """Join a ``torchrun``-style launch (``WORLD_SIZE`` > 1 in the
    environment) unless the caller set a process group up."""
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return
    dist.init_process_group(backend, init_method="env://")


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
    ap.add_argument("--dist-backend", default=None, choices=("gloo", "nccl"),
                    help="a multi-process launch's backend (default: nccl on CUDA, "
                         "gloo on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    _init_process_group(args.dist_backend or ("nccl" if device.type == "cuda" else "gloo"))
    device = set_rank_device(device)
    if args.production_mesh:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=device)
    else:
        mesh = make_host_mesh(args.mesh_data, args.mesh_model, device=device)
    sharded = not isinstance(mesh, SingleMesh)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    if args.backend and not cfg.is_attention_free:
        cfg = cfg.replace(attention=args.backend)
    if args.seq % cfg.attn_chunk != 0:
        cfg = cfg.replace(attn_chunk=min(args.seq, cfg.attn_chunk))

    if rank0:
        print(f"[train] {cfg.name} ({count_params(cfg):,} params) on mesh "
              f"{mesh_shape(mesh)} ({device}) backend={cfg.attention}")

    task = make_task(args.data, cfg.vocab, args.seq, args.batch, seed=args.seed)
    optimizer = build_optimizer(args.optimizer, args.lr, args.warmup, args.steps, cfg)
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
    log = print if rank0 else (lambda msg: None)
    t0 = time.monotonic()
    if sharded:
        shapes = {k: torch.empty_like(v, device="meta") for k, v in batch_at(0).items()}
        state, step_fn, placements, _ = make_sharded_state_and_step(
            cfg, optimizer, mesh, dist_api.rules_for_mesh(mesh), shapes, seed=args.seed,
            device=device)
        state = run_training(step_fn, state, batch_at, loop, log=log,
                             state_placements=placements)
    else:
        # weights drawn on the device (a CUDA generator draws billions in
        # seconds); the initial state is not bound here: the loop frees it
        # after the first step (or the restore), as the reference's jitted
        # step donates it
        gen = torch.Generator(device=device).manual_seed(args.seed)
        state = run_training(make_train_step(cfg, optimizer),
                             train_state_init(gen, cfg, optimizer, device=device), batch_at,
                             loop, log=log)
    dt = time.monotonic() - t0
    log(f"[train] done: step={int(state.step)} wall={dt:.1f}s")
    return state


if __name__ == "__main__":
    main()
