"""Run a function on several local ranks, each joined to one process group.

``run_ranks(fn, world, backend=..., init_file=...)`` spawns ``world``
processes; rank ``r`` joins the group through the file store
``init_file`` (no port to race for), runs ``fn(r, world, *args)`` and sends
its return value (picklable: numpy arrays, numbers) back.  The caller
picks the backend: ``gloo`` for ranks on the CPU or sharing one card,
``nccl`` for one card a rank.  ``threads`` sets each rank's torch threads
(one, so that ranks on one machine do not oversubscribe its cores).  A
rank that raises stops all of them and the error is raised here.
"""

from __future__ import annotations

import os
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank_main(rank: int, world: int, backend: str, init_file: str, fn: Callable,
               args: Sequence, threads: int, queue) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                            world_size=world)
    try:
        out = fn(rank, world, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    queue.put((rank, out))


def run_ranks(fn: Callable, world: int, *, backend: str, init_file: str, args: Sequence = (),
              threads: int = 1) -> List[Any]:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    in its own process (``fn`` must be importable by name)."""
    if os.path.exists(init_file):
        raise FileExistsError(f"{init_file}: a file store must start empty")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.spawn(_rank_main, args=(world, backend, init_file, fn, tuple(args), threads,
                                       queue), nprocs=world, join=False)
    outs, done = {}, False
    while True:
        while not queue.empty():  # read as they come: a large result fills the pipe
            rank, out = queue.get()
            outs[rank] = out
        if len(outs) == world:
            break
        if done:
            raise RuntimeError(f"ranks {sorted(set(range(world)) - set(outs))} returned nothing")
        done = procs.join(timeout=0.05)  # raises when a rank failed
    while not done:
        done = procs.join(timeout=0.05)
    return [outs[r] for r in range(world)]
