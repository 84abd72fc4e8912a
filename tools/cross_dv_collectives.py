#!/usr/bin/env python3
"""Counts the collectives a decode token costs a sharded cross-model engine
whose cross read state splits its d_v columns ("dv") against one that
splits its heads.

Two ``gloo`` ranks on the CPU serve the reduced llama-3.2-vision-11b on a
1×2 serving mesh, once with its 2 kv heads (every layer "heads") and once
with 1 (every layer "dv": each decode step gathers the key moments of the
self state and of the unchanging cross state, and cuts them back after).
Prints each engine's ``decode_collectives`` per decode token and the
collectives by kind over the run.  A count, not a time: it is the same on
any device.

    PYTHONPATH=src python3 tools/cross_dv_collectives.py
"""

from __future__ import annotations

import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

LENS, NEW = (12, 12), 16


def _rank(rank, world):
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.models import lm_init
    from repro_torch.serve import Request, ServeEngine

    mesh = make_serve_mesh(1, world, device="cpu")
    out = {}
    for kv in (2, 1):
        cfg = get_reduced("llama-3.2-vision-11b", n_kv_heads=kv)
        params = lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
        eng = ServeEngine(params, cfg, max_slots=2, n_max=64, decode_block=4, mesh=mesh,
                          device="cpu")
        rng = np.random.default_rng(0)
        before = dict(col.calls)
        for n in LENS:
            img = rng.normal(size=(1, cfg.n_image_tokens, cfg.vision_dim)).astype(np.float32)
            eng.submit(Request(tokens=rng.integers(0, cfg.vocab, (n,)), max_new_tokens=NEW,
                               extras={"image_embeds": img}))
        eng.run()
        st = eng.stats()
        out[kv] = dict(per_token=st["decode_collectives"] / st["decode_tokens"],
                       tokens=st["decode_tokens"],
                       calls={k: v - before.get(k, 0) for k, v in col.calls.items()
                              if v - before.get(k, 0)})
    return out


def main() -> int:
    from repro_torch.launch.spawn import run_ranks

    with tempfile.TemporaryDirectory() as tmp:
        out = run_ranks(_rank, 2, backend="gloo", init_file=f"{tmp}/store")[0]
    for kv, mode in ((2, "heads"), (1, "dv")):
        o = out[kv]
        print(f"reduced llama-3.2-vision-11b, {kv} kv head(s), 1x2 ({mode}): "
              f"{o['per_token']:.2f} collectives per decode token over {o['tokens']} tokens; "
              f"collectives over the run by kind {o['calls']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
