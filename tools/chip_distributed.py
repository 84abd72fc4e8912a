#!/usr/bin/env python3
"""Runs chip_smoke.py's phases 16 (distributed training), 17 (serving on a
mesh), 18 (MoE on a mesh) and 19 (the cross-attention families and
Adafactor on a mesh) alone on the card.

Builds the Taylor kernels from this checkout, then runs
``chip_smoke.phase_distributed``: the unsharded references in this
process, then 2 ranks (``gloo`` sharing one card, or ``nccl`` one card a
rank) for tp 1×2, dp × fsdp 2×1, Taylor and SSD context parallelism, the
elastic restore, the sharded serve engine's four parts, and expert
parallelism (qwen2-moe-a2.7b training on 1×2 and 2×1, the int8 all-to-all
payload, kimi-k2-1t-a32b's forward and engine on 1×2), whisper-medium
training (AdamW on 1×2, Adafactor on 2×1) and serving (2×1) and
llama-3.2-vision-11b's forward and engine (1×2), with every check of the
full script.  Prints the card's name and power limit first
and each kernel's launches per rank last; exits non-zero on a failed
check or without a CUDA device.

    python3 tools/chip_distributed.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("chip_distributed: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    sys.path.insert(0, str(chip_smoke.SRC))
    from repro_torch.kernels.taylor_attention import kernel as K

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    K.build()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    out = chip_smoke.phase_distributed(torch, K)
    print(f"phases 16-19 took {time.perf_counter() - t0:.1f} s (phase 17's unsharded "
          f"engines {out['serve_refs_s']:.1f} s, phase 18's unsharded runs "
          f"{out['moe_refs_s']:.1f} s, phase 19's {out['cross_refs_s']:.1f} s of it)")
    print(chip_smoke.serve_mesh_summary(out["serve"]))
    print(chip_smoke.moe_mesh_summary(out["moe"]))
    print(chip_smoke.cross_mesh_summary(out["cross"]))
    for name in ("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv"):
        print(name, chip_smoke.dist_launches(out, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
