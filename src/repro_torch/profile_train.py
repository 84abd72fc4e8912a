"""Where the time of one training step goes, on the card.

Trains a model at its published widths (smollm-135m, or ``--arch``) on
chip_smoke.py's training shape (b=4, n=1024, bf16, remat "full"; random
weights from a seed, drawn on the card; one fixed bigram batch) for 3
warm-up steps, then records 3 steps with
``torch.profiler`` and prints the device time by kernel group (the three
Taylor kernels, matrix products, everything else), the device's busy and
idle share of the wall time, and one JSON line with those numbers.

  PYTHONPATH=src python -m repro_torch.profile_train [--arch qwen2-1.5b] [--n-groups 2]

``--n-groups`` cuts the depth (zamba2-7b's 5.9 B params with their AdamW
state do not fit one card; 2 of its 11 groups do).  The encdec and vlm
families get their source beside the tokens (``audio_frames`` /
``image_embeds`` from a seed: every entry N(0, 1), half of its variance
shared by the row's tokens, as chip_smoke.py draws them).

It needs a CUDA device, and exits 1 if the profiler recorded no device
time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.data import make_task
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train import make_train_step, train_state_init

BATCH, SEQ, WARMUP, STEPS = 4, 1024, 3, 3
GROUPS = (
    ("taylor_fwd", ("taylor_fwd_kernel",)),
    ("taylor_bwd_dq", ("taylor_bwd_dq_kernel",)),
    ("taylor_bwd_dkv", ("taylor_bwd_dkv_kernel",)),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "cublas")),
)


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return "other"


def main(argv=()) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--n-groups", type=int, default=None, help="default: the published depth")
    args = ap.parse_args(argv)
    device = resolve_device(None)
    cfg = get_config(args.arch)
    if args.n_groups is not None:
        cfg = cfg.replace(n_groups=args.n_groups)
    task = make_task("bigram", cfg.vocab, SEQ, BATCH, seed=0)
    batch = {k: torch.from_numpy(v).to(device) for k, v in task.batch_at(0).items()}
    if cfg.family != "lm":
        name, width = (("audio_frames", cfg.d_model) if cfg.family == "encdec"
                       else ("image_embeds", cfg.vision_dim))
        gen = torch.Generator(device=device).manual_seed(0)
        shared = torch.randn((BATCH, 1, width), generator=gen, device=device)
        own = torch.randn((BATCH, cfg.n_source_tokens, width), generator=gen, device=device)
        batch[name] = (shared + own) * 0.5**0.5
    opt = adamw(cosine_warmup(2e-3, 2, WARMUP + STEPS))
    state = train_state_init(torch.Generator(device=device).manual_seed(0), cfg, opt,
                             device=device)
    step = make_train_step(cfg, opt)
    for _ in range(WARMUP):
        state, m = step(state, batch)
    float(m["loss"])
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            state, m = step(state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    by_group = defaultdict(float)
    launches = defaultdict(int)
    other = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and getattr(ev, "device_type", None) == torch.autograd.DeviceType.CUDA:
            by_group[_group(ev.key)] += dev_us / 1e3
            launches[_group(ev.key)] += ev.count
            if _group(ev.key) == "other":
                other.append((dev_us / 1e3 / STEPS, ev.key[:90]))
    busy_ms = sum(by_group.values())
    per_step = {g: t / STEPS for g, t in sorted(by_group.items(), key=lambda x: -x[1])}
    print(f"{cfg.name} x{cfg.n_groups} groups b={BATCH} n={SEQ} {cfg.dtype} remat={cfg.remat}: "
          f"{STEPS} profiled steps, {wall_ms / STEPS:.1f} ms/step wall")
    if busy_ms == 0:
        print("device time: not measured (the profiler recorded no CUDA kernel)")
        return 1
    for g, t in per_step.items():
        print(f"  {g:16s} {t:9.2f} ms/step  {launches[g] // STEPS:6d} launches/step  "
              f"{100 * t * STEPS / wall_ms:5.1f}% of wall")
    for t, name in sorted(other, reverse=True)[:8]:
        print(f"    other: {t:8.2f} ms/step  {name}")
    busy = busy_ms / wall_ms
    print(f"  device busy {busy_ms / STEPS:.1f} ms/step = {100 * busy:.1f}% of wall; "
          f"idle {100 * (1 - busy):.1f}%")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"wall_ms_per_step": wall_ms / STEPS,
                      "device_ms_per_step": per_step, "busy_share": busy,
                      "launches_per_step": {g: launches[g] // STEPS for g in per_step},
                      "device": card}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
