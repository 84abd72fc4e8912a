#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Builds the CUDA kernels from the sources in this checkout (one nvcc per
source, in parallel), holds each against its plain PyTorch version, drives
smollm-135m's full-width inference forward, its serving engine and its
training step (random weights from a seed), cross-checks them, runs the
same model on the paper's baselines (softmax, sliding-window softmax,
elu+1 linear, Taylor order 1), then the Based-style hybrid (taylor and
sliding-window layers interleaved) and the Taylor variants (sym_state,
decay, non-causal), then serving under load (phase 10: chunked prefill,
the SLO scheduler with a preemption, the standard fault trace, a replayed
Poisson trace and the health sweep's price), then speculative decoding and
the slot-state codecs (phase 11: n-gram and order-1 drafts, int8/fp8
moments, paged softmax KV, speculation over int8 moments), then the model
zoo at published widths (phase 12: qwen2-1.5b whole, the kernels at head
dim 128 and at zamba2's head dim 112, granite-20b, gemma-7b and
qwen2-moe-a2.7b at cut depth, the train_resume and serve_longcontext
scripts), then Mamba2 (phase 13: mamba2-780m whole, zamba2-7b whole for
the forward and serving, zamba2-7b's training at cut depth), then the
cross-attention families (phase 14: whisper-medium whole with its audio
frames, on Taylor and softmax attention; llama-3.2-vision-11b whole for the
forward and serving with its images, its training at cut depth; neither
reaches a kernel, as in the reference), then training breadth (phase 15:
the launcher with AdamW, Adafactor and SGD-momentum, bf16 AdamW moments,
the three remat modes, qwen2-1.5b whole with checkpoints and a resume,
zamba2-7b whole with bf16 params and Adafactor, a restore of a state in the
JAX trainer's layout), then distributed training (phase 16: 2 ranks that
share the one card over gloo, or one card a rank over nccl; qwen2-1.5b
whole trained tensor-parallel on 1×2 and dp × fsdp on 2×1 through the
kernels against an unsharded run, Taylor and SSD context parallelism on
1×2 against unsharded forwards, the elastic restore of a sharded state),
then serving on a mesh in the same ranks (phase 17: qwen2-1.5b at a cut
depth on tp 1×2 and dp 2×1, granite-20b's one kv head split by its d_v
columns, int8 moments with a NaN-poisoned slot, each against an unsharded
engine), then MoE on a mesh in the same ranks (phase 18: qwen2-moe-a2.7b
trained with expert parallelism on 1×2 and dp × fsdp on 2×1, the int8
all-to-all payload, kimi-k2-1t-a32b at published widths forwarding and
serving with half its experts a rank, each against the unsharded run of
the same function), then the cross families and Adafactor on a mesh in
the same ranks (phase 19), then the dry run against the card (phase 20:
phase 7's step traced on meta tensors on a 1×1 abstract mesh against one
real step, FLOPs equal and peak bytes within 2×, its roofline on the
H100, phase 16 (a)'s ranks' collectives against the abstract mesh's
prediction, one production cell of ``repro_torch.launch.dryrun``), and
prints one JSON line describing every ported kernel followed by the
device line.
Any failed phase exits non-zero.  Needs a CUDA device.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

MAIN = dict(b=4, hk=3, g=3, n=2048, d=64, dv=64)  # phase 3's main-path launch
TRAIN_ATTN = dict(MAIN, n=1024)  # each layer's attention launch in phase 7's step
FWD_CASES = ((MAIN, "float32"), (MAIN, "bfloat16"),  # phase 3's forward checks
             (TRAIN_ATTN, "bfloat16"), (TRAIN_ATTN, "float32"))
# Phase 3b's backward checks: the main path's shapes, then every other head
# dim the kernels instantiate (d = 16 and 32: several value blocks per tile;
# d = 128: one value column per tile, atomics straight into dq and dk), in
# both dtypes, all held to BWD_TOL.
BWD_CASES = ((MAIN, "float32"), (MAIN, "bfloat16"), (TRAIN_ATTN, "bfloat16"),
             *((dict(b=1, hk=2, g=3, n=256, d=d, dv=d), dname)
               for d in (16, 32, 128) for dname in ("float32", "bfloat16")))
EDGE = [  # (b, h, hk, n, d, dv, order): the JAX kernel tests' sweep + order 1
    (1, 2, 1, 256, 128, 128, 2),
    (2, 4, 2, 256, 64, 64, 2),
    (1, 3, 3, 384, 112, 112, 2),   # d=112 padded to 128
    (1, 2, 1, 300, 128, 128, 2),   # sequence padding
    (1, 8, 1, 128, 128, 128, 2),   # MQA, G=8
    (1, 2, 2, 256, 64, 256, 2),    # dv=256: 32 value tiles
    (1, 2, 2, 256, 64, 64, 1),     # order 1
    (1, 2, 1, 256, 16, 16, 2),     # d=16: 2 value blocks of 8
    (1, 4, 2, 256, 32, 32, 2),     # d=32: 4 value blocks of 8
]
GRAD_EDGE = [  # (order, b, h, hk, n, d, dv): tests/test_kernels.py's GRAD_SWEEP
    (1, 1, 2, 1, 256, 64, 64),
    (2, 2, 4, 2, 256, 64, 64),     # GQA g=2
    (2, 1, 8, 1, 128, 128, 128),   # MQA, G=8
    (2, 1, 2, 1, 300, 64, 64),     # sequence padding 300 -> 384
    (1, 1, 2, 1, 200, 48, 80),     # d 48 -> 64, sequence padding
    (2, 1, 2, 1, 256, 16, 16),     # d=16: 2 value blocks of 8
    (2, 1, 4, 2, 256, 32, 32),     # d=32: 4 value blocks of 8
]
TRAIN = dict(b=4, n=1024, steps=8, lr=2e-3, warmup=2)  # phase 7
BASELINE_STEPS = 4  # phase 8's training steps per backend, on phase 7's batch
FLASH_N = 4096  # phase 8's softmax forward on the flash path (n > 2048)
FLASH_TOL = 1e-4
PROMPT_LENS = (100, 256, 300, 384, 512, 700)
MAX_NEW = 32
N_MAX = 1024  # the serving engine's per-slot token capacity
F32_TOL = 1e-4
# The backward kernels write f32 gradients, held to their plain versions
# computed in float64 on the same inputs, so bf16 inputs answer to the same
# limit as f32 ones (an f32 oracle cannot serve: at granite-20b's launch,
# G = 48, the f32 plain version's own dk is 1.1e-5 off float64).  Sound
# kernels read <= 4.6e-6 at every case of BWD_CASES and ZOO_CASES; a copy of
# csrc/taylor_bwd.cu whose pass-2 dS2 carry update drops its a_lo·b_hi
# product reads 1.12e-5 to 2.17e-5 in dk there (tools/ab_taylor.py, PERF.md
# §6), which 1e-4 would let through.  Hence 1e-5, the next power of ten
# above the sound readings.
BWD_TOL = 1e-5
# The forward's bf16 output against the plain version's, also rounded to bf16:
# a sound kernel reads <= 6.8e-4 here (one-ulp rounding flips), a kernel that
# drops its z2 and S1 updates 8.1e-3.
FWD_BF16_TOL = 2e-3
NEAR_TIE = 1e-3
# Phase 9: the hybrid (taylor at pattern position 0, the sliding window at 1,
# 15 groups: smollm-135m's 30 layers) and the variants.
HYBRID = dict(pattern=("attn", "attn"), n_groups=15, attention_schedule={1: "softmax_window"})
HYBRID_STEPS = 4
DECAY = 0.95
DECAY_STEPS = 2
DECAY_TOL = 1e-5  # f32 forward vs the model's own prefill + decode, decayed
DECODE_CHECK = (896, 8)  # chunked prefill of 7 chunks, then decode steps
SYM_S2_SHARE = 0.55  # sym_state's per-slot S2 against the full state's
# Phase 10: serving under load (smollm-135m order 2, f32, 4 slots, N_MAX).
CHUNK_TOL = 2e-3  # chunked vs whole prefill, atol = rtol (tests/test_serve_sharded.py)
CHUNK_CASES = ((700, 256), (300, 128))  # (prompt, chunk): order 2, then the hybrid
SLO_SCHED = dict(priority_admission=True, decode_per_prefill=2, fat_chunk_depth=3,
                 preemption=True)
URGENT = ((64, 600), 16)  # priority-0 prompts submitted after the first step, new tokens
REPLAY = dict(seed=0, n=12, prompt_len=(100, 700), new_tokens=(8, 32),
              mean_interarrival_s=0.02, priorities=(0, 1))
LOAD_CHUNK = 256  # the engine's prefill_chunk in (b) and (d)
FAULT_MAX_QUEUE = 8  # (c): the standard trace's flood overflows this queue
# Phase 11: speculative decoding and the slot-state codecs (smollm-135m order
# 2, f32, 4 slots, N_MAX; phase 6's requests, phase 8's softmax tokens).
SPEC_K = 4
KV_PAGE = 64
QUANT_STEPS = 32  # teacher-forced decode steps of the quantised-state logit MAE
# The JAX package's reduced-size bounds (tests/test_state_quant.py): logit MAE
# of per-token quantised state, and the float32 top-2 margin above which no
# int8 greedy decision flips.  Printed beside the full-width readings; the
# margin is the limit of (d)'s divergences from int8 plain decode, which
# re-quantises after each decode block rather than after each verify.
QUANT_MAE_BOUND = {"int8": 0.25, "fp8": 1.25}
INT8_FLIP_MARGIN = 0.2
# Phase 12: the model zoo's dense and MoE decoders at their published widths
# (random weights, seed 0, drawn on the card's generator).  Depth is cut
# where the full model with its AdamW state would not fit on the card: a
# full-depth f32 copy of granite-20b alone is 81 GB.  granite-20b runs 2
# groups since phase 20 came (4 before): the script passed 1100 s of its
# 1200 s limit.
ZOO_DEPTH = {"granite-20b": 2, "gemma-7b": 2, "qwen2-moe-a2.7b": 2}  # n_groups
ZOO_TRAIN_STEPS = {"qwen2-1.5b": 6, "granite-20b": 2, "qwen2-moe-a2.7b": 2}
# The kernels at each model's training launch: (a), (c) and (e) at b = 4,
# n = 1024, head dim 128; (f)'s reduced qwen2-1.5b (b = 4, 4 heads on 2 kv
# heads, head dim 16) at train_resume's n = 32, which the wrapper pads to the
# d = 16 forward chunk of 128.
ZOO_ATTN = {"qwen2-1.5b": dict(b=4, hk=2, g=6, n=1024, d=128, dv=128),
            "granite-20b": dict(b=4, hk=1, g=48, n=1024, d=128, dv=128),
            "qwen2-moe-a2.7b": dict(b=4, hk=16, g=1, n=1024, d=128, dv=128),
            "qwen2-1.5b reduced": dict(b=4, hk=2, g=2, n=128, d=16, dv=16),
            # zamba2-7b's shared block: head dim 112, which the wrapper pads to
            # 128 (``padded_qk``); the bounds count d = 112
            "zamba2-7b": dict(b=4, hk=32, g=1, n=1024, d=112, dv=112)}
ZOO_CASES = tuple((m, dname) for m in ZOO_ATTN.values() for dname in ("bfloat16", "float32"))
GEMMA_LENS = (100, 128)  # gemma-7b's requests: 2 slots of ~2.1 GB of state each
MOE_TOKENS = 512  # the dense-vs-capacity comparison's tokens
MOE_TOL = 1e-4  # its atol: tests/test_models.py::test_moe_dispatch_paths_agree's
# Phase 13: Mamba2 (SSD) at published widths (random weights, seed 0, drawn on
# the card).  mamba2-780m and zamba2-7b run whole for the forward and serving;
# zamba2-7b trains at SSM_TRAIN_GROUPS of its 11 groups (with the 4-mamba
# tail): the whole model with its AdamW state (~31 B/param, phase 12's
# granite) would take 183 GB.
SSM_TRAIN_STEPS = {"mamba2-780m": 6, "zamba2-7b": 2}
SSM_TRAIN_GROUPS = 2
ZAMBA_LENS = PROMPT_LENS[:4]  # zamba2's requests: 4 slots of ~2.1 GB of state each
SSM_CHUNK = (PROMPT_LENS[:3], 128)  # mamba2's chunked-prefill serving: prompts, chunk
SSD_RECURRENCE = 256  # tokens of layer 0's chunked SSD vs its token recurrence
SSD_TOL = 1e-4  # that comparison's rel tolerance, float32
SHARED_GRAD_TOL = 1e-3  # zamba2's shared-block gradient, kernels vs torch (phase 7's)
# Phase 14: the cross-attention families at published widths (random weights,
# seed 0, drawn on the card; sources drawn from N(0, 1) with a seed: the
# conv front end and the vision tower are stubs in the reference too).
# whisper-medium runs whole everywhere; llama-3.2-vision-11b (40.5 GB of f32
# params) runs whole for the forward and serving and trains at
# VLM_TRAIN_GROUPS of its 8 groups (4 attn + 1 cross each; ~31 B/param with
# AdamW, phase 12's granite, puts one group near 63 GiB at b = 4).
CROSS_ARCHS = ("whisper-medium", "llama-3.2-vision-11b")
CROSS_PARAMS = {"whisper-medium": 758_248_448, "llama-3.2-vision-11b": 10_115_977_216}
CROSS_FWD_B = {"whisper-medium": 4, "llama-3.2-vision-11b": 2}  # forward rows, n = 1024
# f32 bytes per slot at N_MAX (the reference's lm_state_bytes)
CROSS_SLOT_BYTES = {"whisper-medium": 837_012_480, "llama-3.2-vision-11b": 3_298_166_272}
WHISPER_TRAIN_STEPS = 6
WHISPER_LENS = PROMPT_LENS[:4]  # whisper's requests, each with its own audio frames
WHISPER_SOFTMAX_LENS = PROMPT_LENS[:2]  # (b): the softmax baseline's requests
TEACHER = dict(b=2, n=256, steps=8)  # (a)'s teacher-forced prefill + decode vs lm_apply
TEACHER_TOL = 2e-3  # its atol = rtol (tests/test_models.py)
VLM_LENS = PROMPT_LENS[:2]  # the VLM's requests: 2 slots of 3.3 GB of state each
VLM_IMAGE_STEPS = 8  # tokens of one prompt under two images
VLM_TRAIN_GROUPS = 1
VLM_TRAIN = dict(steps=2, b=4)
# Phase 15: training breadth.  (a) smollm-135m through the launcher with each
# optimizer (lr and warmup of phase 7, a fresh bigram batch each step), and
# AdamW with bf16 moments and Adafactor without momentum through the library;
# (b) one step under each remat mode; (c) qwen2-1.5b whole through the
# launcher with Adafactor and checkpoints: an uninterrupted run, a control run
# and a run stopped after its first step (--max-wall-seconds) and re-invoked;
# (d) zamba2-7b whole with bf16 params and Adafactor without momentum;
# (e) smollm's AdamW state written in the JAX trainer's layout with numpy,
# restored through the loader.
BREADTH_STEPS = 4  # (a)'s runs
BREADTH_ARGS = ["--batch", str(TRAIN["b"]), "--seq", str(TRAIN["n"]), "--lr", str(TRAIN["lr"]),
                "--warmup", str(TRAIN["warmup"]), "--log-every", "1"]
# SGD's lr: at (a)'s 2e-3, with the gradient's norm clipped to 1, a step
# moves the loss by ~1e-3; 5e-2 is SGD's usual scale
SGD_LR = 5e-2
REMATS = ("none", "full", "dots_saveable")
REMAT_TIMED = 5  # (b)'s timed forward + backward passes per mode
ZAMBA_WHOLE_STEPS = 3
# (d)'s lr: the JAX package's training preset for bf16 params under Adafactor
# without momentum (launch/dryrun.py::training_preset).  Without momentum its
# updates are ~lr per element, and at 2e-3 on weights of std ~0.017 the third
# step's loss jumped above the first's on the H100
ZAMBA_WHOLE_LR = 3e-4
QWEN_STEPS = 3  # (c)'s runs; the stopped one takes 1, the resumed one the rest
# (c)'s gate: the backward kernels add with f32 atomics, so two runs on the
# card differ, and Adafactor turns a sign flip of a tiny gradient into an
# update near ±lr; so the resumed run's divergence from the uninterrupted
# one (relative RMS over all params) is held to RESUME_RATIO times that of a
# second uninterrupted run, plus RESUME_FLOOR; a resume that lost its step,
# schedule, data position or moments moves every param by ~lr (~1e-1 of
# their RMS).
RESUME_RATIO = 4.0
RESUME_FLOOR = 1e-5


# Phase 16: distributed training on a mesh of 2 ranks (ranks share the one
# card over gloo, or one card a rank over nccl): qwen2-1.5b at published
# widths in float32 through the kernels under tp (1×2) and dp × fsdp (2×1),
# cut to ``ab_groups`` of its 28 layers, against an unsharded run of the
# same seed, depth and batch, Taylor context parallelism (1×2, the forward
# and training at that depth) and SSD's, and the elastic restore of a
# sharded state (qwen2-1.5b at a cut depth).
DIST = dict(
    world=2,
    device="cuda",
    arch="qwen2-1.5b",          # (a), (b), (c) at published widths
    ab_groups=2,                # (a), (b) and (c): 2 of the 28 layers
    ssm_arch="mamba2-780m",     # (d)
    b=TRAIN["b"], n=TRAIN["n"], steps=2,
    cp_fwd=(1, 16384),          # (c)'s forward: (b, n)
    ssd_fwd=(1, 8192),          # (d)'s forward: (b, n)
    e_groups=4,                 # (e)'s state: qwen2-1.5b at 4 of its 28 layers, full width
    stride=16,                  # the forward checks compare every 16th position's logits
    reduced=False,
)
DIST_LOSS_TOL = 2e-3  # sharded vs unsharded losses (tests/test_distributed.py:127)
CP_LOSS_TOL = 5e-3  # cp vs tp losses (tests/test_distributed.py:204)
DIST_FWD_TOL = 1e-3  # f32 logits, rel (max|Δ|/max|ref|): phase 4's float32 tolerance
# Phase 17: serving on a mesh, in phase 16's spawn of ranks: qwen2-1.5b at
# published widths cut to ``groups`` of its 28 layers in float32 on tp 1×2
# (a) and dp 2×1 (b), granite-20b at published width cut to 2 of its 52
# layers, as phase 12 cuts it, on tp 1×2 (c; its one kv head cannot split:
# each rank holds the d_v columns of the value moments), and (a) with int8
# moments and a NaN poured into one slot (d); each against an unsharded
# engine of the same weights run in the parent first.
SERVE_MESH = dict(
    arch="qwen2-1.5b", groups=4, mqa_arch="granite-20b", mqa_groups=2,
    slots=4, n_max=N_MAX, decode_block=8, new=16,
    lens=(64, 128, 96, 112, 80, 400),  # the last `late` are submitted after the first step
    late=2, chunk=128,                 # prefill_chunk: only the 400-token prompt is chunked
    corrupt=(1, 1),                    # (d): NaN into slot 1 (request 1) after block 1
)
SERVE_MESH_LOGIT_TOL = 1e-4  # teacher-forced logits, sharded vs unsharded, rel
SERVE_MESH_TIE = 1e-5  # a differing token passes where the top-2 gap < this × RMS(logits)
SERVE_MESH_BYTES_TOL = 0.01  # (a): a rank's slot-cache bytes against half the unsharded
# params after the steps: per leaf, RMS(sharded - unsharded) / RMS(the
# unsharded update).  AdamW moves an element by ~lr whatever its gradient's
# size, so rounding noise flips the few elements whose gradient is near
# eps (max|Δ| up to ~lr); a wrongly reduced gradient changes the update's
# direction, ~1 on this scale.
DIST_PARAM_TOL = 0.1
# Phase 18: MoE on a mesh (ROADMAP queue 1 item 6b), in phase 16's spawn of
# ranks; each part against the unsharded run whose MoE layers compute the
# mesh's function on one device (``models/moe.py::_moe_ep_a2a_plain`` at the
# mesh's dp × ep), run in the parent first.  (a) qwen2-moe-a2.7b at published
# widths (60 experts top-4, capacity 1.25, ``impl="auto"``: ``ep_a2a`` on a
# mesh), cut to 1 of its 24 layers, f32, phase 16's AdamW and
# batch, 2 steps on tp/ep 1×2 (30 experts and 8 heads a rank); (b) the same
# on dp × fsdp 2×1 (an ep axis of one rank: the global capacity path, the
# experts split over "data" and gathered per layer); (c) (a)'s layer-0 MoE
# on its real input with the int8 all-to-all payload on 1×2; (d)
# kimi-k2-1t-a32b at published widths, 1 of its 61 layers, bf16 params, 192
# of its 384 experts a rank on 1×2: the forward at b = 1, n = 1024 and
# serving 4 requests, both with float32 activations, held as phases 16 and
# 17 hold them (in bf16 the sharded sums round otherwise and move routing
# decisions, whose shifts decide which tokens overflow an expert: the bf16
# forward's difference is reported, not gated).
MOE_MESH = dict(
    arch="qwen2-moe-a2.7b", groups=1,
    kimi="kimi-k2-1t-a32b", kimi_groups=1, kimi_fwd=(1, 1024),
    serve=dict(slots=4, n_max=512, decode_block=8, new=8, lens=(64, 128, 192, 256), late=0,
               chunk=None),
)
MOE_INT8_TOL = 0.05  # (c): int8 payload vs exact, rel (tests/test_perf_features.py:94)
MOE_GRAD_TOL = 1e-2  # (c): the mesh's gradients vs the plain version's (int8 both), rel
# Phase 19: the cross-attention families and Adafactor on a mesh (ROADMAP
# queue 1 item 6c), in phase 16's spawn of ranks, each part against an
# unsharded run of the same seed run in the parent first.  (a)
# whisper-medium at published widths (d_model 1024, 16/16 heads, frames
# [b, 1500, 1024]) cut to ``groups`` of its 24 encoder and 24 decoder
# groups, f32, phase 16's AdamW and batch, 2 steps on tp 1×2; (b) the same
# with Adafactor on dp × fsdp 2×1 (params and the factored row/col
# statistics); (c) llama-3.2-vision-11b at ``vlm_groups`` of its 8 groups
# (4 self layers and 1 cross layer), bf16 params, float32 activations, on
# tp 1×2: the forward at ``vlm_fwd`` with images [b, 1600, 1280], then 2
# requests served with their images; (d) (a)'s whisper served on dp 2×1, 4
# requests each with its own frames (each slot's owner holds its
# ``kv_src`` row).  No cross model reaches a kernel (the envelope, as the
# reference's): every part launches 0.
CROSS_MESH = dict(
    whisper="whisper-medium", groups=4,
    vlm="llama-3.2-vision-11b", vlm_groups=1, vlm_fwd=(1, 1024),
    vlm_serve=dict(slots=2, n_max=512, decode_block=8, new=8, lens=(96, 160), late=0,
                   chunk=None),
    whisper_serve=dict(slots=4, n_max=512, decode_block=8, new=16, lens=(64, 128, 96, 80),
                       late=1, chunk=None),  # 16 > 1 + 8: mid-flight after the first step
)
# (b): each row/col statistic's RMS(sharded - unsharded) / RMS(unsharded).
# The statistics are means of g²: the sharded gradients sum in another
# order (~1e-6), while a mean taken over one rank's block of a split axis
# is off by O(1)
CROSS_STAT_TOL = 1e-3


def ptxas_summary(log: str, head_dim: int = 64):
    """ptxas's resource lines for the kernels instantiated at ``head_dim``."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(taylor_(?:fwd|bwd_dq|bwd_dkv)_kernel)"
                      r"I(\S+?)EEEv", line)
        if m:
            name = f"{m.group(1)}<{m.group(2)}>" if f"Li{head_dim}E" in m.group(2) else None
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def ptxas_spills(log: str):
    """(kernel instantiations compiled, ptxas's lines for those that spill)."""
    count, spills, name = 0, [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\S*?\d(taylor_\w+?_kernel)I(\S+?)EEEv", line)
        if m:
            name, count = f"{m.group(1)}<{m.group(2)}>", count + 1
        elif name and re.search(r"[1-9]\d* bytes spill", line):
            spills.append(f"{name}: {line.strip()}")
    return count, spills


def case_name(m, dname: str) -> str:
    """A check's name: its dtype, then n, d, hk and g where they differ from
    MAIN's."""
    return dname + "".join(f" {k_}={m[k_]}" for k_ in ("n", "d", "hk", "g") if m[k_] != MAIN[k_])


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (CUDA events, warm)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rel_err(torch, out, ref) -> float:
    return float((out.float() - ref.float()).abs().max() / ref.float().abs().max())


def fwd_inputs(torch, m, dtype, gen, ln):
    """Phase 3's forward inputs at shape ``m``: normalised q, k and plain v."""
    bk = m["b"] * m["hk"]
    q = ln(torch.randn(bk, m["g"], m["n"], m["d"], device="cuda", generator=gen)).to(dtype)
    k = ln(torch.randn(bk, m["n"], m["d"], device="cuda", generator=gen)).to(dtype)
    v = torch.randn(bk, m["n"], m["dv"], device="cuda", generator=gen).to(dtype)
    return q, k, v


def fwd_errors(torch, out, ref32):
    """Checks a forward output against the plain version's float32 output on
    the same inputs, ``ref32``.  Returns (errors, failures): ``rel`` against
    ``ref32`` rounded to out's dtype (tolerance F32_TOL, or FWD_BF16_TOL for
    bf16) and, for bf16, ``excess``: the error beyond half a bf16 ulp, the
    rounding of the output itself, relative to max |ref32| (held to F32_TOL,
    so the bf16 instantiation answers to the f32 tolerance)."""
    bf16 = out.dtype == torch.bfloat16
    errs = {"rel": rel_err(torch, out, ref32.to(out.dtype))}
    tols = {"rel": FWD_BF16_TOL if bf16 else F32_TOL}
    if bf16:
        o = out.float()
        _, e = torch.frexp(torch.maximum(o.abs(), ref32.abs()))
        half_ulp = torch.ldexp(torch.ones_like(o), e - 9)  # bf16: 8 significant bits
        errs["excess"] = float(((o - ref32).abs() - half_ulp).clamp(min=0).max()
                               / ref32.abs().max())
        tols["excess"] = F32_TOL
    return errs, {k_: (e_, tols[k_]) for k_, e_ in errs.items() if not e_ < tols[k_]}


def padded_qk(torch, K, q, k, alpha=3.0):
    """(q, k, alpha) in the kernels' layout: q and k zero-padded to the
    smallest head dim of ``K.TILES`` at least d, and alpha rescaled so that
    the logits keep the true d (``ops._kernel_layout``/``_effective_alpha``,
    what the wrapper does for zamba2's d = 112).  Unchanged when d is one."""
    d = q.shape[-1]
    d_pad = min(t for t in K.TILES if t >= d)
    if d_pad == d:
        return q, k, alpha
    pad = lambda x: torch.nn.functional.pad(x, (0, d_pad - d))
    return pad(q), pad(k), alpha * math.sqrt(d / d_pad)


def fwd_case(torch, K, ref_mod, ln, gen, m, dname, tag="[3]"):
    """The forward kernel against its plain version at shape ``m`` in
    ``dname``: checked (fails on a disagreement, or where a second launch on
    the same inputs gives other bits), timed and bounded; prints how many of
    its launches took the tensor-core row pass.  A head dim outside
    ``K.TILES`` runs padded (``padded_qk``) against the plain version at the
    true d, and its bound counts the true d.  Returns its row."""
    dtype = getattr(torch, dname)
    bk = m["b"] * m["hk"]
    q, k, v = fwd_inputs(torch, m, dtype, gen, ln)
    qp, kp, alpha = padded_qk(torch, K, q, k)
    counted = (K.taylor_fwd.launches, K.taylor_fwd.tensor_row_launches)
    out = K.taylor_fwd(qp, kp, v, alpha=alpha)
    again = K.taylor_fwd(qp, kp, v, alpha=alpha)
    ref32 = ref_mod.taylor_attention_ref(q.float()[None], k.float()[None],
                                         v.float()[None], alpha=3.0)[0]
    torch.cuda.synchronize()
    errs, bad = fwd_errors(torch, out, ref32)
    repeats = torch.equal(out.view(torch.uint8), again.view(torch.uint8))
    abs_err = float((out.float() - ref32.to(dtype).float()).abs().max())
    kernel_ms = cuda_ms(torch, lambda: K.taylor_fwd(qp, kp, v, alpha=alpha), 10)
    plain_ms = cuda_ms(
        torch, lambda: ref_mod.taylor_attention_ref(q[None], k[None], v[None]), 3
    )
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels.taylor_attention.cost import FWD_TF32_PRODUCTS, taylor_fwd_cost

    flops, tensor, nbytes = taylor_fwd_cost(
        bk, m["g"], m["n"], m["d"], m["dv"], K.TILES[qp.shape[-1]][1], q.element_size())
    products = FWD_TF32_PRODUCTS[dname]
    f32_ms, _ = bound_ms(flops, nbytes)
    tensor_ms, by = bound_ms(flops, nbytes, tensor, products)
    name = case_name(m, dname)
    launches = K.taylor_fwd.launches - counted[0]
    tensor_rows = K.taylor_fwd.tensor_row_launches - counted[1]
    print(f"{tag} taylor_fwd {name} {m}: "
          + " ".join(f"{k_}_err={e_:.3e}" for k_, e_ in errs.items())
          + (f" (tol {FWD_BF16_TOL}, excess {F32_TOL})" if "excess" in errs
             else f" (tol {F32_TOL})")
          + f" repeats_bitwise={repeats} tensor_row_launches/launches={tensor_rows}/{launches}"
          + f" max_abs_err={abs_err:.3e} kernel_ms={kernel_ms:.4f} "
          f"plain_ms={plain_ms:.4f} bound_ms={tensor_ms:.4f} ({by}; tensor cores, "
          f"TF32 products {products}; bound/kernel {tensor_ms / kernel_ms:.1%}) "
          f"bound_ms(f32 cores)={f32_ms:.4f} (bound/kernel {f32_ms / kernel_ms:.1%}) "
          f"gflop={flops / 1e9:.2f} "
          f"(tensor-core share {sum(tensor.values()) / flops:.3f}) "
          f"achieved_tflops={flops / kernel_ms / 1e9:.2f}")
    if bad:
        fail(f"taylor_fwd {name} disagrees with its plain version: {bad}")
    if not repeats:
        fail(f"taylor_fwd {name}: two launches on the same inputs differ")
    return dict(
        max_abs_err=abs_err, rel_err=errs["rel"], ms=kernel_ms, plain_ms=plain_ms,
        bound_ms=tensor_ms, bound_by=by, bound_f32_cores_ms=f32_ms,
        tensor_row_launches=tensor_rows, launches=launches,
    )


def phase_kernel(torch, K, ops, ref_mod, ln):
    """Phase 3: the kernel against its plain version on the card, at phase 3's
    shape and at the training step's own launch, in f32 and bf16."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = {case_name(m, dname): fwd_case(torch, K, ref_mod, ln, gen, m, dname)
            for m, dname in FWD_CASES}
    for b, h, hk, n, d, dv, order in EDGE:
        q = torch.randn(b, h, n, d, device="cuda", generator=gen)
        k = torch.randn(b, hk, n, d, device="cuda", generator=gen)
        v = torch.randn(b, hk, n, dv, device="cuda", generator=gen)
        with torch.no_grad():
            out = ops.taylor_attention_kernel_trainable(q, k, v, ops.TaylorConfig(order=order))
        ref = ref_mod.taylor_attention_ref(
            ln(q).reshape(b, hk, h // hk, n, d), ln(k), v, order=order
        ).reshape(b, h, n, dv)
        torch.cuda.synchronize()
        err = rel_err(torch, out, ref)
        print(f"[3] edge (b,h,hk,n,d,dv,order)={(b, h, hk, n, d, dv, order)} "
              f"f32 rel_err={err:.3e}")
        if not err < F32_TOL:
            fail(f"edge case {(b, h, hk, n, d, dv, order)} rel err {err}")
    return rows


def bwd_inputs(torch, m, dtype, gen, ln):
    """Phase 3b's backward inputs at shape ``m``: the forward's and dout."""
    q, k, v = fwd_inputs(torch, m, dtype, gen, ln)
    dout = torch.randn(m["b"] * m["hk"], m["g"], m["n"], m["dv"], device="cuda",
                       generator=gen).to(dtype)
    return q, k, v, dout


def bwd_check(torch, ref_mod, q, k, v, dout, out, dq_fn, dkv_fn):
    """Runs pass 1 (``dq_fn``) and pass 2 (``dkv_fn``, on pass 1's den and
    dden) and their plain versions, computed in float64, on the same inputs.
    Returns (rel errors, max abs errors by kernel, failures, (den, dden)).
    Every rel error answers to BWD_TOL, for bf16 inputs too: the gradients
    are f32 either way."""
    dq, den, dden = dq_fn(q, k, v, dout, out)
    dk, dv = dkv_fn(q, k, v, dout, den, dden)
    b = lambda *x: [t.double()[None] for t in x]
    want = [t[0] for t in ref_mod.taylor_bwd_dq_ref(*b(q, k, v, dout, out))]
    # pass 2 against its plain version on the SAME inputs (pass 1's rows)
    want += [t[0] for t in ref_mod.taylor_bwd_dkv_ref(*b(q, k, v, dout, den, dden))]
    torch.cuda.synchronize()
    names = ("dq", "den", "dden", "dk", "dv")
    errs = {n_: float((a_.double() - w_).abs().max() / w_.abs().max())
            for n_, a_, w_ in zip(names, (dq, den, dden, dk, dv), want)}
    abs_err = {"taylor_bwd_dq": float((dq - want[0]).abs().max()),
               "taylor_bwd_dkv": max(float((dk - want[3]).abs().max()),
                                     float((dv - want[4]).abs().max()))}
    bad = {k_: (e_, BWD_TOL) for k_, e_ in errs.items() if not e_ < BWD_TOL}
    return errs, abs_err, bad, (den, dden)


def bwd_case(torch, K, ref_mod, ln, gen, m, dname, tag="[3b]"):
    """Both backward kernels against their plain versions at shape ``m`` in
    ``dname``: checked to BWD_TOL (fails on a disagreement, or where the
    checked launches' tensor-row counts are not all of them at a head dim of
    ``K.TENSOR_ROWS`` and none elsewhere), timed and bounded.  A head dim
    outside ``K.TILES`` runs padded (``padded_qk``), dq and dk sliced back to
    the true d, against the plain versions at the true d.  Returns {kernel:
    row} for dq, dkv and the pair."""
    bk = m["b"] * m["hk"]
    q, k, v, dout = bwd_inputs(torch, m, getattr(torch, dname), gen, ln)
    qp, kp, alpha = padded_qk(torch, K, q, k)
    d = m["d"]

    def dq_fn(q, k, v, dout, out):
        dq, den, dden = K.taylor_bwd_dq(*padded_qk(torch, K, q, k)[:2], v, dout, out,
                                        alpha=alpha)
        return dq[..., :d], den, dden

    def dkv_fn(q, k, v, dout, den, dden):
        dk, dv = K.taylor_bwd_dkv(*padded_qk(torch, K, q, k)[:2], v, dout, den, dden,
                                  alpha=alpha)
        return dk[..., :d], dv

    out = K.taylor_fwd(qp, kp, v, alpha=alpha)
    tb = K.taylor_bwd
    counters = lambda: (tb.dq_launches, tb.dq_tensor_row_launches, tb.dkv_launches,
                        tb.dkv_tensor_row_launches)
    counted = counters()
    errs, abs_err, bad, (den, dden) = bwd_check(torch, ref_mod, q, k, v, dout, out, dq_fn,
                                                dkv_fn)
    dq_n, dq_rows, dkv_n, dkv_rows = (a_ - b_ for a_, b_ in zip(counters(), counted))
    tensor_rows = qp.shape[-1] in K.TENSOR_ROWS
    b = lambda *x: [t[None] for t in x]
    ms = {  # the kernels alone, on inputs already in their layout
        "taylor_bwd_dq": cuda_ms(torch, lambda: K.taylor_bwd_dq(qp, kp, v, dout, out,
                                                                alpha=alpha), 10),
        "taylor_bwd_dkv": cuda_ms(torch, lambda: K.taylor_bwd_dkv(qp, kp, v, dout, den, dden,
                                                                  alpha=alpha), 10),
        "pair": cuda_ms(torch, lambda: K.taylor_bwd(qp, kp, v, dout, out, alpha=alpha), 10),
    }
    plain = {
        "taylor_bwd_dq": cuda_ms(torch, lambda: ref_mod.taylor_bwd_dq_ref(
            *b(q, k, v, dout, out)), 3),
        "taylor_bwd_dkv": cuda_ms(torch, lambda: ref_mod.taylor_bwd_dkv_ref(
            *b(q, k, v, dout, den, dden)), 3),
        "pair": cuda_ms(torch, lambda: ref_mod.taylor_attention_bwd_ref(
            *b(q, k, v, dout, out)), 3),
    }
    from repro_torch.analysis.roofline import bound_ms
    from repro_torch.kernels.taylor_attention.cost import BWD_TF32_PRODUCTS, taylor_bwd_cost

    cost = taylor_bwd_cost(bk, m["g"], m["n"], m["d"], m["dv"], K.BWD_CHUNK,
                           q.element_size())
    products = BWD_TF32_PRODUCTS[dname]
    name = case_name(m, dname)
    print(f"{tag} taylor_bwd {name} {m}: rel_err against float64 " +
          " ".join(f"{k_}={e:.3e}" for k_, e in errs.items()) + f" (tol {BWD_TOL})"
          f" tensor_row_launches/launches dq={dq_rows}/{dq_n} dkv={dkv_rows}/{dkv_n}")
    row = {}
    for kname in ("taylor_bwd_dq", "taylor_bwd_dkv", "pair"):
        flops, tensor, nbytes = cost[kname]
        f32_ms, _ = bound_ms(flops, nbytes)
        bms, by = bound_ms(flops, nbytes, tensor, products)
        print(f"{tag}   {kname} {name}: kernel_ms={ms[kname]:.4f} "
              f"plain_ms={plain[kname]:.4f} bound_ms={bms:.4f} ({by}; tensor cores; "
              f"bound/kernel {bms / ms[kname]:.1%}) bound_ms(f32 cores)={f32_ms:.4f} "
              f"(bound/kernel {f32_ms / ms[kname]:.1%}) gflop={flops / 1e9:.2f} "
              f"(tensor-core share {sum(tensor.values()) / flops:.3f}) "
              f"mb={nbytes / 1e6:.1f} achieved_tflops={flops / ms[kname] / 1e9:.2f}")
        row[kname] = dict(ms=ms[kname], plain_ms=plain[kname], bound_ms=bms,
                          bound_by=by, bound_f32_cores_ms=f32_ms,
                          max_abs_err=abs_err.get(kname))
    if bad:
        fail(f"taylor_bwd {name} disagrees with its plain version: {bad}")
    if (dq_rows, dkv_rows) != ((dq_n, dkv_n) if tensor_rows else (0, 0)):
        fail(f"taylor_bwd {name}: tensor-row launches dq {dq_rows}/{dq_n}, "
             f"dkv {dkv_rows}/{dkv_n}")
    return row


def phase_backward(torch, K, ops, ref_mod, ln):
    """Phase 3b: the backward kernels against their plain versions on the
    card (``BWD_CASES``: phase 3's shape in f32 and bf16, the training
    step's in bf16, n = 256 at d = 16, 32 and 128 in both), then the
    trainable wrapper against autograd of the plain forward, and the padded
    rows and columns of the raw gradients, which must be 0."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {case_name(m, dname): bwd_case(torch, K, ref_mod, ln, gen, m, dname)
            for m, dname in BWD_CASES}
    for order, b, h, hk, n, d, dv in GRAD_EDGE:
        q = torch.randn(b, h, n, d, device="cuda", generator=gen, requires_grad=True)
        k = torch.randn(b, hk, n, d, device="cuda", generator=gen, requires_grad=True)
        v = torch.randn(b, hk, n, dv, device="cuda", generator=gen, requires_grad=True)
        t = torch.randn(b, h, n, dv, device="cuda", generator=gen)
        cfg = ops.TaylorConfig(order=order)
        before = K.taylor_bwd.dq_launches
        o = ops.taylor_attention_kernel_trainable(q, k, v, cfg, backward="cuda")
        got = torch.autograd.grad((o * t).sum(), (q, k, v))
        ref = ref_mod.taylor_attention_ref(
            ln(q).reshape(b, hk, h // hk, n, d), ln(k), v, order=order
        ).reshape(b, h, n, dv)
        want = torch.autograd.grad((ref * t).sum(), (q, k, v))
        torch.cuda.synchronize()
        errs = [rel_err(torch, a, w) for a, w in zip(got, want)]
        print(f"[3b] trainable wrapper (order,b,h,hk,n,d,dv)={(order, b, h, hk, n, d, dv)} "
              f"f32 grad rel_err dq,dk,dv = {', '.join(f'{e:.3e}' for e in errs)}")
        if K.taylor_bwd.dq_launches != before + 1:
            fail("the trainable wrapper did not launch the backward kernels")
        if not max(errs) < F32_TOL:
            fail(f"trainable wrapper gradients disagree at {(order, b, h, hk, n, d, dv)}")
        qp, kp, vp, dims = ops._kernel_layout(ln(q.detach()), ln(k.detach()), v.detach())
        if (dims.n_pad, dims.d_pad, dims.dv_pad) == (n, d, dv):
            continue
        alpha = ops._effective_alpha(3.0, dims)
        doutp = ops._grouped_value_layout(t, dims)
        outp = K.taylor_fwd(qp, kp, vp, alpha=alpha, order=order)
        gq, gk, gv = K.taylor_bwd(qp, kp, vp, doutp, outp, alpha=alpha, order=order)
        pads = [gq[..., n:, :], gq[..., d:], gk[:, n:], gk[..., d:], gv[:, n:], gv[..., dv:]]
        nonzero = sum(int(torch.count_nonzero(x)) for x in pads)
        print(f"[3b] padded layout (n,d,dv) {(n, d, dv)} -> "
              f"{(dims.n_pad, dims.d_pad, dims.dv_pad)}: {sum(x.numel() for x in pads)} "
              f"padded gradient entries, {nonzero} nonzero")
        if nonzero:
            fail(f"padded gradient rows/columns are not exactly zero at {(n, d, dv)}")
    return rows


def taylor_counters(K):
    """The three kernels' launch counts: (fwd, dq, dkv)."""
    return K.taylor_fwd.launches, K.taylor_bwd.dq_launches, K.taylor_bwd.dkv_launches


def kernel_layers(torch, cfg):
    """The layers whose attention runs the Taylor kernels on the card: the
    taylor layers (per ``attention_schedule``) when their config is inside
    the kernels' envelope (no decay, no sym_state) and the impl allows."""
    from repro_torch.backends import get_backend
    from repro_torch.models.config import schedule_runs

    lcfg = cfg.layer_cfg("taylor")
    if get_backend("taylor").resolve_impl(lcfg, torch.device("cuda")) != "cuda":
        return 0
    per_group = sum(rl for kind, bk, rl in schedule_runs(cfg)
                    if bk == "taylor" and kind != "mamba")
    tail = sum(kind != "mamba" for kind in cfg.tail) if cfg.attention == "taylor" else 0
    return per_group * cfg.n_groups + tail


def kernel_launches_per_step(torch, cfg):
    """(fwd, dq, dkv) launches of one training step: one forward per kernel
    layer, two under remat "full" and "dots_saveable" (the backward reruns
    the block, and a kernel launch is no product to save); one dq and one
    dkv."""
    n = kernel_layers(torch, cfg)
    return (1 if cfg.remat == "none" else 2) * n, n, n


def train_steps(torch, K, cfg, init_state, step, batch, steps, tag):
    """Runs ``steps`` training steps from ``init_state()`` with the kernels'
    counts set to 0 just before, printing each step; fails unless every step
    launches ``kernel_launches_per_step`` and has a finite loss and aux loss.  Only
    this frame holds the state, so each step's input state is freed as the
    next is made.  Returns (state, losses, host seconds per step, launches
    over the run, peak bytes)."""
    expect = kernel_launches_per_step(torch, cfg)
    state = init_state()
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for i in range(steps):
        c0 = taylor_counters(K)
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        got = tuple(a - b for a, b in zip(taylor_counters(K), c0))
        losses.append(loss)
        aux = float(metrics["aux_loss"])
        print(f"{tag} step {i + 1}: loss={loss:.4f} aux={aux:.4f} {times[-1] * 1e3:.1f} ms "
              f"launches fwd,dq,dkv={got}")
        if got != expect:
            fail(f"{tag} training step launched (fwd, dq, dkv) = {got}, expected {expect}")
        if not (math.isfinite(loss) and math.isfinite(aux)):
            fail(f"{tag} loss or aux loss is not finite at step {i + 1}")
    launches = dict(zip(("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv"), taylor_counters(K)))
    return state, losses, times, launches, torch.cuda.max_memory_allocated()


def bigram_batch(torch, make_task, cfg):
    """Phase 7's fixed training batch: ``make_task("bigram", vocab, n, b)``'s
    step 0, on the card."""
    task = make_task("bigram", cfg.vocab, TRAIN["n"], TRAIN["b"], seed=0)
    return {k_: torch.from_numpy(x).cuda() for k_, x in task.batch_at(0).items()}


def phase_train(torch, K, cfg, make_task, adamw, cosine_warmup, train_state_init,
                make_train_step, make_loss_fn, loss_and_grads, tree_leaves):
    """Phase 7: full-width training steps on one fixed batch, through the
    kernels; then the kernel gradients against the torch recompute's."""
    # phases 5-6's serving engines sit in reference cycles (an engine and its
    # speculator): free them and their slot caches before the peak is read,
    # whenever the collector would have run
    gc.collect()
    torch.cuda.empty_cache()
    tr = TRAIN
    batch = bigram_batch(torch, make_task, cfg)
    opt = adamw(cosine_warmup(tr["lr"], tr["warmup"], tr["steps"]))
    step = make_train_step(cfg, opt)
    counters = lambda: taylor_counters(K)
    state, losses, times, launches, peak = train_steps(
        torch, K, cfg, lambda: train_state_init(torch.Generator().manual_seed(0), cfg, opt),
        step, batch, tr["steps"], "[7]")
    steady = sum(times[1:]) / (len(times) - 1)
    tokens = tr["b"] * tr["n"]
    print(f"[7] smollm-135m training {cfg.dtype} remat={cfg.remat} b={tr['b']} n={tr['n']}: "
          f"{tr['steps']} steps on one batch, loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"first step {times[0] * 1e3:.1f} ms, then {steady * 1e3:.1f} ms/step = "
          f"{tokens / steady:.0f} tokens/s; peak memory {peak / 2**30:.2f} GiB; "
          f"launches {launches}")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} -> {losses[-1]}")

    tcfg = cfg.replace(attn_impl="torch")
    tstep = make_train_step(tcfg, opt)
    tstep(state, batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, tm = tstep(state, batch)
    float(tm["loss"])
    torch.cuda.synchronize()
    torch_step = time.perf_counter() - t0
    print(f"[7] one training step with attn_impl='torch' (chunked torch forward + "
          f"torch recompute backward): {torch_step * 1e3:.1f} ms vs {steady * 1e3:.1f} ms "
          f"through the kernels")

    cfg32 = cfg.replace(dtype="float32")
    c0 = counters()
    _, _, g_cuda = loss_and_grads(make_loss_fn(cfg32.replace(attn_impl="cuda")),
                                  state.params, batch)
    if counters()[1] == c0[1]:
        fail("the float32 gradient check did not run the backward kernels")
    _, _, g_torch = loss_and_grads(make_loss_fn(cfg32.replace(attn_impl="torch")),
                                   state.params, batch)
    errs = [rel_err(torch, a, b) for a, b in zip(tree_leaves(g_cuda), tree_leaves(g_torch))]
    worst = max(errs)
    print(f"[7] float32 gradients, kernels vs torch recompute, over {len(errs)} leaves: "
          f"max rel_err {worst:.3e}, median {sorted(errs)[len(errs) // 2]:.3e} (tol 1e-3)")
    if not worst < 1e-3:
        fail(f"kernel gradients disagree with the torch recompute: {worst}")
    return dict(launches=launches, losses=losses, step_ms=steady * 1e3,
                first_step_ms=times[0] * 1e3, tokens_per_s=tokens / steady,
                peak_gib=peak / 2**30, torch_step_ms=torch_step * 1e3, grad_rel_err=worst)


def serve_requests(torch, ServeEngine, Request, params, cfg, lens=PROMPT_LENS, max_slots=4,
                   extras=None, **engine_kw):
    """Phase 5/6 traffic: greedy requests of prompts ``lens`` (6 by default)
    on ``max_slots`` slots; ``extras`` (a list, one dict of numpy arrays
    [1, ...] per request) gives each request its own source.  Returns
    (prompts, outputs, engine stats, wall seconds, the slotted cache's
    facts: its runs' state types, bytes per slot and S2 bytes per slot).
    The engine, which holds the weights and the cache, is freed on
    return."""
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen) for n in lens]
    eng = ServeEngine(params, cfg, max_slots=max_slots, n_max=N_MAX, decode_block=16,
                      **engine_kw)
    rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW,
                               extras=extras[i] if extras else {}))
            for i, p in enumerate(prompts)]
    t0 = time.perf_counter()
    outs = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    for rid, p in zip(rids, prompts):
        if rid not in outs or len(outs[rid]) != MAX_NEW:
            fail(f"request of prompt {len(p)} did not finish with {MAX_NEW} tokens")
    check_no_faults(eng.stats(), f"serving {cfg.attention} ({cfg.dtype})")
    cache = dict(runs=[type(x).__name__ for x in eng.caches["group"]],
                 slot_bytes=eng.slot_state_bytes,
                 s2_bytes=s2_bytes_per_slot(eng.caches, eng.max_slots))
    return prompts, [outs[r] for r in rids], eng.stats(), wall, cache


def check_no_faults(st, what):
    """Serving runs through the engine's resilience boundary, which turns an
    exception in a decode dispatch into retries and FAILED requests: a run
    without an injected fault must have caught none and quarantined none."""
    if st.get("dispatch_failures", 0) or st.get("quarantined", 0):
        fail(f"{what}: dispatch_failures={st.get('dispatch_failures', 0)} "
             f"quarantined={st.get('quarantined', 0)} without an injected fault")


def on_card(torch, ex):
    """A request's extras (numpy arrays) as tensors on the card."""
    return {k: torch.as_tensor(v).cuda() for k, v in (ex or {}).items()}


def cross_check(torch, lm_apply, params, cfg, prompts, outs, extras=None):
    """Phase 6: each engine token against the argmax of ``lm_apply`` (through
    the kernel) over prompt + output, with each request's own extras.
    Returns (mismatches that are not near-ties, positions whose top-2 logit
    gap is below NEAR_TIE)."""
    near_ties = mismatches = 0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        seq = torch.cat([p, torch.as_tensor(o[:-1])]).cuda()[None]
        lg, _ = lm_apply(params, {"tokens": seq, **on_card(torch, extras and extras[i])}, cfg)
        lg = lg[0, len(p) - 1:]
        top2 = lg.topk(2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu()
        pred = lg.argmax(-1).cpu().numpy()
        for t in range(MAX_NEW):
            tie = float(gap[t]) < NEAR_TIE
            near_ties += tie
            if pred[t] != o[t] and not tie:
                mismatches += 1
    return mismatches, near_ties


def cross_check_decode(torch, lm_prefill, lm_decode_step, slots, params, cfg, prompts, outs,
                       extras=None):
    """Each engine token against the argmax of the model's own serving path
    with the engine's tokens fed back: every request prefilled alone into a
    slot of one cache, then all decoded together.  For ``linear_elu``, whose
    decode reads its KV cache with the exact softmax (as the JAX package's
    does) while ``lm_apply`` runs elu linear attention, this is the oracle
    past the first token.  Returns (mismatches that are not near-ties,
    near-ties).  ``extras``: each request's source, as in ``cross_check``."""
    n_max = max(len(p) for p in prompts) + MAX_NEW
    caches = slots.init_slot_caches(cfg, len(prompts), n_max)
    first = []
    for j, p in enumerate(prompts):
        ex = on_card(torch, extras and extras[j])
        lg, c = lm_prefill(params, {"tokens": p.cuda()[None], **ex}, cfg, n_max)
        caches = slots.write_slot(caches, c, j)
        first.append(lg[0])
    logits = [torch.stack(first)]
    toks = torch.stack([torch.as_tensor(o) for o in outs]).cuda()  # [requests, MAX_NEW]
    pos = torch.tensor([len(p) for p in prompts], dtype=torch.int32, device=toks.device)
    for t in range(MAX_NEW - 1):
        lg, caches = lm_decode_step(params, toks[:, t], caches, pos + t, cfg)
        logits.append(lg)
    lg = torch.stack(logits, dim=1)  # [requests, MAX_NEW, vocab]
    top2 = lg.topk(2, dim=-1).values
    tie = (top2[..., 0] - top2[..., 1]) < NEAR_TIE
    wrong = lg.argmax(-1) != toks
    return int((wrong & ~tie).sum()), int(tie.sum())


def phase_baselines(torch, K, infer, serve_fn, cross_fn):
    """Phase 8: the paper's baselines at full width — smollm-135m on the
    softmax, softmax_window and linear_elu backends, and taylor order 1
    through the kernels.  For each: the forward, serving in f32 with every
    engine token checked, then (with the inference weights freed, so that
    peak memory compares with phase 7's) training steps whose loss must
    fall.  For softmax also the flash path (n = 4096) against the forced
    dense path; for order 1 its f32 logits against attn_impl="torch"."""
    from repro_torch.backends import softmax as softmax_backend
    from repro_torch.configs import get_config
    from repro_torch.core import TaylorConfig
    from repro_torch.data import make_task
    from repro_torch.models import lm_decode_step, lm_init, lm_prefill
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.serve import slots
    from repro_torch.train import make_train_step, train_state_init

    variants = {
        "softmax": get_config("smollm-135m", backend="softmax"),
        "softmax_window": get_config("smollm-135m", backend="softmax_window"),
        "linear_elu": get_config("smollm-135m", backend="linear_elu"),
        "taylor-1": get_config("smollm-135m", taylor=TaylorConfig(order=1)),
    }
    params = lm_init(torch.Generator().manual_seed(0), variants["softmax"])
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, variants["softmax"].vocab, (4, 1024), generator=gen).cuda()
    summary, launches = {}, {}
    for name, cfg in variants.items():
        tag = f"[8] {name}"
        cfg32 = cfg.replace(dtype="float32")
        # -- forward --
        K.taylor_fwd.launches = 0
        logits, _ = infer(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        fwd_launches = K.taylor_fwd.launches
        if fwd_launches != kernel_layers(torch, cfg):
            fail(f"{tag} lm_apply launched taylor_fwd {fwd_launches} times")
        if logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all():
            fail(f"{tag} lm_apply logits have the wrong shape or are not finite")
        del logits
        fwd_ms = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 3)
        print(f"{tag} lm_apply b={tokens.shape[0]} n={tokens.shape[1]} {cfg.dtype}: "
              f"forward_ms={fwd_ms:.2f} "
              f"taylor_fwd launches={fwd_launches}")
        if name == "taylor-1":
            launches["lm_apply"] = fwd_launches
            err = rel_err(torch, infer(params, {"tokens": tokens}, cfg32)[0],
                          infer(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
            print(f"{tag} float32 logits rel_err kernel vs torch = {err:.3e} (tol 1e-3)")
            if not err < 1e-3:
                fail(f"{tag} float32 kernel forward disagrees with the torch forward: {err}")
        if name == "softmax":
            long = torch.randint(0, cfg.vocab, (1, FLASH_N), generator=gen).cuda()
            flash, calls = softmax_backend.flash_softmax_attention, []
            softmax_backend.flash_softmax_attention = (
                lambda *a, **kw: calls.append(1) or flash(*a, **kw))
            try:
                t0 = time.perf_counter()
                flash_logits = infer(params, {"tokens": long}, cfg32)[0]
                torch.cuda.synchronize()
                flash_s = time.perf_counter() - t0
            finally:
                softmax_backend.flash_softmax_attention = flash
            min_seq = softmax_backend._FLASH_MIN_SEQ
            softmax_backend._FLASH_MIN_SEQ = FLASH_N  # forces the dense path
            try:
                t0 = time.perf_counter()
                dense_logits = infer(params, {"tokens": long}, cfg32)[0]
                torch.cuda.synchronize()
                dense_s = time.perf_counter() - t0
            finally:
                softmax_backend._FLASH_MIN_SEQ = min_seq
            err = rel_err(torch, flash_logits, dense_logits)
            del flash_logits, dense_logits
            print(f"{tag} flash path b=1 n={FLASH_N} float32: {len(calls)} flash calls, "
                  f"logits rel_err vs dense = {err:.3e} (tol {FLASH_TOL}); "
                  f"lm_apply {flash_s * 1e3:.1f} ms flash, {dense_s * 1e3:.1f} ms dense "
                  f"(host clock, one call each)")
            if len(calls) != cfg.n_layers:
                fail(f"{tag} the n={FLASH_N} forward took the flash path {len(calls)} times")
            if not err < FLASH_TOL:
                fail(f"{tag} flash logits disagree with the dense path: {err}")
        # -- serving (f32) --
        K.taylor_fwd.launches = 0
        prompts, outs, st, wall, _ = serve_fn(params, cfg32)
        if name == "linear_elu":
            mismatches, near_ties = cross_check_decode(
                torch, lm_prefill, lm_decode_step, slots, params, cfg32, prompts, outs)
            oracle = "its prefill + decode path (softmax KV read)"
        else:
            mismatches, near_ties = cross_fn(params, cfg32, prompts, outs)
            oracle = "lm_apply argmax"
        decode_tps = st["decode_tokens"] / st["decode_seconds"]
        print(f"{tag} served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
              f"prefill {st['prefill_seconds']:.3f} s, decode {st['decode_tokens']} tokens in "
              f"{st['decode_seconds']:.3f} s = {decode_tps:.1f} tokens/s; engine tokens vs "
              f"{oracle}: mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}")
        if mismatches:
            fail(f"{tag} {mismatches} engine tokens differ from {oracle}")
        summary[name] = dict(forward_ms=fwd_ms, decode_tokens_per_s=decode_tps, tokens=outs)
    del params
    batch = bigram_batch(torch, make_task, variants["softmax"])
    for name, cfg in variants.items():
        tag = f"[8] {name}"
        opt = adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], BASELINE_STEPS))
        state, losses, times, tl, peak = train_steps(
            torch, K, cfg, lambda: train_state_init(torch.Generator().manual_seed(0), cfg, opt),
            make_train_step(cfg, opt), batch, BASELINE_STEPS, tag)
        del state  # before the next backend's run, whose peak would count it
        steady = sum(times[1:]) / (len(times) - 1)
        tps = TRAIN["b"] * TRAIN["n"] / steady
        print(f"{tag} training {cfg.dtype} remat={cfg.remat} b={TRAIN['b']} n={TRAIN['n']}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; first step {times[0] * 1e3:.1f} ms, "
              f"then {steady * 1e3:.1f} ms/step = {tps:.0f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {tl}")
        if not losses[-1] < losses[0]:
            fail(f"{tag} loss did not fall: {losses[0]} -> {losses[-1]}")
        if name == "taylor-1":
            launches["train"] = tl
        summary[name].update(train_ms_per_step=steady * 1e3, train_tokens_per_s=tps,
                             peak_gib=peak / 2**30)
    print("[8] summary (smollm-135m full width; forward b=4 n=1024 bf16, training b=4 "
          "n=1024 bf16 remat full, decode f32 on 4 slots): " + "; ".join(
              f"{n_}: forward {r['forward_ms']:.2f} ms, train {r['train_ms_per_step']:.1f} "
              f"ms/step, decode {r['decode_tokens_per_s']:.1f} tokens/s"
              for n_, r in summary.items()))
    return summary, launches


def diverging_requests(torch, infer, params, cfg, prompts, want, got, tie=NEAR_TIE,
                       margins=None):
    """Requests whose tokens ``got`` differ from ``want`` (both greedy, the
    same prompts).  Past the first position where they differ the two
    continue from other prefixes, so that position alone is judged: ``cfg``'s
    ``lm_apply`` over prompt + ``want``'s tokens before it must put the two
    tokens' logits within ``tie`` of each other, whichever is higher.  Each
    such margin (``want``'s logit minus ``got``'s) is appended to
    ``margins`` when given.  Returns (requests that differ, of those within
    ``tie``, of those not)."""
    differ = ties = 0
    for p, w, g in zip(prompts, want, got):
        diff = (torch.as_tensor(w) != torch.as_tensor(g)).nonzero()
        if not len(diff):
            continue
        differ += 1
        t = int(diff[0, 0])
        seq = torch.cat([p, torch.as_tensor(w[:t])]).cuda()[None]
        lg = infer(params, {"tokens": seq}, cfg)[0][0, -1]
        gap = float(lg[int(w[t])] - lg[int(g[t])])
        if margins is not None:
            margins.append(gap)
        ties += abs(gap) < tie
    return differ, ties, differ - ties


def s2_bytes_per_slot(caches, slots: int) -> int:
    """Bytes of the S2 moments of a slotted cache, per slot."""
    return sum(st.s2.numel() * st.s2.element_size()
               for st in caches["group"] if hasattr(st, "s2") and st.s2 is not None) // slots


def phase_hybrid(torch, K, infer, serve_fn, cross_fn, full_f32):
    """Phase 9: the Based-style hybrid at smollm-135m's full width (taylor
    order 2 at pattern position 0, the 128-token sliding window at 1, 15
    groups) — the forward, f32 serving from a per-run cache of two state
    types, and training through the kernels — then smollm-135m with
    sym_state (f32 serving against phase 6's full-state tokens,
    ``full_f32`` = (prompts, outputs, stats)), with decay (f32 forward
    against its own prefill + decode, training on the torch paths, f32
    serving against its own prefill + decode path), and the non-causal
    form against the explicit feature map."""
    from repro_torch.configs import get_config
    from repro_torch.core import TaylorConfig, linear_attention, taylor_attention
    from repro_torch.core import taylor_features
    from repro_torch.data import make_task
    from repro_torch.models import lm_decode_step, lm_init, lm_prefill, lm_state_bytes
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.serve import slots
    from repro_torch.train import make_train_step, train_state_init

    cfg = get_config("smollm-135m").replace(**HYBRID)
    cfg32 = cfg.replace(dtype="float32")
    n_kernel = kernel_layers(torch, cfg)
    out = dict(cfg=dict(HYBRID, taylor_layers=n_kernel))
    # block weights do not depend on the backend: the same seed gives phase 4's
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen).cuda()

    # -- hybrid forward --
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    logits, _ = infer(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    out["lm_apply_launches"] = dict(zip(("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv"),
                                        taylor_counters(K)))
    if n_kernel != cfg.n_layers // 2 or taylor_counters(K) != (n_kernel, 0, 0):
        fail(f"[9] hybrid lm_apply launched (fwd, dq, dkv) = {taylor_counters(K)}, "
             f"expected ({cfg.n_layers // 2}, 0, 0)")
    if logits.shape != (*tokens.shape, cfg.vocab) or not torch.isfinite(logits).all():
        fail("[9] hybrid lm_apply logits have the wrong shape or are not finite")
    del logits
    out["forward_ms"] = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 3)
    err32 = rel_err(torch, infer(params, {"tokens": tokens}, cfg32)[0],
                    infer(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
    print(f"[9] hybrid lm_apply b=4 n=1024 {cfg.dtype}: forward_ms={out['forward_ms']:.2f} "
          f"launches={out['lm_apply_launches']}; float32 logits rel_err kernel vs "
          f"torch = {err32:.3e} (tol 1e-3)")
    if not err32 < 1e-3:
        fail(f"[9] hybrid float32 kernel forward disagrees with the torch forward: {err32}")

    # -- hybrid serving (f32) --
    prompts, outs, st, wall, cache = serve_fn(params, cfg32)
    mismatches, near_ties = cross_fn(params, cfg32, prompts, outs)
    kinds, per_slot = cache["runs"], cache["slot_bytes"]
    want = lm_state_bytes(cfg32, 1, N_MAX)
    pure = lm_state_bytes(get_config("smollm-135m", dtype="float32"), 1, N_MAX)
    out.update(decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
               prefill_s=st["prefill_seconds"], slot_bytes=per_slot, taylor_slot_bytes=pure)
    print(f"[9] hybrid served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
          f"prefill {st['prefill_seconds']:.3f} s over {st['prefill_dispatches']} dispatches, "
          f"decode {out['decode_tokens_per_s']:.1f} tokens/s; engine tokens vs lm_apply argmax: "
          f"mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}; cache runs {kinds}; "
          f"slot_bytes={per_slot} (lm_state_bytes(cfg, 1, n_max)={want}; pure taylor "
          f"{pure}, {per_slot / pure:.3f} of it)")
    if mismatches:
        fail(f"[9] {mismatches} hybrid engine tokens differ from the lm_apply argmax")
    if kinds != ["TaylorState", "KVCache"]:
        fail(f"[9] the hybrid's slotted cache has runs {kinds}")
    if per_slot != want:
        fail(f"[9] hybrid slot_bytes {per_slot} != lm_state_bytes {want}")

    # -- sym_state serving (f32), against phase 6's full-state tokens --
    sym32 = get_config("smollm-135m", taylor=TaylorConfig(sym_state=True), dtype="float32")
    full32 = sym32.replace(taylor=TaylorConfig())
    f_prompts, f_outs, f_st = full_f32
    prompts, outs, st, wall, cache = serve_fn(params, sym32)
    s2_sym, sym_slot = cache["s2_bytes"], cache["slot_bytes"]
    s2_full = s2_bytes_per_slot(slots.init_slot_caches(full32, 1, N_MAX, device="meta"), 1)
    full_slot = lm_state_bytes(full32, 1, N_MAX)
    if any(not torch.equal(a, b) for a, b in zip(prompts, f_prompts)):
        fail("[9] sym_state served other prompts than phase 6")
    differ, ties, bad = diverging_requests(torch, infer, params, full32, prompts, f_outs, outs)
    out["sym_state"] = dict(
        decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
        full_decode_tokens_per_s=f_st["decode_tokens"] / f_st["decode_seconds"],
        slot_bytes=sym_slot, full_slot_bytes=full_slot, s2_bytes=s2_sym,
        full_s2_bytes=s2_full, requests_differ=differ, near_ties=ties)
    print(f"[9] sym_state served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
          f"decode {out['sym_state']['decode_tokens_per_s']:.1f} tokens/s (full state, phase 6: "
          f"{out['sym_state']['full_decode_tokens_per_s']:.1f}); per slot {sym_slot} bytes, S2 "
          f"{s2_sym} (full state {full_slot}, S2 {s2_full}: {s2_sym / s2_full:.4f}); tokens vs "
          f"the full state's: {differ} requests differ, {ties} at a near-tie "
          f"(gap<{NEAR_TIE}), {bad} not")
    if bad:
        fail(f"[9] sym_state tokens differ from the full state's in {bad} requests")
    if not s2_sym < SYM_S2_SHARE * s2_full:
        fail(f"[9] sym_state S2 per slot {s2_sym} is not under {SYM_S2_SHARE} of {s2_full}")

    # -- decay: forward vs its own prefill + decode (f32), serving (f32) --
    dec = get_config("smollm-135m", taylor=TaylorConfig(decay=DECAY))
    dec32 = dec.replace(dtype="float32")
    errs = []
    for n_pre, steps in ((tokens.shape[1] - 1, 1), DECODE_CHECK):
        seq = tokens[:, :n_pre + steps]
        full = infer(params, {"tokens": seq}, dec32)[0][:, n_pre:]
        lg, caches = lm_prefill(params, {"tokens": seq[:, :n_pre]}, dec32, n_pre + steps)
        got = []
        for t in range(steps):
            lg, caches = lm_decode_step(params, seq[:, n_pre + t], caches, n_pre + t, dec32)
            got.append(lg)
        errs.append(rel_err(torch, torch.stack(got, dim=1), full))
        del caches, full
    print(f"[9] decay={DECAY} float32 lm_apply vs its prefill + decode: rel_err "
          f"{errs[0]:.3e} at the last of {tokens.shape[1]} positions (parallel prefill of "
          f"{tokens.shape[1] - 1}), {errs[1]:.3e} over {DECODE_CHECK[1]} steps after a chunked "
          f"prefill of {DECODE_CHECK[0]} (tol {DECAY_TOL})")
    if not max(errs) < DECAY_TOL:
        fail(f"[9] decayed forward and prefill + decode disagree: {errs}")
    prompts, outs, st, wall, _ = serve_fn(params, dec32)
    mismatches, near_ties = cross_check_decode(torch, lm_prefill, lm_decode_step, slots,
                                               params, dec32, prompts, outs)
    out["decay"] = dict(decode_tokens_per_s=st["decode_tokens"] / st["decode_seconds"],
                        forward_vs_decode_rel_err=max(errs))
    print(f"[9] decay served {len(outs)} requests x {MAX_NEW} tokens f32 in {wall:.2f} s: "
          f"decode {out['decay']['decode_tokens_per_s']:.1f} tokens/s; engine tokens vs its "
          f"prefill + decode path: mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}")
    if mismatches:
        fail(f"[9] {mismatches} decayed engine tokens differ from its prefill + decode path")
    del params

    # -- training: the hybrid through the kernels, decay on the torch paths --
    batch = bigram_batch(torch, make_task, cfg)
    for name, tcfg, steps in (("hybrid", cfg, HYBRID_STEPS), ("decay", dec, DECAY_STEPS)):
        tag = f"[9] {name}"
        opt = adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], steps))
        state, losses, times, tl, peak = train_steps(
            torch, K, tcfg, lambda: train_state_init(torch.Generator().manual_seed(0), tcfg, opt),
            make_train_step(tcfg, opt), batch, steps, tag)
        del state
        steady = sum(times[1:]) / (len(times) - 1)
        tps = TRAIN["b"] * TRAIN["n"] / steady
        print(f"{tag} training {tcfg.dtype} remat={tcfg.remat} b={TRAIN['b']} n={TRAIN['n']}: "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; first step {times[0] * 1e3:.1f} ms, "
              f"then {steady * 1e3:.1f} ms/step = {tps:.0f} tokens/s; peak memory "
              f"{peak / 2**30:.2f} GiB; launches {tl}")
        if not losses[-1] < losses[0]:
            fail(f"{tag} loss did not fall: {losses[0]} -> {losses[-1]}")
        rec = out if name == "hybrid" else out["decay"]
        rec.update(train_ms_per_step=steady * 1e3, train_tokens_per_s=tps,
                   peak_gib=peak / 2**30, train_launches=tl, losses=losses)

    # -- non-causal: taylor_attention(causal=False) vs the explicit feature map --
    tc = TaylorConfig()
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, h, hk, n, d = 4, cfg.n_heads, cfg.n_kv_heads, 1024, cfg.resolved_head_dim
    phi = lambda x: taylor_features(x, tc)
    for dname in ("float32", "bfloat16"):
        dtype = getattr(torch, dname)
        q = torch.randn(b, h, n, d, device="cuda", generator=gen).to(dtype)
        k, v = (torch.randn(b, hk, n, d, device="cuda", generator=gen).to(dtype)
                for _ in range(2))
        with torch.no_grad():
            got = taylor_attention(q, k, v, tc, causal=False)
            # the same bf16 q, k (normalised, then rounded as the Taylor path
            # rounds them) and float32 v: a float32 explicit-feature output
            ref32 = linear_attention(q, k, v.float(), phi=phi, causal=False, normalize_qk=True)
            ms = cuda_ms(torch, lambda: taylor_attention(q, k, v, tc, causal=False), 5)
            ref_ms = cuda_ms(torch, lambda: linear_attention(q, k, v, phi=phi, causal=False,
                                                             normalize_qk=True), 3)
        torch.cuda.synchronize()
        errs, _ = fwd_errors(torch, got, ref32)
        # bf16 answers to the f32 tolerance beyond its own rounding
        # (``excess``); its ``rel`` counts one-ulp rounding flips, up to
        # 2^-7 of max |ref|, and is only reported
        judged = "excess" if "excess" in errs else "rel"
        bad = not errs[judged] < F32_TOL
        out.setdefault("noncausal", {})[dname] = dict(ms=ms, features_ms=ref_ms, **errs)
        print(f"[9] non-causal taylor_attention b={b} h={h} hk={hk} n={n} d={d} {dname}: "
              + " ".join(f"{k_}_err={e_:.3e}" for k_, e_ in errs.items())
              + f" against the explicit feature map (tol {F32_TOL}"
              + (" on excess)" if "excess" in errs else ")")
              + f"; {ms:.3f} ms, explicit features {ref_ms:.3f} ms")
        if bad:
            fail(f"[9] non-causal {dname} disagrees with the explicit feature map: "
                 f"{judged} error {errs[judged]}")
    return out


def host_ms(torch, fn, iters: int) -> float:
    """Median host-clock ms of ``fn`` followed by a device synchronize (warm)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def tol_ratio(torch, got, want, tol):
    """(max |got - want|, max |got - want| / (tol + tol |want|)): the second
    is <= 1 exactly when ``torch.allclose(got, want, rtol=tol, atol=tol)``."""
    diff = (got.double() - want.double()).abs()
    return float(diff.max()), float((diff / (tol + tol * want.double().abs())).max())


@contextlib.contextmanager
def captured_kv(backend_cls):
    """Record the ``(k, v)`` that ``backend_cls.prefill`` and
    ``.prefill_chunk`` are given, call by call, while the block runs."""
    whole, chunks = [], []
    prefill_fn, chunk_fn = backend_cls.prefill, backend_cls.prefill_chunk

    def prefill(self, q, k, v, cfg, n_max):
        whole.append((k.clone(), v.clone()))
        return prefill_fn(self, q, k, v, cfg, n_max)

    def prefill_chunk(self, cache, q, k, v, cfg, pos):
        chunks.append((k.clone(), v.clone()))
        return chunk_fn(self, cache, q, k, v, cfg, pos)

    backend_cls.prefill, backend_cls.prefill_chunk = prefill, prefill_chunk
    try:
        yield whole, chunks
    finally:
        backend_cls.prefill, backend_cls.prefill_chunk = prefill_fn, chunk_fn


def state_gap_origin(torch, cfg, whole, chunked, kv_whole, kv_chunked):
    """Where chunked and whole prefill's Taylor states differ most, and why.

    Finds the state entry (layer, leaf, index) with the worst
    ``|chunked - whole| / (atol + rtol |whole|)`` and recomputes it in
    float64 from each path's own keys and values (``kv_*``: per layer, the
    ``(k, v)`` the backend was given).  Returns a dict: both f32 values, both
    float64 sums, and ``sum_abs``, the sum of the entry's terms' magnitudes,
    against which f32 rounding is measured (unit roundoff 2^-24), and
    ``sum_abs_delta``, the sum of the magnitudes of the terms' differences
    between the two paths' inputs, which bounds how far the layer's
    inputs alone move the float64 sum."""
    import numpy as np

    from repro_torch.models.lm import _split_caches

    worst = None
    for layer, (ws, cs) in enumerate(zip(_split_caches(whole, cfg), _split_caches(chunked, cfg))):
        for name, w, c in zip(ws._fields, ws, cs):
            if w is None:
                continue
            ratio = (c.double() - w.double()).abs() / (CHUNK_TOL + CHUNK_TOL * w.double().abs())
            r = float(ratio.max())
            if worst is None or r > worst[0]:
                idx = tuple(int(i) for i in np.unravel_index(int(ratio.argmax()), tuple(w.shape)))
                worst = (r, layer, name, idx, float(w[idx]), float(c[idx]))
    ratio, layer, name, idx, w32, c32 = worst

    def terms(k, v):
        k, v = k.double(), v.double()
        if cfg.taylor.normalize_qk:  # the backend's layernorm_no_affine, in float64
            mu = k.mean(dim=-1, keepdim=True)
            k = (k - mu) * torch.rsqrt((k - mu).square().mean(dim=-1, keepdim=True) + 1e-6)
        b, h, *rest = idx
        kt, vt = k[b, h], v[b, h]  # [n, d], [n, dv]
        return {
            "n0": lambda: torch.ones_like(kt[:, 0]),
            "s0": lambda: vt[:, rest[0]],
            "z1": lambda: kt[:, rest[0]],
            "s1": lambda: kt[:, rest[0]] * vt[:, rest[-1]],
            "z2": lambda: kt[:, rest[0]] * kt[:, rest[1]],
            "s2": lambda: kt[:, rest[0]] * kt[:, rest[1]] * vt[:, rest[2]],
        }[name]()

    t_whole, t_chunked = terms(*kv_whole[layer]), terms(*kv_chunked[layer])
    return dict(ratio=ratio, layer=layer, leaf=name, index=idx, whole_f32=w32, chunked_f32=c32,
                whole_f64=float(t_whole.sum()), chunked_f64=float(t_chunked.sum()),
                sum_abs=float(t_whole.abs().sum()),
                sum_abs_delta=float((t_whole - t_chunked).abs().sum()))


def counting_plan(faults, plan):
    """``plan`` as a FaultPlan that counts the dispatch failures it injects,
    so that every failure the engine caught can be told to be an injected
    one."""

    class Counting(faults.FaultPlan):
        injected = 0

        def check_dispatch(self, block):
            try:
                super().check_dispatch(block)
            except faults.InjectedDispatchError:
                self.injected += 1
                raise

    return Counting(plan.events, seed=plan.seed)


def phase_serving_load(torch, K, infer, full_f32):
    """Phase 10: serving under load at smollm-135m's full width (order 2, f32,
    4 slots, n_max N_MAX): (a) chunked against whole prefill, order 2 and
    the hybrid, with order 2's worst state entry recomputed in float64 from
    each path's keys and values (``state_gap_origin``); (b) chunked admission under the SLO policy, with a
    preemption, against FIFO whole-prompt admission; (c) the standard fault
    trace; (d) a Poisson trace replayed under the virtual clock; (e) the
    price of the health sweep and of a preemption's state handoff.
    ``full_f32`` = phase 6's (prompts, outputs, stats): the fault-free
    tokens.  Serving reaches no kernel (the JAX package's prefill and
    decode reach no Pallas kernel either): taylor_fwd launches are counted
    over every serving run and must be 0."""
    import numpy as np

    from repro_torch.backends.taylor import TaylorBackend
    from repro_torch.configs import get_config
    from repro_torch.models import lm_init
    from repro_torch.serve import (Request, ResiliencePolicy, SchedulerPolicy, ServeEngine,
                                   Status, faults, poisson_trace, prefill, prefill_chunked,
                                   run_trace, slots)
    from repro_torch.tree import tree_leaves

    cfg32 = get_config("smollm-135m", dtype="float32")
    hybrid32 = cfg32.replace(**HYBRID)
    params = lm_init(torch.Generator().manual_seed(0), cfg32)  # phase 4's weights
    f_prompts, f_outs, _ = full_f32
    out = {}
    launches = 0

    def engine(**kw):
        return ServeEngine(params, cfg32, max_slots=4, n_max=N_MAX, decode_block=16, **kw)

    # -- (a) chunked against whole prefill --
    gen = torch.Generator().manual_seed(3)
    for (n, chunk), cfg in zip(CHUNK_CASES, (cfg32, hybrid32)):
        tag = "hybrid" if cfg is hybrid32 else "order2"
        batch = {"tokens": torch.randint(0, cfg.vocab, (1, n), generator=gen).cuda()}
        K.taylor_fwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wl, wc = prefill(params, batch, cfg, N_MAX)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        cl, cc = prefill_chunked(params, batch, cfg, N_MAX, chunk)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        if tag == "order2":  # again, untimed, keeping each layer's keys and values
            with captured_kv(TaylorBackend) as (kv_whole, kv_chunks):
                prefill(params, batch, cfg, N_MAX)
                prefill_chunked(params, batch, cfg, N_MAX, chunk)
            n_layers = len(kv_whole)
            kv_chunked = [tuple(torch.cat(part, dim=2) for part in zip(*kv_chunks[i::n_layers]))
                          for i in range(n_layers)]
            origin = state_gap_origin(torch, cfg, wc, cc, kv_whole, kv_chunked)
        launches += K.taylor_fwd.launches
        logit_err, logit_ratio = tol_ratio(torch, cl, wl, CHUNK_TOL)
        pairs = list(zip(tree_leaves(cc), tree_leaves(wc)))
        if len(pairs) != len(tree_leaves(wc)) or any(a.shape != b.shape for a, b in pairs):
            fail(f"[10a] {tag}: chunked prefill's cache has another structure than prefill's")
        errs = [tol_ratio(torch, a, b, CHUNK_TOL) for a, b in pairs if a.is_floating_point()]
        ints_equal = all(torch.equal(a, b) for a, b in pairs if not a.is_floating_point())
        state_err, state_ratio = max(e for e, _ in errs), max(r for _, r in errs)
        out[f"chunked_{tag}"] = dict(prompt=n, chunk=chunk, logit_err=logit_err,
                                     state_err=state_err, whole_s=t1 - t0, chunked_s=t2 - t1)
        print(f"[10a] {tag} f32 prompt {n}: prefill_chunked(chunk={chunk}) vs prefill: logits "
              f"max_abs_err={logit_err:.3e}, {len(errs)} state leaves max_abs_err={state_err:.3e}, "
              f"max err/(atol + rtol|ref|) = {max(logit_ratio, state_ratio):.3f} (atol = rtol = "
              f"{CHUNK_TOL}); int leaves equal: {ints_equal}; whole {(t1 - t0) * 1e3:.1f} ms, "
              f"chunked {(t2 - t1) * 1e3:.1f} ms (host clock, one call each)")
        if tag == "order2":
            o = origin
            u32 = 2.0 ** -24
            print(f"[10a] order2 worst state entry: layer {o['layer']} leaf {o['leaf']} index "
                  f"{o['index']} (err/(atol + rtol|ref|) {o['ratio']:.3f}): whole f32 "
                  f"{o['whole_f32']:.9g}, chunked f32 {o['chunked_f32']:.9g}; float64 from "
                  f"whole's k/v {o['whole_f64']:.9g}, from chunked's k/v {o['chunked_f64']:.9g}; "
                  f"|whole - f64| {abs(o['whole_f32'] - o['whole_f64']):.3e}, |chunked - f64| "
                  f"{abs(o['chunked_f32'] - o['chunked_f64']):.3e}; sum of |terms| "
                  f"{o['sum_abs']:.6g} (x 2^-24 = {o['sum_abs'] * u32:.3e}), of their "
                  f"differences between the paths' inputs {o['sum_abs_delta']:.3e}")
            out["chunked_order2"]["origin"] = o
        if not (logit_ratio <= 1 and state_ratio <= 1 and ints_equal):
            fail(f"[10a] {tag}: chunked prefill disagrees with whole prefill")
        del wc, cc

    # -- (b) chunked admission under the SLO policy, against FIFO --
    u_gen = torch.Generator().manual_seed(4)
    urgent = [torch.randint(0, cfg32.vocab, (n,), generator=u_gen) for n in URGENT[0]]
    runs = {}
    for name, kw in (("fifo", {}), ("slo", dict(prefill_chunk=LOAD_CHUNK,
                                                  sched=SchedulerPolicy(**SLO_SCHED)))):
        eng = engine(**kw)
        K.taylor_fwd.launches = 0
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW, priority=1))
                for p in f_prompts]
        eng.step()
        rids += [eng.submit(Request(tokens=u.numpy(), max_new_tokens=URGENT[1], priority=0))
                 for u in urgent]
        res = eng.run(return_results=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += K.taylor_fwd.launches
        st = eng.stats()
        del eng
        if any(res[r].status is not Status.OK for r in rids):
            fail(f"[10b] {name}: statuses {[res[r].status.value for r in rids]}")
        check_no_faults(st, f"[10b] {name}")
        ttft = [res[r].first_token_at - res[r].submitted_at for r in rids]
        runs[name] = dict(tokens=[res[r].tokens.astype(np.int64) for r in rids], ttft=ttft,
                          stats=st, wall=wall)
        print(f"[10b] {name}: {len(rids)} requests in {wall:.2f} s; TTFT of the priority-0 "
              f"{URGENT[0][0]}-token request {ttft[-2] * 1e3:.1f} ms, of the "
              f"{URGENT[0][1]}-token one {ttft[-1] * 1e3:.1f} ms; prefill "
              f"{st['prefill_dispatches']} dispatches {st['prefill_seconds']:.3f} s, decode "
              f"{st['decode_tokens']} tokens in {st['decode_seconds']:.3f} s = "
              f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s; preemptions "
              f"{st.get('preemptions', 0)} resumes {st.get('resumes', 0)}")
    st = runs["slo"]["stats"]
    if not (st.get("preemptions", 0) >= 1 and st.get("resumes", 0) == st["preemptions"]):
        fail(f"[10b] SLO policy: preemptions {st.get('preemptions', 0)}, "
             f"resumes {st.get('resumes', 0)}")
    differ, ties, bad = diverging_requests(torch, infer, params, cfg32, f_prompts + urgent,
                                           runs["fifo"]["tokens"], runs["slo"]["tokens"])
    print(f"[10b] SLO-policy tokens vs FIFO whole-prompt tokens: {differ} of "
          f"{len(f_prompts) + len(urgent)} requests differ, {ties} at a near-tie "
          f"(gap<{NEAR_TIE}), {bad} not")
    if bad:
        fail(f"[10b] {bad} requests' tokens differ between the SLO and FIFO engines")
    out["ttft_ms"] = {k: r["ttft"][-2] * 1e3 for k, r in runs.items()}
    out["slo_preemptions"] = st["preemptions"]

    # -- (c) the standard fault trace --
    plan = counting_plan(faults, faults.standard_trace(slot=0))
    eng = engine(fault_plan=plan, policy=ResiliencePolicy(max_queue=FAULT_MAX_QUEUE))
    K.taylor_fwd.launches = 0
    t0 = time.perf_counter()
    rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW)) for p in f_prompts]
    res = eng.run(return_results=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches += K.taylor_fwd.launches
    st = eng.stats()
    del eng
    terminal = sum(st.get(k, 0) for k in ("ok", "degraded", "timed_out", "failed", "rejected"))
    statuses = {s.value: sum(r.status is s for r in res.values()) for s in Status}
    print(f"[10c] standard fault trace (flood of 6 at block 1, a dispatch failure at 2, NaN in "
          f"slot 0 at 3; max_queue {FAULT_MAX_QUEUE}) on {len(rids)} requests in {wall:.2f} s: "
          f"{st['submitted']} submitted, terminal {statuses}; dispatch_failures "
          f"{st.get('dispatch_failures', 0)} (injected {plan.injected}), dispatch_retries "
          f"{st.get('dispatch_retries', 0)}, corruptions {st.get('corruptions_injected', 0)}, "
          f"quarantined {st.get('quarantined', 0)}, retries {st.get('retries', 0)}, shed "
          f"{st.get('shed', 0)}, cache_rebuilds {st.get('cache_rebuilds', 0)}, health_checks "
          f"{st.get('health_checks', 0)}")
    if sorted(res) != list(range(st["submitted"])) or terminal != st["submitted"]:
        fail(f"[10c] {st['submitted']} submitted, {len(res)} results, {terminal} terminal")
    if any(res[r].status is not Status.OK for r in rids):
        fail(f"[10c] statuses {[res[r].status.value for r in rids]}")
    if not (plan.injected == 1 and st.get("dispatch_failures", 0) == plan.injected):
        fail(f"[10c] {st.get('dispatch_failures', 0)} dispatch failures caught, "
             f"{plan.injected} injected")
    if st.get("quarantined", 0) < 1 or st.get("cache_rebuilds", 0) != 0:
        fail(f"[10c] quarantined {st.get('quarantined', 0)} (>= 1), cache_rebuilds "
             f"{st.get('cache_rebuilds', 0)} (0: one failure is retried in place)")
    differ, ties, bad = diverging_requests(torch, infer, params, cfg32, f_prompts, f_outs,
                                           [res[r].tokens.astype(np.int64) for r in rids])
    print(f"[10c] tokens vs the fault-free run (phase 6): {differ} requests differ, {ties} at "
          f"a near-tie, {bad} not")
    if bad:
        fail(f"[10c] {bad} requests' tokens differ from the fault-free run")

    # -- (d) a replayed Poisson trace under the virtual clock --
    trace = poisson_trace(vocab=cfg32.vocab, **REPLAY)
    held = []

    def factory(clock):
        held.append(engine(prefill_chunk=LOAD_CHUNK, sched=SchedulerPolicy(**SLO_SCHED),
                           clock=clock))
        return held[-1]

    K.taylor_fwd.launches = 0
    t0 = time.perf_counter()
    report = run_trace(factory, trace, "slo")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches += K.taylor_fwd.launches
    st = held.pop().stats()
    check_no_faults(st, "[10d]")
    delivered = report.metrics["n_delivered"]
    print(f"[10d] LoadReport {report.to_json()}")
    print(f"[10d] replay of poisson_trace({REPLAY}) at full width: {len(trace)} requests, "
          f"{delivered} delivered, in {wall:.2f} s wall; decode {st['decode_tokens']} tokens "
          f"in {st['decode_seconds']:.3f} s = {st['decode_tokens'] / st['decode_seconds']:.1f} "
          f"tokens/s; prefill {st['prefill_dispatches']} dispatches {st['prefill_seconds']:.3f} s")
    if delivered != len(trace):
        fail(f"[10d] {delivered} of {len(trace)} requests delivered")
    out["replay"] = dict(wall_s=wall, decode_tokens_per_s=st["decode_tokens"]
                         / st["decode_seconds"], metrics=report.metrics)

    # -- (e) the price of the health sweep and of a preemption's state handoff --
    sweep = {}
    for every in (0, 1):
        eng = engine(policy=ResiliencePolicy(health_check_every=every))
        K.taylor_fwd.launches = 0
        t0 = time.perf_counter()
        for p in f_prompts:
            eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW))
        eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches += K.taylor_fwd.launches
        st = eng.stats()
        check_no_faults(st, f"[10e] health_check_every={every}")
        sweep[every] = dict(wall=wall, checks=st.get("health_checks", 0),
                            tps=st["decode_tokens"] / (wall - st["prefill_seconds"]),
                            decode_tps=st["decode_tokens"] / st["decode_seconds"])
        if every:
            health_ms = host_ms(torch, lambda: slots.slot_health(eng.caches, cfg32).cpu(), 5)
            one = slots.read_slot(eng.caches, 1)
            handoff_ms = host_ms(torch, lambda: slots.write_slot(
                eng.caches, slots.read_slot(eng.caches, 1), 1), 5)
            slot_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(one))
        del eng
    print(f"[10e] phase 6's requests with health_check_every=0 / 1: wall {sweep[0]['wall']:.2f} / "
          f"{sweep[1]['wall']:.2f} s, {sweep[0]['checks']} / {sweep[1]['checks']} sweeps; decode "
          f"tokens over (wall - prefill) {sweep[0]['tps']:.1f} / {sweep[1]['tps']:.1f} tokens/s "
          f"(over decode_seconds {sweep[0]['decode_tps']:.1f} / {sweep[1]['decode_tps']:.1f}); "
          f"one slot_health sweep of the 4-slot cache {health_ms:.3f} ms; a preemption's "
          f"read_slot + write_slot of one {slot_bytes}-byte slot {handoff_ms:.3f} ms "
          f"(host clock with sync, median of 5)")
    out.update(sweep=sweep, health_ms=health_ms, handoff_ms=handoff_ms, slot_bytes=slot_bytes)

    print(f"[10] taylor_fwd launches over phase 10's serving runs: {launches} (chunked and "
          f"whole prefill and decode run the torch moment-state paths)")
    if launches:
        fail(f"[10] serving launched taylor_fwd {launches} times")
    out["launches"] = launches
    return out


def phase_spec_state(torch, K, infer, full_f32, softmax_tokens):
    """Phase 11: speculative decoding and the slot-state codecs at
    smollm-135m's full width (order 2, f32, 4 slots, n_max N_MAX, phase 4's
    weights, phase 6's requests).  (a) n-gram and order-1 drafts at
    ``speculative_k=SPEC_K`` against phase 6's tokens, beside a plain run at
    ``decode_block=1``; (b) int8 and fp8 moments: bytes per slot, a live
    slot's decode→encode→decode round trip on the card, the card's payloads
    and scales against the CPU's, tokens against phase 6's and a
    teacher-forced logit MAE; (c) phase 8's softmax serving with paged KV,
    token-identical to phase 8's dense run, no page leaked; (d) the n-gram
    draft over int8 moments against (b)'s int8 tokens.  ``full_f32`` =
    phase 6's (prompts, outputs, stats); ``softmax_tokens`` = phase 8's f32
    softmax outputs on the same prompts.  No path reaches a kernel: the
    verify, the draft, the rollback and the codecs run the torch
    moment-state paths, so taylor_fwd launches over the serving runs must
    be 0."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import lm_decode_step, lm_init, lm_state_bytes
    from repro_torch.serve import Request, SchedulerPolicy, ServeEngine, Status, prefill
    from repro_torch.serve.state_repr import QuantizedCodec
    from repro_torch.tree import tree_leaves, tree_map

    cfg32 = get_config("smollm-135m", dtype="float32")
    softmax32 = get_config("smollm-135m", backend="softmax", dtype="float32")
    params = lm_init(torch.Generator().manual_seed(0), cfg32)  # phase 4's weights
    f_prompts, f_outs, _ = full_f32
    dense_slot_bytes = lm_state_bytes(cfg32, 1, N_MAX)
    out = {"launches": 0}

    def serve(tag, cfg=cfg32, decode_block=16, step_hook=None, **kw):
        """Phase 6's requests through one engine; returns (tokens, stats,
        wall seconds, engine)."""
        eng = ServeEngine(params, cfg, max_slots=4, n_max=N_MAX, decode_block=decode_block,
                          **kw)
        K.taylor_fwd.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW)) for p in f_prompts]
        while eng.step():
            if step_hook is not None:
                step_hook(eng)
        res = eng.poll()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["launches"] += K.taylor_fwd.launches
        st = eng.stats()
        if any(res[r].status is not Status.OK or len(res[r].tokens) != MAX_NEW for r in rids):
            fail(f"[11] {tag}: statuses {[res[r].status.value for r in rids]}")
        check_no_faults(st, f"[11] {tag}")
        return [res[r].tokens.astype(np.int64) for r in rids], st, wall, eng

    def rates(st, wall):
        """(dispatches per emitted token, emitted decode tokens per second of
        wall clock outside prefill)."""
        emitted = st.get("decode_tokens", 0) + st.get("spec_tokens", 0)
        first = len(f_prompts)
        return (st["dispatches"] / (emitted + first),
                emitted / (wall - st["prefill_seconds"]))

    def judged(tag, what, want, got, tie=NEAR_TIE):
        """Print how ``got`` diverges from ``want`` (each first divergence
        by its float32 margin); returns the divergences at or above ``tie``."""
        margins = []
        differ, ties, bad = diverging_requests(torch, infer, params, cfg32, f_prompts, want,
                                               got, tie=tie, margins=margins)
        print(f"[11{tag}] {what}: {differ} of {len(want)} requests differ; first-divergence "
              f"margins {[f'{m:.3e}' for m in margins]}; {ties} below {tie}, {bad} not")
        return bad

    # -- (a) speculation over the dense store --
    _, plain_st, plain_wall, _ = serve("plain decode_block=1", decode_block=1)
    dpt, tps = rates(plain_st, plain_wall)
    out["plain_db1"] = dict(dispatches_per_token=dpt, tokens_per_s=tps, wall_s=plain_wall)
    print(f"[11a] plain decode_block=1: {plain_st['dispatches']} dispatches, {dpt:.3f} per "
          f"emitted token; wall {plain_wall:.2f} s, decode {tps:.1f} tokens/s (emitted over "
          f"wall - prefill)")
    for draft in ("ngram", "order1"):
        toks, st, wall, _ = serve(f"speculative {draft}", sched=SchedulerPolicy(
            speculative_k=SPEC_K, speculative_draft=draft))
        dpt, tps = rates(st, wall)
        accept = st["spec_accepted"] / max(st["spec_drafted"], 1)
        out[draft] = dict(spec_rounds=st["spec_rounds"], acceptance=accept,
                          full_accepts=st.get("spec_full_accepts", 0),
                          rollbacks=st.get("spec_rollbacks", 0),
                          draft_dispatches=st.get("draft_dispatches", 0),
                          dispatches_per_token=dpt, wall_s=wall, tokens_per_s=tps,
                          verify_s=st.get("verify_seconds", 0.0),
                          draft_s=st.get("draft_seconds", 0.0))
        print(f"[11a] {draft} k={SPEC_K}: spec_rounds {st['spec_rounds']}, acceptance "
              f"{st['spec_accepted']}/{st['spec_drafted']} = {accept:.3f}, full accepts "
              f"{st.get('spec_full_accepts', 0)}, rollbacks {st.get('spec_rollbacks', 0)}, "
              f"draft_dispatches {st.get('draft_dispatches', 0)} ({st.get('draft_tokens', 0)} "
              f"tokens), verify_tokens {st['verify_tokens']}, spec_tokens {st['spec_tokens']}, "
              f"decode_tokens {st.get('decode_tokens', 0)}; {st['dispatches']} dispatches = "
              f"{dpt:.3f} per emitted token; wall {wall:.2f} s (prefill "
              f"{st['prefill_seconds']:.2f}, verify {st.get('verify_seconds', 0):.2f}, draft "
              f"{st.get('draft_seconds', 0):.2f}, decode {st.get('decode_seconds', 0):.2f}), "
              f"decode {tps:.1f} tokens/s")
        if not (st["spec_rounds"] > 0 and st["spec_accepted"] > 0):
            fail(f"[11a] {draft}: no speculative round accepted a draft")
        if judged("a", f"{draft} tokens vs phase 6's plain tokens", f_outs, toks):
            fail(f"[11a] {draft}: tokens differ from plain decode beyond a near-tie")

    # -- (b) int8 and fp8 order-2 moments --
    quant = {}
    for sd in ("int8", "fp8"):
        toks, st, wall, eng = serve(f"state_dtype={sd}", state_dtype=sd)
        slot = eng.slot_state_bytes
        dpt, tps = rates(st, wall)
        quant[sd] = toks
        out[sd] = dict(slot_bytes=slot, ratio=slot / dense_slot_bytes, tokens_per_s=tps,
                       wall_s=wall)
        print(f"[11b] state_dtype={sd}: slot_state_bytes {slot} vs dense {dense_slot_bytes} "
              f"= {slot / dense_slot_bytes:.4f}; wall {wall:.2f} s, decode {tps:.1f} tokens/s "
              f"(phase 6's requests, decode_block 16)")
        judged("b", f"{sd} tokens vs phase 6's dense tokens (reported, not checked)", f_outs,
               toks)
        # a live slot: the 700-token request's prefill state
        store = eng.state_store
        _, dense = prefill(params, {"tokens": f_prompts[-1].cuda()[None]}, cfg32, N_MAX)
        caches = store.write_slot(eng.caches, dense, 0)
        snap = store.read_slot(caches, 0)
        caches = store.write_slot(caches, snap, 0)
        again = store.read_slot(caches, 0)
        exact = all(torch.equal(a, b) for a, b in zip(tree_leaves(again), tree_leaves(snap)))
        codec = QuantizedCodec(cfg=cfg32, max_slots=1, n_max=N_MAX,
                               device=torch.device("cuda"), qdtype=sd)
        on_card = tree_leaves(codec.encode(dense))
        on_cpu = tree_leaves(codec.encode(tree_map(lambda x: x.cpu(), dense)))

        def bits(x):
            return x.view(torch.uint8) if x.dtype == torch.float8_e4m3fn else x

        same = sum(torch.equal(bits(a).cpu(), bits(b)) for a, b in zip(on_card, on_cpu))
        print(f"[11b] {sd} one live slot (700-token prefill): decode→encode→decode "
              f"bit-exact {exact}; payload and scale leaves equal to the CPU's bit for bit "
              f"{same}/{len(on_cpu)}")
        if not exact or same != len(on_cpu):
            fail(f"[11b] {sd}: the round trip or the card's encoding is not bit-exact")
        del eng, caches, snap, again, dense
    # teacher-forced logit MAE of per-token quantised state (the JAX package's
    # harness): one request, the dense decode's tokens fed to both
    prompt = f_prompts[0].cuda()[None]
    logits, ref = prefill(params, {"tokens": prompt}, cfg32, N_MAX)
    states = {sd: ref for sd in ("int8", "fp8")}
    codecs = {sd: QuantizedCodec(cfg=cfg32, max_slots=1, n_max=N_MAX,
                                 device=torch.device("cuda"), qdtype=sd) for sd in states}
    states = {sd: codecs[sd].decode(codecs[sd].encode(ref)) for sd in states}
    tok, mae = logits.argmax(-1), {sd: [] for sd in states}
    for t in range(QUANT_STEPS):
        pos = prompt.shape[1] + t
        lg, ref = lm_decode_step(params, tok, ref, pos, cfg32)
        for sd, c in codecs.items():
            lq, sq = lm_decode_step(params, tok, states[sd], pos, cfg32)
            states[sd] = c.decode(c.encode(sq))
            mae[sd].append(float((lq - lg).abs().mean()))
        tok = lg.argmax(-1)
    for sd, m in mae.items():
        out[sd]["mae_max"] = max(m)
        print(f"[11b] {sd} teacher-forced logit MAE over {QUANT_STEPS} steps of the "
              f"{prompt.shape[1]}-token request, state re-quantised after every token: max "
              f"{max(m):.4f}, last {m[-1]:.4f} (the JAX package's reduced-size bound "
              f"{QUANT_MAE_BOUND[sd]}; informational)")
    del states, ref

    # -- (c) paged KV on phase 8's softmax serving --
    peak = {"pages": 0, "bytes": 0}

    def track(eng):
        peak["pages"] = max(peak["pages"], eng.state_store.allocator.used_pages)
        peak["bytes"] = max(peak["bytes"], eng.live_state_bytes)

    toks, st, wall, eng = serve("paged softmax", cfg=softmax32, kv_page_size=KV_PAGE,
                                step_hook=track)
    alloc = eng.state_store.allocator
    dense_kv = lm_state_bytes(softmax32, 4, N_MAX)
    identical = all(np.array_equal(a, np.asarray(b)) for a, b in zip(toks, softmax_tokens))
    dpt, tps = rates(st, wall)
    out["paged"] = dict(peak_pages=peak["pages"], total_pages=alloc.total_pages,
                        peak_live_bytes=peak["bytes"], dense_bytes=dense_kv,
                        end_pages=alloc.used_pages, tokens_per_s=tps, wall_s=wall)
    print(f"[11c] softmax f32 kv_page_size={KV_PAGE}: tokens identical to phase 8's dense "
          f"run {identical}; pages in use at the end {alloc.used_pages}; peak pages "
          f"{peak['pages']} of {alloc.total_pages} (dense: 4 x {alloc.pages_per_slot}); peak "
          f"live bytes {peak['bytes']} vs dense KV {dense_kv} = {peak['bytes'] / dense_kv:.4f}; "
          f"wall {wall:.2f} s, decode {tps:.1f} tokens/s")
    if not identical:
        fail("[11c] paged softmax tokens differ from the dense run's")
    if alloc.used_pages:
        fail(f"[11c] {alloc.used_pages} pages still allocated after the run")
    del eng

    # -- (d) speculation over int8 moments --
    toks, st, wall, _ = serve("int8 + ngram", state_dtype="int8", sched=SchedulerPolicy(
        speculative_k=SPEC_K, speculative_draft="ngram"))
    dpt, tps = rates(st, wall)
    out["int8_ngram"] = dict(spec_rounds=st["spec_rounds"],
                             acceptance=st["spec_accepted"] / max(st["spec_drafted"], 1),
                             rollbacks=st.get("spec_rollbacks", 0), dispatches_per_token=dpt,
                             tokens_per_s=tps, wall_s=wall)
    print(f"[11d] int8 + ngram k={SPEC_K}: spec_rounds {st['spec_rounds']}, acceptance "
          f"{out['int8_ngram']['acceptance']:.3f}, rollbacks {st.get('spec_rollbacks', 0)} "
          f"(each a write_slot of a dequantised snapshot); {dpt:.3f} dispatches per emitted "
          f"token; wall {wall:.2f} s, decode {tps:.1f} tokens/s")
    what = "int8 + ngram tokens vs (b)'s int8 plain tokens"
    judged("d", what, quant["int8"], toks)  # the near-tie count, reported
    if judged("d", what, quant["int8"], toks, tie=INT8_FLIP_MARGIN):
        fail(f"[11d] int8 speculative tokens diverge from int8 plain decode at a margin "
             f"above {INT8_FLIP_MARGIN}")

    print(f"[11] taylor_fwd launches over phase 11's serving runs: {out['launches']} (verify, "
          f"draft, rollback and the codecs run the torch moment-state paths)")
    if out["launches"]:
        fail(f"[11] serving launched taylor_fwd {out['launches']} times")
    return out


@contextlib.contextmanager
def forced_routing(torch, moe, layers):
    """Two forwards of an MoE model of ``layers`` MoE layers with the first
    one's routing: inside this context the first forward records each
    ``moe._route`` call's experts, and the second takes those experts with
    gates from its own router (its probabilities at them, renormalised), so
    the two differ only continuously.  Yields a dict that ends up holding
    ``flips``, the (token, layer) pairs whose own top-k differed, and
    ``flip_gap``, the largest gap between the k-th and (k+1)-th router
    probabilities of the first forward at those pairs (0 without a flip)."""
    orig, calls = moe._route, []
    out = dict(flips=0, flip_gap=0.0, replayed=0)

    def route(params, x, m):
        gates, idx, aux = orig(params, x, m)
        probs = torch.softmax(x.float() @ params["router"]["w"], dim=-1)
        if len(calls) < layers:
            top = probs.sort(dim=-1, descending=True).values
            calls.append((idx, top[:, m.top_k - 1] - top[:, m.top_k]))
            return gates, idx, aux
        want, gap = calls[out["replayed"]]
        out["replayed"] += 1
        flip = (idx.sort(dim=-1).values != want.sort(dim=-1).values).any(dim=-1)
        out["flips"] += int(flip.sum())
        if flip.any():
            out["flip_gap"] = max(out["flip_gap"], float(gap[flip].max()))
        gates = probs.gather(1, want)
        return gates / gates.sum(dim=-1, keepdim=True), want, aux

    moe._route = route
    try:
        yield out
    finally:
        moe._route = orig


def zoo_forward(torch, K, infer, params, cfg, tokens, tag, moe=None):
    """An inference forward through the kernels (bf16): its launches
    against ``kernel_layers``, the logits against attn_impl="torch" with
    phase 4's tolerances (bf16 5e-2, f32 1e-3), and both forwards' times.
    With ``moe`` (the MoE module), the bf16 torch forward takes the kernel
    forward's routing (``forced_routing``): a top-k flip between two bf16
    runs is a discontinuity, not an error of the attention; the flips are
    counted and the unforced error printed beside the checked one."""
    expect = kernel_layers(torch, cfg)
    tcfg = cfg.replace(attn_impl="torch")
    layers = cfg.n_groups * cfg.pattern.count("moe") + cfg.tail.count("moe")
    with forced_routing(torch, moe, layers) if moe else contextlib.nullcontext() as flips:
        K.taylor_fwd.launches = 0
        logits, _ = infer(params, {"tokens": tokens}, cfg)
        torch.cuda.synchronize()
        launches = K.taylor_fwd.launches
        if launches != expect:
            fail(f"{tag} lm_apply launched taylor_fwd {launches} times, expected {expect}")
        if logits.shape != tokens.shape + (cfg.vocab,) or not torch.isfinite(logits).all():
            fail(f"{tag} lm_apply logits have the wrong shape or are not finite")
        err = rel_err(torch, logits, infer(params, {"tokens": tokens}, tcfg)[0])
    forced = ""
    if moe:
        free = rel_err(torch, logits, infer(params, {"tokens": tokens}, tcfg)[0])
        forced = (f" with the kernel forward's routing ({flips['flips']} (token, layer) "
                  f"top-k flips, largest top-k probability gap among them "
                  f"{flips['flip_gap']:.3e}; each router choosing for itself {free:.3e})")
    del logits
    cfg32 = cfg.replace(dtype="float32")
    err32 = rel_err(torch, infer(params, {"tokens": tokens}, cfg32)[0],
                    infer(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
    ms = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 2)
    torch_ms = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, tcfg), 2)
    print(f"{tag} lm_apply {cfg.name} b,n={tuple(tokens.shape)} {cfg.dtype}: taylor_fwd "
          f"launches={launches}; logits vs attn_impl='torch' rel_err={err:.3e} (tol 5e-2)"
          f"{forced}, float32 {err32:.3e} (tol 1e-3); forward_ms={ms:.2f} "
          f"forward_ms(torch attention)={torch_ms:.2f}")
    if not (err < 5e-2 and err32 < 1e-3):
        fail(f"{tag} kernel forward disagrees with the torch forward: {err}, {err32}")
    return dict(launches=launches, rel_err=err, rel_err_f32=err32, forward_ms=ms,
                torch_forward_ms=torch_ms, **({"top_k_flips": flips["flips"]} if moe else {}))


def zoo_train(torch, K, cfg, steps, tag, extras=None, b=None, opt=None):
    """``steps`` training steps at phase 7's batch and schedule (its first
    ``b`` rows, all by default), from a state drawn on the card's generator
    (seed 0), with ``extras`` (tensors on the card) beside the tokens, under
    ``opt`` (default AdamW).  Returns the summary."""
    from repro_torch.data import make_task
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import make_train_step, train_state_init

    opt = opt or adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], steps))
    batch = {k_: x[:b] for k_, x in bigram_batch(torch, make_task, cfg).items()}
    batch.update(extras or {})
    # the functional AdamW holds ~9 copies of the params at its peak (params,
    # grads, clipped grads, m, v and their successors, the updates), 55-66 GiB
    # here: free what earlier parts left (engines are freed by the cyclic GC)
    gc.collect()
    torch.cuda.empty_cache()
    init = lambda: train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt)
    state, losses, times, launches, peak = train_steps(
        torch, K, cfg, init, make_train_step(cfg, opt), batch, steps, tag)
    del state
    steady = sum(times[1:]) / (len(times) - 1)
    rows = batch["tokens"].shape[0]
    tokens = rows * TRAIN["n"]
    out = dict(losses=losses, first_step_ms=times[0] * 1e3, step_ms=steady * 1e3,
               tokens_per_s=tokens / steady, peak_gib=peak / 2**30, launches=launches)
    print(f"{tag} {cfg.name} training {cfg.dtype} remat={cfg.remat} b={rows} "
          f"n={TRAIN['n']}: loss {losses[0]:.4f} -> {losses[-1]:.4f}; first step "
          f"{out['first_step_ms']:.1f} ms, then {out['step_ms']:.1f} ms/step = "
          f"{out['tokens_per_s']:.0f} tokens/s; peak memory {out['peak_gib']:.2f} GiB; "
          f"launches {launches}")
    return out


def zoo_serve(torch, K, infer, params, cfg, lens, max_slots, tag, extras=None):
    """f32 serving of prompts ``lens`` on ``max_slots`` slots (each request
    with its ``extras``), every token against the ``lm_apply`` argmax
    (phase 6's near-tie rule) and against the model's own prefill + decode
    path.  Returns the summary."""
    from repro_torch.models import lm_decode_step, lm_prefill
    from repro_torch.serve import Request, ServeEngine, slots

    cfg32 = cfg.replace(dtype="float32")
    prompts, outs, st, wall, cache = serve_requests(torch, ServeEngine, Request, params, cfg32,
                                                    lens, max_slots, extras)
    mismatches, ties = cross_check(torch, infer, params, cfg32, prompts, outs, extras)
    own, own_ties = cross_check_decode(torch, lm_prefill, lm_decode_step, slots, params,
                                       cfg32, prompts, outs, extras)
    tps = st["decode_tokens"] / st["decode_seconds"]
    print(f"{tag} {cfg.name} f32 serving of {len(outs)} requests x {MAX_NEW} tokens (prompts "
          f"{list(lens)}) on {max_slots} slots in {wall:.2f} s: prefill "
          f"{st['prefill_seconds']:.3f} s, decode {tps:.1f} tokens/s; slot_state_bytes "
          f"{cache['slot_bytes']} ({cache['runs']}); tokens vs lm_apply argmax: "
          f"mismatches={mismatches} near_ties={ties}; vs its own prefill + decode: "
          f"mismatches={own} near_ties={own_ties}")
    if mismatches or own:
        fail(f"{tag} {cfg.name}: engine tokens differ from the model's argmax")
    return dict(decode_tokens_per_s=tps, prefill_s=st["prefill_seconds"], wall_s=wall,
                slot_bytes=cache["slot_bytes"], near_ties=ties, tokens=outs)


def zoo_params(torch, cfg):
    """Random weights of ``cfg`` from seed 0, drawn on the card's generator
    (a CPU draw of billions of parameters takes minutes)."""
    from repro_torch.models import lm_init

    return lm_init(torch.Generator(device="cuda").manual_seed(0), cfg)


def phase_zoo(torch, K, ref_mod, ln, infer):
    """Phase 12: the model zoo's dense and MoE decoders at their published
    widths.  (a) qwen2-1.5b, the full model: forward, 6 training steps and
    4-slot f32 serving through the kernels at head dim 128; (b) the three
    kernels at the training launches of (a), (c), (e) and (f) against their
    plain versions; (c) granite-20b (MQA, GELU MLP) at ZOO_DEPTH's depth:
    forward, 2 training steps, 4 requests; (d) gemma-7b (head dim 256,
    outside the kernels' envelope: the torch paths, 0 launches) serving 2
    requests; (e) qwen2-moe-a2.7b: dense vs capacity dispatch with ample
    capacity, the forward, 4 requests, 2 training steps on the capacity path
    at the published capacity; (f) ``zoo_scripts``."""
    from repro_torch import serve_longcontext, train_resume
    from repro_torch.configs import get_config
    from repro_torch.models import moe

    out = {}
    tokens_of = lambda cfg: torch.randint(0, cfg.vocab, (TRAIN["b"], TRAIN["n"]),
                                          generator=torch.Generator().manual_seed(0)).cuda()

    # (a) qwen2-1.5b at full width
    cfg = get_config("qwen2-1.5b")
    params = zoo_params(torch, cfg)
    q = dict(forward=zoo_forward(torch, K, infer, params, cfg, tokens_of(cfg), "[12a]"))
    q["serve"] = zoo_serve(torch, K, infer, params, cfg, PROMPT_LENS, 4, "[12a]")
    del params
    q["train"] = zoo_train(torch, K, cfg, ZOO_TRAIN_STEPS["qwen2-1.5b"], "[12a]")
    if not q["train"]["losses"][-1] < q["train"]["losses"][0]:
        fail(f"[12a] qwen2-1.5b loss did not fall: {q['train']['losses']}")
    out["qwen2-1.5b"] = q

    # (b) the three kernels at the zoo's training launches (ZOO_ATTN)
    kgen = torch.Generator(device="cuda").manual_seed(12)
    out["cases"] = {}
    for m, dname in ZOO_CASES:
        row = bwd_case(torch, K, ref_mod, ln, kgen, m, dname, tag="[12b]")
        row["taylor_fwd"] = fwd_case(torch, K, ref_mod, ln, kgen, m, dname, tag="[12b]")
        out["cases"][case_name(m, dname)] = dict(row, shape=dict(m, dtype=dname))

    # (c) granite-20b, depth cut
    cfg = get_config("granite-20b", n_groups=ZOO_DEPTH["granite-20b"])
    params = zoo_params(torch, cfg)
    g = dict(forward=zoo_forward(torch, K, infer, params, cfg, tokens_of(cfg), "[12c]"))
    g["serve"] = zoo_serve(torch, K, infer, params, cfg, PROMPT_LENS[:4], 4, "[12c]")
    del params
    g["train"] = zoo_train(torch, K, cfg, ZOO_TRAIN_STEPS["granite-20b"], "[12c]")
    out["granite-20b"] = g

    # (d) gemma-7b, depth cut: head dim 256 runs the torch paths
    cfg = get_config("gemma-7b", n_groups=ZOO_DEPTH["gemma-7b"])
    if kernel_layers(torch, cfg):
        fail("[12d] gemma-7b's head dim 256 would reach the kernels")
    params = zoo_params(torch, cfg)
    K.taylor_fwd.launches = 0
    out["gemma-7b"] = zoo_serve(torch, K, infer, params, cfg, GEMMA_LENS, 2, "[12d]")
    print(f"[12d] taylor_fwd launches over gemma-7b's serving and checks: "
          f"{K.taylor_fwd.launches}")
    if K.taylor_fwd.launches:
        fail(f"[12d] gemma-7b launched taylor_fwd {K.taylor_fwd.launches} times")
    del params

    # (e) qwen2-moe-a2.7b, depth cut
    cfg = get_config("qwen2-moe-a2.7b", n_groups=ZOO_DEPTH["qwen2-moe-a2.7b"])
    params = zoo_params(torch, cfg)
    m = cfg.moe
    ample = dataclasses.replace(m, capacity_factor=m.n_experts / m.top_k)
    x = torch.randn(1, MOE_TOKENS, cfg.d_model, device="cuda", generator=kgen)
    p0 = params["blocks"][0]["moe"]
    with torch.no_grad():
        run = {impl: (lambda c=cfg.replace(moe=dataclasses.replace(ample, impl=impl)):
                      moe.moe_apply(p0, x, c)) for impl in ("dense", "ep")}
        (yd, ad), (ye, ae) = run["dense"](), run["ep"]()
        moe_ms = {impl: cuda_ms(torch, fn, 3) for impl, fn in run.items()}
    err, aux_rel = float((yd - ye).abs().max()), float((ad - ae).abs() / ad.abs())
    print(f"[12e] qwen2-moe-a2.7b layer 0 MoE, {MOE_TOKENS} f32 tokens, capacity_factor "
          f"{ample.capacity_factor} (nothing dropped): dense vs ep max_abs_err={err:.3e} "
          f"(atol {MOE_TOL}), aux rel_err={aux_rel:.3e} (rtol 1e-5); ms dense "
          f"{moe_ms['dense']:.2f}, ep {moe_ms['ep']:.2f}")
    if not (err < MOE_TOL and aux_rel < 1e-5):
        fail(f"[12e] dense and capacity dispatch disagree: {err}, aux {aux_rel}")
    e = dict(dense_vs_ep_err=err, moe_ms=moe_ms)
    e["forward"] = zoo_forward(torch, K, infer, params, cfg, tokens_of(cfg), "[12e]", moe)
    e["serve"] = zoo_serve(torch, K, infer, params, cfg, PROMPT_LENS[:4], 4, "[12e]")
    del params, p0, run
    ep_cfg = cfg.replace(moe=dataclasses.replace(m, impl="ep"))
    e["train"] = zoo_train(torch, K, ep_cfg, ZOO_TRAIN_STEPS["qwen2-moe-a2.7b"], "[12e]")
    out["qwen2-moe-a2.7b"] = e

    # (f) the ported scripts, on the card
    out["scripts"] = zoo_scripts(torch, K, train_resume, serve_longcontext)
    return out


def zoo_scripts(torch, K, train_resume, serve_longcontext):
    """Phase 12 (f): ``repro_torch.train_resume`` (its launches counted
    against its steps) and ``repro_torch.serve_longcontext`` (serving: no
    launch) on the card; then the reduced qwen2-1.5b's f32 gradients at
    train_resume's batch through the kernels against the torch recompute,
    as phase 7 holds the full model's."""
    from repro_torch.configs import get_reduced
    from repro_torch.data import make_task
    from repro_torch.models import lm_init
    from repro_torch.train import loss_and_grads, make_loss_fn
    from repro_torch.tree import tree_leaves

    cfg = get_reduced("qwen2-1.5b")
    # the uninterrupted run, then the run stopped part way and its resumption
    steps = 2 * train_resume.STEPS
    expect = tuple(steps * x for x in kernel_launches_per_step(torch, cfg))
    t0 = time.perf_counter()
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    divergence = train_resume.main([])
    torch.cuda.synchronize()
    launches = taylor_counters(K)
    growth, (loop_tps, engine_tps, slot_bytes) = serve_longcontext.main([])
    torch.cuda.synchronize()
    serve_launches = tuple(a - b for a, b in zip(taylor_counters(K), launches))
    wall = time.perf_counter() - t0
    print(f"[12f] train_resume: max param divergence {divergence:.2e} (< 1e-5), launches "
          f"fwd,dq,dkv={launches} over {steps} steps (expected {expect}); serve_longcontext: "
          f"engine {engine_tps:.0f} vs per-token loop {loop_tps:.0f} tokens/s, launches "
          f"{serve_launches}; both in {wall:.1f} s")
    if launches != expect:
        fail(f"[12f] train_resume launched (fwd, dq, dkv) = {launches}, expected {expect}")
    if any(serve_launches):
        fail(f"[12f] serve_longcontext launched (fwd, dq, dkv) = {serve_launches}")

    task = make_task("bigram", cfg.vocab, train_resume.SEQ_LEN, train_resume.BATCH, seed=0)
    batch = {k_: torch.from_numpy(x).cuda() for k_, x in task.batch_at(0).items()}
    params = lm_init(torch.Generator().manual_seed(0), cfg, device="cuda")
    c0 = taylor_counters(K)
    grads = {impl: loss_and_grads(make_loss_fn(cfg.replace(attn_impl=impl)), params,
                                  batch)[2] for impl in ("cuda", "torch")}
    if taylor_counters(K)[2] == c0[2]:
        fail("[12f] the reduced gradient check did not run the backward kernels")
    errs = [rel_err(torch, a, b) for a, b in zip(tree_leaves(grads["cuda"]),
                                                 tree_leaves(grads["torch"]))]
    worst = max(errs)
    print(f"[12f] reduced qwen2-1.5b float32 gradients at b,n=({train_resume.BATCH}, "
          f"{train_resume.SEQ_LEN}), kernels vs torch recompute, over {len(errs)} leaves: "
          f"max rel_err {worst:.3e} (tol 1e-3)")
    if not worst < 1e-3:
        fail(f"[12f] reduced kernel gradients disagree with the torch recompute: {worst}")
    return dict(resume_divergence=divergence, steps=steps,
                launches=dict(zip(("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv"), launches)),
                grad_rel_err=worst, loop_tokens_per_s=loop_tps,
                engine_tokens_per_s=engine_tps, slot_bytes=slot_bytes, growth=growth)


def ssd_recurrence_check(torch, params, cfg, tag):
    """Layer 0's chunked SSD (``mamba_apply``, chunk ``cfg.attn_chunk``)
    against its own token recurrence (``mamba_decode_step`` token after
    token) over SSD_RECURRENCE tokens in float32: two independent forms of
    one SSM.  Returns the rel error."""
    from repro_torch.models.layers import norm_apply
    from repro_torch.models.ssm import mamba_apply, mamba_decode_step, mamba_init_cache

    cfg32 = cfg.replace(dtype="float32")
    p = params["blocks"][0]
    x = torch.randn(1, SSD_RECURRENCE, cfg.d_model, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(13))
    with torch.no_grad():
        h = norm_apply(p["norm1"], x, cfg.norm, cfg.norm_eps)
        whole = mamba_apply(p["mamba"], h, cfg32, chunk=cfg.attn_chunk)
        cache, ys = mamba_init_cache(cfg32, 1, x.device), []
        for t in range(SSD_RECURRENCE):
            y, cache = mamba_decode_step(p["mamba"], h[:, t], cache, cfg32)
            ys.append(y)
    err = rel_err(torch, whole, torch.stack(ys, dim=1))
    print(f"{tag} {cfg.name} layer 0, float32: the chunked SSD (chunk {cfg.attn_chunk}) vs "
          f"its token recurrence over {SSD_RECURRENCE} tokens: rel_err={err:.3e} "
          f"(tol {SSD_TOL})")
    if not err < SSD_TOL:
        fail(f"{tag} the chunked SSD disagrees with its recurrence: {err}")
    return err


def ssm_forward(torch, K, infer, params, cfg, tokens, tag):
    """The attention-free forward (bf16): finite logits of the right shape,
    no Taylor launch, its time, and the bf16 logits' distance from float32's
    (reported).  Returns the summary."""
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    logits = infer(params, {"tokens": tokens}, cfg)[0]
    torch.cuda.synchronize()
    launches = taylor_counters(K)
    if logits.shape != tokens.shape + (cfg.vocab,) or not torch.isfinite(logits).all():
        fail(f"{tag} lm_apply logits have the wrong shape or are not finite")
    if any(launches):
        fail(f"{tag} the attention-free forward launched (fwd, dq, dkv) = {launches}")
    err32 = rel_err(torch, logits, infer(params, {"tokens": tokens},
                                         cfg.replace(dtype="float32"))[0])
    del logits
    ms = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 2)
    print(f"{tag} lm_apply {cfg.name} b,n={tuple(tokens.shape)} {cfg.dtype}: launches "
          f"(fwd, dq, dkv) = {launches}; bf16 logits vs float32 rel_err={err32:.3e} "
          f"(reported); forward_ms={ms:.2f}")
    return dict(launches=launches[0], forward_ms=ms, bf16_vs_f32=err32)


def check_state_bytes(cfg, serve, tag):
    """The engine's bytes per slot against ``lm_state_bytes`` (float32)."""
    from repro_torch.models import lm_state_bytes

    want = lm_state_bytes(cfg.replace(dtype="float32"), 1, N_MAX)
    print(f"{tag} {cfg.name} bytes per slot (float32 state) {serve['slot_bytes']:,}; "
          f"lm_state_bytes {want:,}")
    if serve["slot_bytes"] != want:
        fail(f"{tag} slot bytes {serve['slot_bytes']} != lm_state_bytes {want}")
    return want


def phase_ssm(torch, K, infer):
    """Phase 13: Mamba2 (SSD) at published widths.  (a) mamba2-780m, the
    whole model: its bf16 forward, layer 0's chunked SSD against its token
    recurrence, f32 serving of phase 6's requests (tokens against the
    ``lm_apply`` argmax and its own prefill + decode; bytes per slot against
    ``lm_state_bytes``), chunked-prefill serving against whole-prompt
    serving, 6 training steps; no Taylor launch anywhere.  (b) zamba2-7b
    whole: the forward through the kernels (11 shared-block launches at
    head dim 112 padded to 128, logits against attn_impl="torch"), f32
    serving of 4 requests, an int8 slot store whose mamba nodes stay dense
    byte for byte.  (c) zamba2-7b at SSM_TRAIN_GROUPS groups: training steps
    through the three kernels, then the shared block's float32 gradient
    through the kernels against the torch recompute.  (The kernels at
    zamba2's launch are phase 12 (b)'s ``ZOO_ATTN["zamba2-7b"]`` cases.)"""
    from repro_torch.configs import get_config
    from repro_torch.data import make_task
    from repro_torch.models import lm_prefill, schedule_runs
    from repro_torch.models.ssm import MambaCache
    from repro_torch.serve import Request, ServeEngine, slots
    from repro_torch.serve.state_repr import make_state_store
    from repro_torch.train import loss_and_grads, make_loss_fn
    from repro_torch.tree import tree_items

    out = {}
    tokens_of = lambda cfg: torch.randint(0, cfg.vocab, (TRAIN["b"], TRAIN["n"]),
                                          generator=torch.Generator().manual_seed(0)).cuda()
    gc.collect()
    torch.cuda.empty_cache()

    # (a) mamba2-780m, the whole model
    cfg = get_config("mamba2-780m")
    params = zoo_params(torch, cfg)
    a = dict(forward=ssm_forward(torch, K, infer, params, cfg, tokens_of(cfg), "[13a]"))
    a["ssd_vs_recurrence"] = ssd_recurrence_check(torch, params, cfg, "[13a]")
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    a["serve"] = zoo_serve(torch, K, infer, params, cfg, PROMPT_LENS, 4, "[13a]")
    a["state_bytes"] = check_state_bytes(cfg, a["serve"], "[13a]")
    cfg32 = cfg.replace(dtype="float32")
    lens, chunk = SSM_CHUNK
    runs = {}
    for name, kw in (("whole", {}), ("chunked", dict(prefill_chunk=chunk))):
        gen = torch.Generator().manual_seed(1)  # serve_requests' prompts
        prompts = [torch.randint(0, cfg.vocab, (n,), generator=gen) for n in lens]
        eng = ServeEngine(params, cfg32, max_slots=4, n_max=N_MAX, decode_block=16, **kw)
        rids = [eng.submit(Request(tokens=p.numpy(), max_new_tokens=MAX_NEW))
                for p in prompts]
        t0 = time.perf_counter()
        res = eng.run()
        torch.cuda.synchronize()
        check_no_faults(eng.stats(), f"[13a] {name} prefill")
        runs[name] = dict(tokens=[res[r] for r in rids], wall=time.perf_counter() - t0,
                          prefill_s=eng.stats()["prefill_seconds"])
        del eng
    differ, ties, bad = diverging_requests(torch, infer, params, cfg32, prompts,
                                           runs["whole"]["tokens"], runs["chunked"]["tokens"])
    launches = taylor_counters(K)
    print(f"[13a] chunked prefill (chunk {chunk}: each mamba block scans its token "
          f"recurrence) vs whole prefill (the chunked SSD), prompts {list(lens)}: {differ} "
          f"requests differ, {ties} at a near-tie (gap<{NEAR_TIE}), {bad} not; prefill "
          f"{runs['chunked']['prefill_s']:.3f} s vs {runs['whole']['prefill_s']:.3f} s; "
          f"launches (fwd, dq, dkv) over (a)'s serving: {launches}")
    if bad:
        fail(f"[13a] chunked-prefill tokens differ from whole-prefill tokens in {bad} requests")
    if any(launches):
        fail(f"[13a] mamba2-780m's serving launched the Taylor kernels {launches}")
    a["chunked"] = dict(differ=differ, near_ties=ties, chunked_prefill_s=runs["chunked"][
        "prefill_s"], whole_prefill_s=runs["whole"]["prefill_s"])
    del params, runs
    a["train"] = zoo_train(torch, K, cfg, SSM_TRAIN_STEPS["mamba2-780m"], "[13a]")
    if not a["train"]["losses"][-1] < a["train"]["losses"][0]:
        fail(f"[13a] mamba2-780m loss did not fall: {a['train']['losses']}")
    out["mamba2-780m"] = a

    # (b) zamba2-7b, the whole model: forward and serving
    cfg = get_config("zamba2-7b")
    params = zoo_params(torch, cfg)
    z = dict(forward=zoo_forward(torch, K, infer, params, cfg, tokens_of(cfg), "[13b]"))
    z["serve"] = zoo_serve(torch, K, infer, params, cfg, ZAMBA_LENS, 4, "[13b]")
    z["state_bytes"] = check_state_bytes(cfg, z["serve"], "[13b]")
    cfg32 = cfg.replace(dtype="float32")
    prompt = torch.randint(0, cfg.vocab, (ZAMBA_LENS[0],),
                           generator=torch.Generator().manual_seed(1)).cuda()
    _, one = lm_prefill(params, {"tokens": prompt[None]}, cfg32, N_MAX)
    store = make_state_store(cfg32, 4, N_MAX, state_dtype="int8")
    stored = store.write_slot(store.init_caches(), one, 1)
    raw, back = slots.read_slot(stored, 1), store.read_slot(stored, 1)  # stored; decoded
    nodes = lambda c: list(c["group"]) + list(c["tail"])
    dense = [(o, r, b_) for o, r, b_ in zip(nodes(one), nodes(raw), nodes(back))
             if isinstance(o, MambaCache)]
    same = all(torch.equal(r_, o_) and torch.equal(b_, o_)
               for o, r, b_ in dense for o_, r_, b_ in zip(o, r, b_))
    want = sum(k == "mamba" for k, _, _ in schedule_runs(cfg)) + cfg.tail.count("mamba")
    moments = [type(x.s2).__name__ for x in nodes(stored) if hasattr(x, "s2")]
    int8_bytes = store.slot_bytes(stored)
    print(f"[13b] int8 slot store: {len(dense)} mamba nodes (of {want}) stored dense and "
          f"byte-identical to the prefill's after write and read: {same}; moment S2 leaves "
          f"{sorted(set(moments))}; bytes per slot {int8_bytes:,} (dense "
          f"{z['state_bytes']:,})")
    if not (same and len(dense) == want and set(moments) == {"QuantizedLeaf"}):
        fail("[13b] the int8 store changed a mamba node or left a moment dense")
    z["int8_slot_bytes"] = int8_bytes
    del params, one, store, stored, back, dense

    # (c) zamba2-7b at SSM_TRAIN_GROUPS groups: training, the shared block's gradient
    cfg = get_config("zamba2-7b", n_groups=SSM_TRAIN_GROUPS)
    z["train"] = zoo_train(torch, K, cfg, SSM_TRAIN_STEPS["zamba2-7b"], "[13c]")
    if not z["train"]["losses"][-1] < z["train"]["losses"][0]:
        fail(f"[13c] zamba2-7b loss did not fall: {z['train']['losses']}")
    gc.collect()
    torch.cuda.empty_cache()
    params = zoo_params(torch, cfg)
    batch = bigram_batch(torch, make_task, cfg)
    cfg32 = cfg.replace(dtype="float32")
    c0 = taylor_counters(K)
    grads = {impl: dict(tree_items(loss_and_grads(make_loss_fn(cfg32.replace(attn_impl=impl)),
                                                  params, batch)[2]["shared"]))
             for impl in ("cuda", "torch")}
    got = tuple(a_ - b_ for a_, b_ in zip(taylor_counters(K), c0))
    errs = {path: rel_err(torch, grads["cuda"][path], grads["torch"][path])
            for path in grads["torch"]}
    worst = max(errs.values())
    print(f"[13c] zamba2-7b x{SSM_TRAIN_GROUPS} float32 gradients of the shared block "
          f"({len(errs)} leaves, summed over its {SSM_TRAIN_GROUPS} occurrences), kernels vs "
          f"torch recompute: max rel_err {worst:.3e} at {max(errs, key=errs.get)} (tol "
          f"{SHARED_GRAD_TOL}); kernel launches (fwd, dq, dkv) = {got}")
    if got != kernel_launches_per_step(torch, cfg):
        fail(f"[13c] the gradient check launched (fwd, dq, dkv) = {got}")
    if not worst < SHARED_GRAD_TOL:
        fail(f"[13c] the shared block's kernel gradient disagrees: {worst}")
    z["shared_grad_rel_err"] = worst
    out["zamba2-7b"] = z
    del params, grads
    return out


def source_extras(torch, cfg, b, seed, device="cuda"):
    """The family's source input for ``b`` rows from ``seed``:
    ``audio_frames`` [b, n_audio_ctx, d_model] (encdec) or ``image_embeds``
    [b, n_image_tokens, vision_dim] (vlm), float32 on ``device``.  Every
    entry is N(0, 1), half of its variance from one vector that all tokens
    of the row share, as the patch embeddings of one image share its
    content: with independent tokens the attention's average over 1500-1600
    of them cancels the source out (on one H100, two such images moved the
    full-width VLM's last logits by 0.14 of a 4.3 range and gave the same
    tokens; with a shared vector of unit variance, by 4.0)."""
    name, width = (("audio_frames", cfg.d_model) if cfg.family == "encdec"
                   else ("image_embeds", cfg.vision_dim))
    gen = torch.Generator(device=device).manual_seed(seed)
    shared = torch.randn((b, 1, width), generator=gen, device=device)
    own = torch.randn((b, cfg.n_source_tokens, width), generator=gen, device=device)
    return {name: (shared + own) * 0.5**0.5}


def request_extras(torch, cfg, n, seed):
    """One source per request (numpy arrays [1, ...], ``Request.extras``)."""
    rows = source_extras(torch, cfg, n, seed, device="cpu")
    return [{k: v[i:i + 1].numpy() for k, v in rows.items()} for i in range(n)]


def cross_forward(torch, K, infer, params, cfg, batch, tag):
    """The inference forward of a cross model (bf16): its logits' shape and
    finiteness, no Taylor launch (the kernels' envelope excludes cross
    models, as the reference's does), and its time."""
    K.taylor_fwd.launches = 0
    logits, _ = infer(params, batch, cfg)
    torch.cuda.synchronize()
    launches = K.taylor_fwd.launches
    tokens = batch["tokens"]
    if logits.shape != tokens.shape + (cfg.vocab,) or not torch.isfinite(logits).all():
        fail(f"{tag} lm_apply logits have the wrong shape or are not finite")
    del logits
    ms = cuda_ms(torch, lambda: infer(params, batch, cfg), 2)
    src = {k: tuple(v.shape) for k, v in batch.items() if k != "tokens"}
    print(f"{tag} lm_apply {cfg.name} b,n={tuple(tokens.shape)} {src} {cfg.dtype}: "
          f"taylor_fwd launches={launches} (attention on the torch paths: cross model); "
          f"forward_ms={ms:.2f}")
    if launches:
        fail(f"{tag} lm_apply of a cross model launched taylor_fwd {launches} times")
    return dict(launches=launches, forward_ms=ms)


def teacher_forced(torch, infer, params, cfg, tag):
    """tests/test_models.py's check at full width, float32: prefill of the
    first n - steps tokens, then the true tokens decoded one by one; every
    logit row against ``lm_apply`` over the whole sequence at atol = rtol =
    TEACHER_TOL."""
    from repro_torch.models import lm_decode_step, lm_prefill

    b, n, steps = TEACHER["b"], TEACHER["n"], TEACHER["steps"]
    tokens = torch.randint(0, cfg.vocab, (b, n), generator=torch.Generator().manual_seed(2)).cuda()
    batch = {"tokens": tokens, **source_extras(torch, cfg, b, 2)}
    full, _ = infer(params, batch, cfg)
    got, caches = lm_prefill(params, dict(batch, tokens=tokens[:, :n - steps]), cfg, n)
    rows = [(got, full[:, n - steps - 1])]
    for i in range(n - steps, n - 1):
        got, caches = lm_decode_step(params, tokens[:, i], caches, i, cfg)
        rows.append((got, full[:, i]))
    worst = max(float(((g - w).abs() - TEACHER_TOL * w.abs()).max()) for g, w in rows)
    diff = max(float((g - w).abs().max()) for g, w in rows)
    print(f"{tag} {cfg.name} f32 teacher-forced prefill of {n - steps} + {steps - 1} decode "
          f"steps vs lm_apply, b={b}: max |diff| {diff:.3e}, worst |diff| - rtol*|ref| "
          f"{worst:.3e} (atol = rtol = {TEACHER_TOL})")
    if not worst <= TEACHER_TOL:
        fail(f"{tag} prefill + decode disagrees with lm_apply: {worst}")
    return diff


def raises(fn, exc, match):
    """True when ``fn()`` raises ``exc`` with ``match`` in its message."""
    try:
        fn()
    except exc as e:  # the refusal under test
        return match in str(e)
    return False


def cross_store_check(torch, params, cfg32, exs, tag):
    """An int8 slot store: each cross pair's self moments quantised, its
    CrossCache and ``kv_src`` stored dense and byte-identical to the
    prefill's after write and read."""
    from repro_torch.backends.state import CrossCache
    from repro_torch.models import lm_prefill
    from repro_torch.serve import slots
    from repro_torch.serve.state_repr import make_state_store
    from repro_torch.tree import tree_leaves

    prompt = torch.randint(0, cfg32.vocab, (WHISPER_LENS[0],),
                           generator=torch.Generator().manual_seed(1)).cuda()
    _, one = lm_prefill(params, {"tokens": prompt[None], **on_card(torch, exs[0])}, cfg32, N_MAX)
    store = make_state_store(cfg32, 4, N_MAX, state_dtype="int8")
    stored = store.write_slot(store.init_caches(), one, 1)
    raw, back = slots.read_slot(stored, 1), store.read_slot(stored, 1)
    pairs = [i for i, x in enumerate(one["group"]) if isinstance(x, tuple)
             and isinstance(x[1], CrossCache)]
    layers = sum(tree_leaves(one["group"][i][1])[0].shape[0]
                 * tree_leaves(one["group"][i][1])[0].shape[1] for i in pairs)
    same = all(torch.equal(o, r) and torch.equal(o, b_)
               for i in pairs for o, r, b_ in zip(tree_leaves(one["group"][i][1]),
                                                  tree_leaves(raw["group"][i][1]),
                                                  tree_leaves(back["group"][i][1])))
    same = same and torch.equal(one["kv_src"], raw["kv_src"]) and torch.equal(
        one["kv_src"], back["kv_src"])
    moments = sorted({type(stored["group"][i][0].s2).__name__ for i in pairs})
    print(f"{tag} int8 slot store: CrossCache of {layers} layers and kv_src "
          f"{tuple(one['kv_src'].shape)} stored dense and byte-identical after write and "
          f"read: {same}; self-moment S2 leaves {moments}; bytes per slot "
          f"{store.slot_bytes(stored):,}")
    if not (same and layers == cfg32.n_groups and moments == ["QuantizedLeaf"]):
        fail(f"{tag} the int8 store changed a CrossCache or kv_src, or left a moment dense")
    return store.slot_bytes(stored)


def phase_cross(torch, K, infer):
    """Phase 14: the cross-attention families at published widths, through
    the torch paths (the kernels' envelope excludes cross models, as the
    reference's Pallas envelope does).  (a) whisper-medium whole: its bf16
    forward at b = 4 with audio frames [4, 1500, 1024], a float32
    teacher-forced prefill + decode against ``lm_apply``, f32 serving of 4
    requests each with its own frames (tokens against the argmax and its
    own decode; bytes per slot against the reference's 837,012,480), an
    int8 store and an int8 engine run, 6 training steps.  (b) whisper on
    its softmax baseline: 2 requests through the KV cross state.  (c)
    llama-3.2-vision-11b whole: the bf16 forward at b = 2 with images [2,
    1600, 1280], f32 serving of 2 requests (3,298,166,272 B a slot), one
    prompt under two images, a too-long image rejected with bad_extras.
    (d) the VLM at VLM_TRAIN_GROUPS group: training steps.  (e) The
    envelope: "auto" picks the torch paths on the card for both, a forced
    "cuda" raises.  No Taylor kernel launches anywhere."""
    import numpy as np

    from repro_torch.backends import get_backend, resolve_backend
    from repro_torch.configs import get_config
    from repro_torch.models import count_params, lm_state_bytes
    from repro_torch.serve import Request, RequestRejected, ServeEngine, generate

    out, launches = {}, {}
    gc.collect()
    torch.cuda.empty_cache()

    # (e) the envelope
    taylor, card = get_backend("taylor"), torch.device("cuda")
    env = {arch: (taylor.resolve_impl(get_config(arch), card),
                  raises(lambda a=arch: resolve_backend(get_config(arch, attn_impl="cuda")),
                         ValueError, "cross"))
           for arch in CROSS_ARCHS}
    print(f"[14e] taylor resolve_impl under 'auto' on the card, and a forced 'cuda' refused "
          f"naming cross: {env}")
    if any(v != ("torch", True) for v in env.values()):
        fail(f"[14e] the kernels' envelope does not exclude the cross models: {env}")
    out["envelope"] = env
    for arch in CROSS_ARCHS:
        n = count_params(get_config(arch))
        if n != CROSS_PARAMS[arch]:
            fail(f"[14] {arch} has {n} params, the reference {CROSS_PARAMS[arch]}")

    # (a) whisper-medium, the whole model
    cfg = get_config("whisper-medium")
    cfg32 = cfg.replace(dtype="float32")
    params = zoo_params(torch, cfg)
    tokens = torch.randint(0, cfg.vocab, (CROSS_FWD_B[cfg.name], TRAIN["n"]),
                           generator=torch.Generator().manual_seed(0)).cuda()
    batch = {"tokens": tokens, **source_extras(torch, cfg, CROSS_FWD_B[cfg.name], 0)}
    a = dict(params=CROSS_PARAMS[cfg.name], forward=cross_forward(torch, K, infer, params, cfg,
                                                                  batch, "[14a]"))
    del batch
    a["teacher_forced_max_diff"] = teacher_forced(torch, infer, params, cfg32, "[14a]")
    exs = request_extras(torch, cfg, len(WHISPER_LENS), 1)
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    a["serve"] = zoo_serve(torch, K, infer, params, cfg, WHISPER_LENS, 4, "[14a]", exs)
    a["state_bytes"] = check_state_bytes(cfg, a["serve"], "[14a]")
    kv_src = cfg.n_audio_ctx * cfg.d_model * 4
    print(f"[14a] of which kv_src {kv_src:,} B (the encoder output, f32); the reference's "
          f"lm_state_bytes {CROSS_SLOT_BYTES[cfg.name]:,}")
    if a["state_bytes"] != CROSS_SLOT_BYTES[cfg.name]:
        fail(f"[14a] bytes per slot {a['state_bytes']} != {CROSS_SLOT_BYTES[cfg.name]}")
    a["int8_store_slot_bytes"] = cross_store_check(torch, params, cfg32, exs, "[14a]")
    _, q_outs, q_st, _, q_cache = serve_requests(torch, ServeEngine, Request, params, cfg32,
                                                 WHISPER_LENS, 4, exs, state_dtype="int8")
    agree = sum(int(t == u) for o, w in zip(q_outs, a["serve"]["tokens"]) for t, u in zip(o, w))
    print(f"[14a] int8 engine: {agree} of {len(q_outs) * MAX_NEW} tokens equal the dense "
          f"engine's; decode {q_st['decode_tokens'] / q_st['decode_seconds']:.1f} tokens/s at "
          f"{q_cache['slot_bytes']:,} B per slot")
    a["int8"] = dict(agree=agree, slot_bytes=q_cache["slot_bytes"])

    # (b) whisper-medium on its softmax baseline: the KV cross state
    scfg = get_config("whisper-medium", backend="softmax")
    b_ = zoo_serve(torch, K, infer, params, scfg, WHISPER_SOFTMAX_LENS, 2, "[14b]",
                   exs[:len(WHISPER_SOFTMAX_LENS)])
    launches["whisper_serving"] = taylor_counters(K)
    print(f"[14a/b] launches (fwd, dq, dkv) over whisper's serving: {launches['whisper_serving']}")
    if any(launches["whisper_serving"]):
        fail(f"[14a] whisper's serving launched the Taylor kernels {launches['whisper_serving']}")
    del params
    a["train"] = zoo_train(torch, K, cfg, WHISPER_TRAIN_STEPS, "[14a]",
                           extras=source_extras(torch, cfg, TRAIN["b"], 3))
    if not a["train"]["losses"][-1] < a["train"]["losses"][0]:
        fail(f"[14a] whisper-medium loss did not fall: {a['train']['losses']}")
    out["whisper-medium"], out["whisper-medium-softmax"] = a, b_

    # (c) llama-3.2-vision-11b, the whole model: forward and serving
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama-3.2-vision-11b")
    cfg32 = cfg.replace(dtype="float32")
    params = zoo_params(torch, cfg)
    tokens = torch.randint(0, cfg.vocab, (CROSS_FWD_B[cfg.name], TRAIN["n"]),
                           generator=torch.Generator().manual_seed(0)).cuda()
    batch = {"tokens": tokens, **source_extras(torch, cfg, CROSS_FWD_B[cfg.name], 0)}
    c = dict(params=CROSS_PARAMS[cfg.name], forward=cross_forward(torch, K, infer, params, cfg,
                                                                  batch, "[14c]"))
    del batch
    exs = request_extras(torch, cfg, len(VLM_LENS), 1)
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    c["serve"] = zoo_serve(torch, K, infer, params, cfg, VLM_LENS, 2, "[14c]", exs)
    c["state_bytes"] = check_state_bytes(cfg, c["serve"], "[14c]")
    if c["state_bytes"] != CROSS_SLOT_BYTES[cfg.name]:
        fail(f"[14c] bytes per slot {c['state_bytes']} != {CROSS_SLOT_BYTES[cfg.name]}")
    prompt = torch.randint(0, cfg.vocab, (1, VLM_LENS[0]), generator=torch.Generator().manual_seed(4))
    two = {"tokens": prompt.expand(2, -1).cuda(), **source_extras(torch, cfg, 2, 4)}
    toks = generate(params, two, cfg32, steps=VLM_IMAGE_STEPS)
    differ = not torch.equal(toks[0], toks[1])
    print(f"[14c] one {VLM_LENS[0]}-token prompt under two images, {VLM_IMAGE_STEPS} tokens "
          f"each: {toks[0].tolist()} vs {toks[1].tolist()}; differ: {differ}")
    if not differ:
        fail("[14c] two images gave the same tokens")
    eng = ServeEngine(params, cfg32, max_slots=1, n_max=N_MAX)
    long_img = {"image_embeds": np.zeros((1, cfg.n_image_tokens + 4, cfg.vision_dim),
                                         np.float32)}
    try:
        eng.submit(Request(tokens=prompt[0].numpy(), max_new_tokens=4, extras=long_img))
        reason = None
    except RequestRejected as e:  # the rejection under test
        reason = e.reason
    print(f"[14c] a request whose image is 4 tokens too long: rejected with {reason!r}")
    if reason != "bad_extras":
        fail(f"[14c] a too-long image was not rejected with bad_extras: {reason}")
    del eng, params, two
    launches["vlm_serving"] = taylor_counters(K)
    if any(launches["vlm_serving"]):
        fail(f"[14c] the VLM's serving launched the Taylor kernels {launches['vlm_serving']}")

    # (d) the VLM at VLM_TRAIN_GROUPS group(s): training
    tcfg = get_config("llama-3.2-vision-11b", n_groups=VLM_TRAIN_GROUPS)
    c["train_params"] = count_params(tcfg)
    c["train"] = zoo_train(torch, K, tcfg, VLM_TRAIN["steps"], "[14d]",
                           extras=source_extras(torch, tcfg, VLM_TRAIN["b"], 3),
                           b=VLM_TRAIN["b"])
    if not math.isfinite(c["train"]["losses"][-1]):
        fail(f"[14d] the VLM's loss is not finite: {c['train']['losses']}")
    out["llama-3.2-vision-11b"] = c
    out["launches"] = launches
    return out


@contextlib.contextmanager
def launcher_steps(torch, K):
    """Times and counts each step the training launcher takes: wraps the
    ``make_train_step`` it calls; yields the list of (seconds, loss, (fwd,
    dq, dkv) launches) it appends to, one entry per step."""
    from repro_torch.launch import train as launch

    make, steps = launch.make_train_step, []

    def wrapped(cfg, opt, *args, **kwargs):
        step = make(cfg, opt, *args, **kwargs)

        def timed(state, batch):
            c0 = taylor_counters(K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            torch.cuda.synchronize()
            got = tuple(a - b for a, b in zip(taylor_counters(K), c0))
            steps.append((time.perf_counter() - t0, loss, got))
            return state, metrics

        return timed

    launch.make_train_step = wrapped
    try:
        yield steps
    finally:
        launch.make_train_step = make


def run_launcher(torch, K, argv, cfg, tag, check_fall=False):
    """``repro_torch.launch.train.main(argv)`` on the card with the kernels'
    counts set to 0 just before; fails unless every step launches
    ``kernel_launches_per_step(cfg)`` and has a finite loss.  With
    ``check_fall``, the final params' loss on the first step's batch must
    lie below the first step's loss there (the launcher draws a fresh batch
    each step, so its own losses over a few steps are noise around ln V).
    Returns (the final state, the summary)."""
    from repro_torch.data import make_task
    from repro_torch.launch import train as launch
    from repro_torch.train import make_loss_fn

    gc.collect()
    torch.cuda.empty_cache()
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with launcher_steps(torch, K) as steps:
        state = launch.main(argv)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    expect = kernel_launches_per_step(torch, cfg)
    for i, (_, loss, got) in enumerate(steps):
        if got != expect:
            fail(f"{tag} launcher step {i + 1} launched (fwd, dq, dkv) = {got}, expected "
                 f"{expect}")
        if not math.isfinite(loss):
            fail(f"{tag} launcher loss is not finite at step {i + 1}")
    times = [t for t, _, _ in steps]
    steady = times[1:] or times
    out = dict(losses=[l_ for _, l_, _ in steps], first_step_ms=times[0] * 1e3,
               step_ms=sum(steady) / len(steady) * 1e3, peak_gib=peak / 2**30, wall_s=wall,
               launches=dict(zip(("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv"),
                                 taylor_counters(K))))
    print(f"{tag} launcher {' '.join(argv)}: {len(steps)} steps, loss "
          f"{' -> '.join(f'{l_:.4f}' for l_ in out['losses'])}; first step "
          f"{out['first_step_ms']:.1f} ms, then {out['step_ms']:.1f} ms/step; peak memory "
          f"{out['peak_gib']:.2f} GiB; wall {wall:.1f} s; launches {out['launches']}")
    if check_fall:
        task = make_task("bigram", cfg.vocab, TRAIN["n"], TRAIN["b"], seed=0)
        first = {k_: torch.from_numpy(x).cuda() for k_, x in task.batch_at(0).items()}
        with torch.no_grad():
            out["final_loss_batch0"] = float(make_loss_fn(cfg)(state.params, first)[1]["loss"])
        print(f"{tag} the first step's batch: loss {out['losses'][0]:.4f} before the run, "
              f"{out['final_loss_batch0']:.4f} after it")
        if not out["final_loss_batch0"] < out["losses"][0]:
            fail(f"{tag} the loss on the first batch did not fall")
    return state, out


def stack_copy_bytes(torch, params, cfg) -> int:
    """Bytes of gradients that Adafactor copies with ``torch.stack`` each
    step (``optim.adafactor``): its stacked block leaves of fewer than 2
    dims per layer (the rest run layer by layer)."""
    import numpy as np

    from repro_torch.models.convert import to_jax_layout
    from repro_torch.tree import tree_leaves, tree_unflatten

    leaves = tree_leaves(params)
    idx = tree_unflatten(params, [np.array(i) for i in range(len(leaves))])
    total = 0
    for ix in tree_leaves(to_jax_layout(idx, cfg, np.array)):
        t = leaves[int(ix.flat[0])]
        if ix.ndim and t.dim() < 2:
            total += ix.size * t.numel() * t.element_size()
    return total


def param_divergence(torch, a, b):
    """(max |a - b|, RMS(a - b) / RMS(b)) over every param leaf, float64 sums."""
    from repro_torch.tree import tree_leaves

    mx, sq, ref = 0.0, 0.0, 0.0
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        d = x.double() - y.double()
        mx = max(mx, float(d.abs().max()))
        sq += float(d.square().sum())
        ref += float(y.double().square().sum())
    return mx, math.sqrt(sq / ref)


def same_bits(torch, a, b) -> bool:
    """Every leaf of two trees equal bit for bit (dtype and shape too)."""
    from repro_torch.tree import tree_items

    ia, ib = list(tree_items(a)), list(tree_items(b))
    return [k for k, _ in ia] == [k for k, _ in ib] and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(ia, ib))


def write_jax_layout(torch, directory, step, state, cfg):
    """``state`` (the port's AdamW TrainState) written as the JAX trainer
    writes one, with numpy: the params and both moments in the JAX layout
    (``params_to_numpy``), keyed by ``keystr`` paths, COMMIT last."""
    import numpy as np

    from repro_torch.models.convert import params_to_numpy
    from repro_torch.tree import tree_items

    flat = {".step": np.asarray(int(state.step), np.int32),
            ".opt_state.step": np.asarray(int(state.opt_state.step), np.int32)}
    for prefix, tree in ((".params", state.params), (".opt_state.m", state.opt_state.m),
                         (".opt_state.v", state.opt_state.v)):
        flat.update({prefix + key: x for key, x in tree_items(params_to_numpy(tree, cfg))})
    flat["__dtype_manifest__"] = np.frombuffer(b"{}", dtype=np.uint8)
    final = os.path.join(directory, f"step_{step:010d}")
    os.makedirs(final)
    np.savez(os.path.join(final, "host_0.npz"), **flat)
    with open(os.path.join(final, "COMMIT"), "w") as f:
        json.dump({"step": step}, f)
    return len(flat) - 1


def phase_breadth(torch, K, qwen_adamw_peak_gib):
    """Phase 15: training breadth at published widths (module constants)."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint, restore_jax_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.data import make_task
    from repro_torch.optim import adafactor, adamw, cosine_warmup
    from repro_torch.train import loss_and_grads, make_loss_fn, make_train_step
    from repro_torch.train import train_state_init
    from repro_torch.tree import tree_leaves, tree_map

    out = {}

    def launcher(arch, *extra, steps=BREADTH_STEPS):
        return ["--arch", arch, "--steps", str(steps), *BREADTH_ARGS, *extra]

    # (a) smollm-135m through the launcher with each optimizer, and the two
    # library-only variants
    cfg = get_config("smollm-135m")
    a = {}
    for name in ("adamw", "adafactor", "sgdm"):
        extra = ["--lr", str(SGD_LR)] if name == "sgdm" else []  # the last --lr holds
        state, a[name] = run_launcher(
            torch, K, launcher("smollm-135m", "--optimizer", name, *extra), cfg,
            f"[15a] {name}:", check_fall=True)
        if name == "adamw":  # kept for (e) in host memory: off the later peaks
            adamw_state = tree_map(lambda t: t.cpu(), state)
        del state
    a["stack_copy_bytes"] = stack_copy_bytes(torch, adamw_state.params, cfg)
    sched = cosine_warmup(TRAIN["lr"], TRAIN["warmup"], BREADTH_STEPS)
    for name, opt in (("adamw_bf16_moments", adamw(sched, state_dtype=torch.bfloat16)),
                      ("adafactor_no_momentum", adafactor(sched, momentum=None, cfg=cfg))):
        a[name] = zoo_train(torch, K, cfg, BREADTH_STEPS, f"[15a] {name}:", opt=opt)
        if not a[name]["losses"][-1] < a[name]["losses"][0]:
            fail(f"[15a] smollm-135m {name}: loss did not fall: {a[name]['losses']}")
    out["a"] = a

    # (b) the remat modes: one step each from the same weights and batch
    batch = bigram_batch(torch, make_task, cfg)
    params = zoo_params(torch, cfg)
    b, grads = {}, {}
    for remat in REMATS:
        rcfg = cfg.replace(remat=remat)
        loss_fn = make_loss_fn(rcfg)
        loss_and_grads(loss_fn, params, batch)  # warm
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        c0 = taylor_counters(K)
        t0 = time.perf_counter()
        _, _, g = loss_and_grads(loss_fn, params, batch)
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        got = tuple(x - y for x, y in zip(taylor_counters(K), c0))
        del g
        for _ in range(REMAT_TIMED - 1):  # the step is host-bound: take a median
            t0 = time.perf_counter()
            loss_and_grads(loss_fn, params, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        ms = sorted(times)[len(times) // 2] * 1e3
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        cfg32 = rcfg.replace(dtype="float32")
        grads[remat] = loss_and_grads(make_loss_fn(cfg32), params, batch)[2]
        b[remat] = dict(step_ms=ms, peak_gib=peak, launches=got)
        each = ", ".join(f"{t * 1e3:.1f}" for t in times)
        print(f"[15b] remat={remat}: forward + backward {ms:.1f} ms (median of {each}), peak "
              f"above the params {peak:.2f} GiB, launches (fwd, dq, dkv) = {got}")
        if got != kernel_launches_per_step(torch, rcfg):
            fail(f"[15b] remat={remat} launched {got}")
    errs = [rel_err(torch, x, y) for x, y in zip(tree_leaves(grads["dots_saveable"]),
                                                tree_leaves(grads["none"]))]
    b["grad_rel_err"] = max(errs)
    order = b["none"]["peak_gib"] >= b["dots_saveable"]["peak_gib"] >= b["full"]["peak_gib"]
    print(f"[15b] float32 gradients, dots_saveable vs none over {len(errs)} leaves: max "
          f"rel_err {max(errs):.3e} (tol {SHARED_GRAD_TOL}); peaks none >= dots_saveable >= "
          f"full: {order}")
    if not max(errs) < SHARED_GRAD_TOL:
        fail(f"[15b] dots_saveable gradients disagree with none's: {max(errs)}")
    out["b"] = b
    del params, grads, batch

    # (c) qwen2-1.5b whole through the launcher: Adafactor, checkpoints, resume
    qcfg = get_config("qwen2-1.5b")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        c = {}
        args = launcher("qwen2-1.5b", "--optimizer", "adafactor", steps=QWEN_STEPS)
        ref, c["uninterrupted"] = run_launcher(
            torch, K, args + ["--ckpt-dir", os.path.join(tmp, "a"), "--ckpt-every", "1000"],
            qcfg, "[15c] uninterrupted:", check_fall=True)
        shutil.rmtree(os.path.join(tmp, "a"))
        ref = ref.params
        c["stack_copy_bytes"] = stack_copy_bytes(torch, ref, qcfg)
        control, c["control"] = run_launcher(torch, K, args, qcfg, "[15c] control:")
        c["control_div"] = param_divergence(torch, control.params, ref)
        del control
        ckpt = os.path.join(tmp, "b")
        part, c["stopped"] = run_launcher(
            torch, K, args + ["--ckpt-dir", ckpt, "--max-wall-seconds", "1e-9"], qcfg,
            "[15c] stopped:")
        saved = restore_checkpoint(ckpt, part)
        c["restore_exact"] = same_bits(torch, saved, part)
        del saved, part
        resumed, c["resumed"] = run_launcher(torch, K, args + ["--ckpt-dir", ckpt], qcfg,
                                             "[15c] resumed:")
        c["resume_div"] = param_divergence(torch, resumed.params, ref)
        del resumed, ref
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    (cmax, crms), (rmax, rrms) = c["control_div"], c["resume_div"]
    gate = RESUME_RATIO * crms + RESUME_FLOOR
    print(f"[15c] restored state equals the saved one bit for bit: {c['restore_exact']}; "
          f"final params vs the uninterrupted run: control max|d| {cmax:.3e} rel RMS "
          f"{crms:.3e}, resumed max|d| {rmax:.3e} rel RMS {rrms:.3e} (ratio "
          f"{rrms / crms if crms else float('inf'):.2f}; gate rel RMS <= {RESUME_RATIO} x "
          f"control + {RESUME_FLOOR} = {gate:.3e})")
    if not c["restore_exact"]:
        fail("[15c] the restored state differs from the saved one")
    if len(c["stopped"]["losses"]) != 1 or len(c["resumed"]["losses"]) != QWEN_STEPS - 1:
        fail(f"[15c] the stop and resume took {len(c['stopped']['losses'])} and "
             f"{len(c['resumed']['losses'])} steps")
    if not rrms <= gate:
        fail(f"[15c] the resumed run diverges beyond the card's own noise: {rrms} > {gate}")
    c["adamw_bf16"] = zoo_train(
        torch, K, qcfg, 2, "[15c] adamw bf16 moments:",
        opt=adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], 2), state_dtype=torch.bfloat16))
    print(f"[15c] qwen2-1.5b peak with AdamW moments in bf16 "
          f"{c['adamw_bf16']['peak_gib']:.2f} GiB vs float32 (phase 12) "
          f"{qwen_adamw_peak_gib:.2f} GiB; with Adafactor {c['uninterrupted']['peak_gib']:.2f} "
          f"GiB")
    out["c"] = c

    # (d) zamba2-7b whole: bf16 params, Adafactor without momentum
    zcfg = get_config("zamba2-7b", param_dtype="bfloat16")
    opt = adafactor(cosine_warmup(ZAMBA_WHOLE_LR, TRAIN["warmup"], ZAMBA_WHOLE_STEPS),
                    momentum=None, cfg=zcfg)
    d = zoo_train(torch, K, zcfg, ZAMBA_WHOLE_STEPS, "[15d] zamba2-7b whole:", opt=opt)
    if not d["losses"][-1] < d["losses"][0]:
        fail(f"[15d] zamba2-7b loss did not fall: {d['losses']}")
    gc.collect()
    torch.cuda.empty_cache()
    params = zoo_params(torch, zcfg)
    d["stack_copy_bytes"] = stack_copy_bytes(torch, params, zcfg)
    d["param_bytes"] = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    del params
    print(f"[15] Adafactor's torch.stack copy of gradients per step: smollm-135m "
          f"{a['stack_copy_bytes']:,} B, qwen2-1.5b {c['stack_copy_bytes']:,} B, zamba2-7b "
          f"{d['stack_copy_bytes']:,} B (of {d['param_bytes']:,} B of bf16 params)")
    out["d"] = d

    # (e) smollm's AdamW state in the JAX trainer's layout, through the loader
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_jax_")
    try:
        n_keys = write_jax_layout(torch, tmp, BREADTH_STEPS, adamw_state, cfg)
        opt = adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], BREADTH_STEPS + 1))
        template = train_state_init(torch.Generator(device="cuda").manual_seed(1), cfg, opt)
        restored = restore_jax_checkpoint(tmp, template, cfg)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    exact = same_bits(torch, restored, tree_map(lambda t: t.cuda(), adamw_state))
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    task = make_task("bigram", cfg.vocab, TRAIN["n"], TRAIN["b"], seed=0)
    nxt = {k_: torch.from_numpy(x).cuda() for k_, x in task.batch_at(BREADTH_STEPS).items()}
    _, m = make_train_step(cfg, opt)(restored, nxt)
    loss = float(m["loss"])
    got = taylor_counters(K)
    print(f"[15e] smollm-135m AdamW state written in the JAX layout ({n_keys} keys), restored "
          f"on the card: bit for bit {exact}; one more step: loss {loss:.4f}, launches "
          f"(fwd, dq, dkv) = {got}")
    if not exact:
        fail("[15e] the JAX-layout restore differs from the state written")
    if got != kernel_launches_per_step(torch, cfg) or not math.isfinite(loss):
        fail(f"[15e] the step after the restore launched {got}, loss {loss}")
    out["e"] = dict(exact=exact, loss=loss, launches=got)
    del restored, adamw_state, template
    return out


def dist_cfg(torch, spec, key, groups=None):
    """The phase's config ``spec[key]`` in float32, cut to ``groups`` layer
    groups (the reduced one, uncut, in a rehearsal)."""
    from repro_torch.configs import get_config, get_reduced

    cfg = (get_reduced if spec["reduced"] else get_config)(spec[key])
    if groups and not spec["reduced"]:
        cfg = cfg.replace(n_groups=groups)
    return cfg.replace(dtype="float32")


def dist_sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dist_peak(torch, dev, reset=False) -> float:
    """Peak GiB allocated on this rank's card since the last reset."""
    if dev.type != "cuda":
        return 0.0
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.max_memory_allocated(dev) / 2**30


def dist_batch(torch, spec, cfg, dev):
    """Phase 16's batch (a cross family's with its source from seed 0)."""
    from repro_torch.data import make_task

    task = make_task("bigram", cfg.vocab, spec["n"], spec["b"], seed=0)
    batch = {k_: torch.from_numpy(x).to(dev) for k_, x in task.batch_at(0).items()}
    if cfg.family != "lm":
        batch.update(source_extras(torch, cfg, spec["b"], 0, device=dev))
    return batch


def dist_tokens(torch, vocab, b, n):
    return torch.randint(0, vocab, (b, n), generator=torch.Generator().manual_seed(0))


def dist_opt(spec, cfg, name="adamw"):
    """The phase's optimizer: AdamW (or Adafactor, over ``cfg``'s stacking)
    under phase 7's warmup over ``spec["steps"]``."""
    from repro_torch.optim import adafactor, adamw, cosine_warmup

    schedule = cosine_warmup(TRAIN["lr"], TRAIN["warmup"], spec["steps"])
    return adamw(schedule) if name == "adamw" else adafactor(schedule, cfg=cfg)


def dist_state(torch, spec, cfg, mesh, dev, opt=None):
    """``make_sharded_state_and_step`` at the phase's batch and ``opt``
    (AdamW by default) from seed 0: (state, step, placements, whole
    batch)."""
    from repro_torch.distributed import api as dist_api
    from repro_torch.launch.train import make_sharded_state_and_step

    batch = dist_batch(torch, spec, cfg, dev)
    opt = opt or dist_opt(spec, cfg)
    shapes = {k_: torch.empty_like(x, device="meta") for k_, x in batch.items()}
    state, step, pl, _ = make_sharded_state_and_step(cfg, opt, mesh,
                                                     dist_api.rules_for_mesh(mesh), shapes,
                                                     seed=0, device=dev)
    return state, step, pl, batch


def dist_train(torch, K, spec, cfg, mesh, dev, opt=None):
    """``spec["steps"]`` sharded steps of ``opt`` (AdamW by default) from
    ``dist_state``, the kernels' counts set to 0 just before.  Returns the
    state, placements and a summary (losses, ms and launches per step, GiB
    held after the state is built and peak GiB)."""
    from repro_torch.distributed import collectives as col

    dist_peak(torch, dev, reset=True)
    state, step, pl, batch = dist_state(torch, spec, cfg, mesh, dev, opt)
    held = torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    losses, times, per_step, records = [], [], [], []
    for i in range(spec["steps"]):
        c0 = taylor_counters(K)
        dist_sync(torch, dev)
        t0 = time.perf_counter()
        with col.recording() as log:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        dist_sync(torch, dev)
        times.append(time.perf_counter() - t0)
        per_step.append(tuple(a - b for a, b in zip(taylor_counters(K), c0)))
        if i == 1:  # step 2's collectives, for phase 20 (c)
            records = [tuple(r) for r in log]
    out = dict(losses=losses, step_ms=[t * 1e3 for t in times], launches=per_step,
               held_gib=held, peak_gib=dist_peak(torch, dev), records=records)
    return state, pl, out


def dist_param_err(torch, state, pl, ref_dir, cfg, dev):
    """This rank's param blocks against the unsharded run's (a checkpoint
    cut to the same blocks): (max |Δ|, the largest over leaves of RMS(Δ) /
    RMS(the unsharded run's update from the seed-0 weights)), the sums over
    each leaf's blocks."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import Placements, distribute_tree
    from repro_torch.models import lm_init
    from repro_torch.tree import tree_leaves

    pp = Placements(pl.mesh, pl.specs.params)
    ref = restore_checkpoint(ref_dir, state.params, placements=pp)
    init = distribute_tree(lm_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev),
                           pp)
    mx, worst = 0.0, 0.0
    for p_, r_, i_, spec in zip(tree_leaves(state.params), tree_leaves(ref), tree_leaves(init),
                                tree_leaves(pl.specs.params)):
        d, u = p_.double() - r_.double(), r_.double() - i_.double()
        sums = torch.stack([d.square().sum(), u.square().sum(), d.abs().max()])
        for entry in spec:
            if entry:
                sums[:2] = col.all_reduce_values(sums[:2].clone(), pl.mesh, entry)
        mx = max(mx, float(sums[2]))
        worst = max(worst, math.sqrt(float(sums[0]) / max(float(sums[1]), 1e-300)))
    return mx, worst


def dist_forward(torch, spec, cfg, mesh, tokens, dev, extras=None):
    """The model's forward (``lm_apply`` inside ``spmd.region``) of whole
    ``tokens`` (and a cross family's source ``extras``) from the seed-0
    weights on ``mesh``: this rank's logits at every ``stride``-th position
    of its sequence block, the block's start, ms and peak GiB."""
    from repro_torch.distributed import api as dist_api
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import Placements, distribute_tree, param_specs
    from repro_torch.models import lm_apply, lm_init

    rules = dist_api.rules_for_mesh(mesh)
    params = lm_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)
    specs = param_specs(params, mesh, rules)
    params = distribute_tree(params, Placements(mesh, specs))
    dist_peak(torch, dev, reset=True)
    b, n = tokens.shape
    lay = spmd.layout_for(mesh, rules, b, n, cfg.d_model)
    with torch.no_grad(), spmd.region(lay, params, specs):
        dist_sync(torch, dev)
        t0 = time.perf_counter()
        batch = {"tokens": tokens.to(dev), **(extras or {})}
        logits, _ = lm_apply(params, spmd.local_batch(batch, lay), cfg)
        dist_sync(torch, dev)
        ms = (time.perf_counter() - t0) * 1e3
    start = col.axis_rank(mesh, lay.sp) * logits.shape[1] if lay.sp else 0
    ok = bool(torch.isfinite(logits).all())
    sample = logits[:, ::spec["stride"]].float().cpu().numpy()
    return dict(sample=sample, start=start, n_local=logits.shape[1], ms=ms, finite=ok,
                peak_gib=dist_peak(torch, dev))


def dist_checksums(torch, tree, placements, dev):
    """Per leaf, a checksum of its whole bits from this rank's blocks: Σ over
    elements of (bits as int64) × a weight of the element's index in the
    whole leaf, wrapping mod 2⁶⁴, summed over the ranks that split the
    leaf.  Equal checksums mean equal leaves bit for bit (but for a
    collision).  ``placements=None``: whole leaves."""
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import global_shape
    from repro_torch.tree import tree_items

    specs = ([s_ for _, s_ in tree_items(placements.specs)] if placements is not None
             else None)
    views = {torch.float32: torch.int32, torch.int32: torch.int32,
             torch.bfloat16: torch.int16, torch.int64: torch.int64}
    sums = []
    for i, (_, x) in enumerate(tree_items(tree)):
        x = x.to(dev)
        spec = specs[i] if specs is not None else ()
        entries = list(spec) + [None] * (x.dim() - len(spec))
        mesh = placements.mesh if placements is not None else None
        shape = global_shape(x.shape, spec, mesh) if specs is not None else tuple(x.shape)
        idx = torch.zeros((), dtype=torch.int64, device=dev)
        for d, entry in enumerate(entries):
            off = col.axis_rank(mesh, entry) * x.shape[d] if entry else 0
            r = torch.arange(off, off + x.shape[d], dtype=torch.int64, device=dev)
            idx = idx[..., None] * shape[d] + r
        weight = (idx * 2654435761 + 40503) % 2147483647
        del idx
        bits = x.contiguous().view(views[x.dtype]).to(torch.int64)
        total = (bits * weight).sum().reshape(1)
        del bits, weight
        for entry in entries:
            if entry:
                total = col.all_reduce_values(total, mesh, entry)
        sums.append(int(total))
    return sums


def dist_rank(rank, world, spec, ref_dir, work, serve=None, teach=None, moe=None,
              moe_ref=None, cross=None, cross_teach=None):
    """One rank of phase 16 (a)-(e), then of phase 17 (``serve``), phase 18
    (``moe``) and phase 19 (``cross``) in the same process group; returns
    its measurements (rank 0 prints each part's wall time as it ends)."""
    import torch

    t_start = time.perf_counter()

    def done(part):
        if rank == 0:
            print(f"[16] rank 0: {part} done at {time.perf_counter() - t_start:.1f} s",
                  flush=True)

    sys.path.insert(0, str(SRC))
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.distributed.sharding import whole_template
    from repro_torch.kernels.taylor_attention import kernel as K
    from repro_torch.launch.mesh import make_host_mesh, set_rank_device
    from repro_torch.tree import tree_items

    dev = set_rank_device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(total_gib=(torch.cuda.get_device_properties(dev).total_memory / 2**30
                          if dev.type == "cuda" else 0.0))
    cfg = dist_cfg(torch, spec, "arch")
    ab = dist_cfg(torch, spec, "arch", spec["ab_groups"])
    tp, dp = make_host_mesh(1, world, device=dev), make_host_mesh(world, 1, device=dev)

    # (a) tp 1×2
    state, pl, out["a"] = dist_train(torch, K, spec, ab, tp, dev)
    out["a"]["param_err"] = dist_param_err(torch, state, pl, ref_dir, ab, dev)
    del state
    done("(a)")

    # (b) dp × fsdp 2×1
    state, pl2, out["b"] = dist_train(torch, K, spec, ab, dp, dev)
    out["b"]["param_err"] = dist_param_err(torch, state, pl2, ref_dir, ab, dev)
    del state
    done("(b)")

    # (e) the elastic restore at (e)'s cut depth: the state after one tp 1×2
    # step saved, restored on 2×1 (into a 2×1 state as the template) and
    # whole (as one process reads it): each leaf's bit checksum against the
    # saved one
    ecfg = cfg if spec["reduced"] else cfg.replace(n_groups=spec["e_groups"])
    state, pl, _ = dist_train(torch, K, dict(spec, steps=1), ecfg, tp, dev)
    t0 = time.perf_counter()
    save_checkpoint(f"{work}/e", 1, state, placements=pl)
    out["e"] = dict(save_s=time.perf_counter() - t0)
    sums_a = dist_checksums(torch, state, pl, dev)
    whole_t = whole_template(state, pl)
    del state
    state, _, pl2, _ = dist_state(torch, spec, ecfg, dp, dev)
    t0 = time.perf_counter()
    back = restore_checkpoint(f"{work}/e", state, placements=pl2)
    out["e"]["restore_2x1_s"] = time.perf_counter() - t0
    del state
    sums_b = dist_checksums(torch, back, pl2, dev)
    del back
    t0 = time.perf_counter()
    if rank == 0:
        whole = restore_checkpoint(f"{work}/e", whole_t)
        out["e"]["restore_whole_s"] = time.perf_counter() - t0
        sums_w = dist_checksums(torch, whole, None, dev)
        del whole
    keys = [k_ for k_, _ in tree_items(pl.specs)]
    bad = [f"2x1 {k_}" for k_, a, b in zip(keys, sums_a, sums_b) if a != b]
    if rank == 0:
        bad += [f"1x1 {k_}" for k_, a, b in zip(keys, sums_a, sums_w) if a != b]
    out["e"].update(mismatches=bad, leaves=len(keys))
    done("(e)")

    # (c) Taylor context parallelism at (a)'s depth: the forward, then training
    b, n = spec["cp_fwd"]
    K.taylor_fwd.launches = 0
    out["c_fwd"] = dist_forward(torch, spec, ab.replace(attn_sharding="cp"), tp,
                                dist_tokens(torch, cfg.vocab, b, n), dev)
    out["c_fwd"]["launches"] = K.taylor_fwd.launches
    done("(c) forward")
    state, _, out["c_train"] = dist_train(torch, K, spec, ab.replace(attn_sharding="cp"), tp,
                                          dev)
    del state
    done("(c) training")

    # (d) SSD context parallelism
    scfg = dist_cfg(torch, spec, "ssm_arch").replace(attn_sharding="cp")
    b, n = spec["ssd_fwd"]
    K.taylor_fwd.launches = 0
    out["d"] = dist_forward(torch, spec, scfg, tp, dist_tokens(torch, scfg.vocab, b, n), dev)
    out["d"]["launches"] = K.taylor_fwd.launches
    done("(d)")
    if serve is not None:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["serve"] = serve_mesh_rank(torch, K, spec, serve, teach, dev, done)
    if moe is not None:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["moe"] = moe_mesh_rank(torch, K, spec, moe, moe_ref, work, dev, done)
    if cross is not None:
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out["cross"] = cross_mesh_rank(torch, K, spec, cross, cross_teach, work, dev, done)
    return out


def phase_distributed(torch, K, spec=DIST, serve=SERVE_MESH, moe=MOE_MESH, cross=CROSS_MESH):
    """Phases 16, 17, 18 and 19: the unsharded references in this process
    (freed before the ranks start), then ``spec["world"]`` ranks run phase
    16's (a)-(e), phase 17's (a)-(d), phase 18's (a)-(d) and phase 19's
    (a)-(d) in one spawn.  Returns the summary (phase 17's under "serve",
    18's under "moe", 19's under "cross"); fails on any check."""
    import tempfile

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.spawn import run_ranks
    from repro_torch.models import lm_apply, lm_init
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import make_train_step, train_state_init

    dev = torch.device(spec["device"])
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    world = spec["world"]
    backend = "nccl" if cards >= world else "gloo"
    print(f"[16] backend {backend} world_size {world} cards {cards}")
    cfg = dist_cfg(torch, spec, "arch", spec["ab_groups"])
    steps = spec["steps"]
    expect = kernel_launches_per_step(torch, cfg)
    out = {}
    with tempfile.TemporaryDirectory() as work:
        # the unsharded run of (a) and (b): same seed, batch and schedule
        gc.collect()
        torch.cuda.empty_cache()
        opt = adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], steps))
        init = lambda: train_state_init(torch.Generator(device=dev).manual_seed(0), cfg, opt,
                                        device=dev)
        state, losses, times, _, peak = train_steps(
            torch, K, cfg, init, make_train_step(cfg, opt), dist_batch(torch, spec, cfg, dev),
            steps, "[16 unsharded]")
        out["ref"] = dict(losses=losses, step_ms=[t * 1e3 for t in times],
                          peak_gib=peak / 2**30)
        save_checkpoint(f"{work}/ref", steps, state.params)
        del state
        # the unsharded forwards of (c) and (d), torch attention in float32
        fwd_ref = {}
        for part, key, (b, n) in (("c", "arch", spec["cp_fwd"]), ("d", "ssm_arch",
                                                                  spec["ssd_fwd"])):
            c = dist_cfg(torch, spec, key, spec["ab_groups"] if part == "c" else None)
            params = lm_init(torch.Generator(device=dev).manual_seed(0), c, device=dev)
            tokens = dist_tokens(torch, c.vocab, b, n).to(dev)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.no_grad():
                logits, _ = lm_apply(params, {"tokens": tokens}, c.replace(attn_impl="torch"))
            torch.cuda.synchronize()
            fwd_ref[part] = dict(sample=logits[:, ::spec["stride"]].float().cpu(),
                                 ms=(time.perf_counter() - t0) * 1e3,
                                 peak_gib=torch.cuda.max_memory_allocated() / 2**30)
            del params, logits
        # phase 17's unsharded engines, and their teacher-forced logits
        t0 = time.perf_counter()
        serve_refs = serve_mesh_refs(torch, K, spec, serve)
        out["serve_refs_s"] = time.perf_counter() - t0
        teach = {part: (r["tokens"][0], r["teacher_logits"]) for part, r in serve_refs.items()
                 if "teacher_logits" in r}
        # phase 18's unsharded runs
        t0 = time.perf_counter()
        moe_refs = moe_mesh_refs(torch, K, spec, moe, work)
        out["moe_refs_s"] = time.perf_counter() - t0
        moe_ref = {"c": moe_refs["c"]["rank"], "d": moe_refs["d"]["rank"]}
        # phase 19's unsharded runs
        t0 = time.perf_counter()
        cross_refs = cross_mesh_refs(torch, K, spec, cross, work)
        out["cross_refs_s"] = time.perf_counter() - t0
        cross_teach = {part: (cross_refs[part]["tokens"][0], cross_refs[part]["teacher_logits"])
                       for part in ("c_serve", "d")}
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = run_ranks(dist_rank, world, backend=backend, init_file=f"{work}/store",
                          args=(spec, f"{work}/ref", work, serve, teach, moe, moe_ref, cross,
                                cross_teach))
        out["ranks_s"] = time.perf_counter() - t0
    total = ranks[0]["total_gib"]
    ref = out["ref"]
    print(f"[16] unsharded {cfg.name} f32 AdamW b={spec['b']} n={spec['n']} remat "
          f"{cfg.remat}: losses {[round(x, 6) for x in ref['losses']]}, "
          f"{[round(x, 1) for x in ref['step_ms']]} ms/step, peak {ref['peak_gib']:.2f} GiB")
    for part, mesh_name in (("a", "1x2 tp"), ("b", "2x1 dp x fsdp")):
        for r, rk in enumerate(ranks):
            o = rk[part]
            print(f"[16{part}] {mesh_name} rank {r}: losses {[round(x, 6) for x in o['losses']]} "
                  f"(unsharded {[round(x, 6) for x in ref['losses']]}), params max|Δ| "
                  f"{o['param_err'][0]:.3e}, per-leaf RMS(Δ)/RMS(update) max "
                  f"{o['param_err'][1]:.3e} (tol {DIST_PARAM_TOL}), "
                  f"{[round(x, 1) for x in o['step_ms']]} ms/step, launches fwd,dq,dkv per "
                  f"step {o['launches']}, peak {o['peak_gib']:.2f} of {total:.1f} GiB "
                  f"(unsharded {ref['peak_gib']:.2f})")
            if any(abs(x - y) > DIST_LOSS_TOL for x, y in zip(o["losses"], ref["losses"])):
                fail(f"[16{part}] rank {r}: losses {o['losses']} vs unsharded {ref['losses']}")
            if not o["param_err"][1] <= DIST_PARAM_TOL:
                fail(f"[16{part}] rank {r}: params differ from the unsharded run's: "
                     f"{o['param_err']}")
            if any(tuple(x) != expect for x in o["launches"]):
                fail(f"[16{part}] rank {r}: launches per step {o['launches']}, expected {expect}")
    for part, key in (("c_fwd", "c"), ("d", "d")):
        sample = torch.cat([torch.from_numpy(rk[part]["sample"]) for rk in ranks], dim=1)
        err = rel_err(torch, sample, fwd_ref[key]["sample"])
        peaks = [round(rk[part]["peak_gib"], 2) for rk in ranks]
        b, n = spec["cp_fwd"] if key == "c" else spec["ssd_fwd"]
        name = f"{cfg.name} x{cfg.n_layers}" if key == "c" else spec["ssm_arch"]
        print(f"[16{key}] {name} cp 1x2 f32 forward b={b} n={n}: logits at every "
              f"{spec['stride']}th position vs unsharded attn_impl='torch': rel_err "
              f"{err:.3e} (tol {DIST_FWD_TOL}); ms per rank "
              f"{[round(rk[part]['ms'], 1) for rk in ranks]} (unsharded "
              f"{fwd_ref[key]['ms']:.1f}); peak per rank {peaks} of {total:.1f} GiB "
              f"(unsharded {fwd_ref[key]['peak_gib']:.2f}); taylor_fwd launches per rank "
              f"{[rk[part]['launches'] for rk in ranks]}")
        if not (err < DIST_FWD_TOL and all(rk[part]["finite"] for rk in ranks)):
            fail(f"[16{key}] the cp forward disagrees with the unsharded one: {err}")
        if any(rk[part]["launches"] for rk in ranks):
            fail(f"[16{key}] the cp forward launched a kernel")
        out[key] = dict(rel_err=err, ms=[rk[part]["ms"] for rk in ranks],
                        ref_ms=fwd_ref[key]["ms"], peak_gib=peaks,
                        ref_peak_gib=fwd_ref[key]["peak_gib"],
                        launches=[rk[part]["launches"] for rk in ranks])
    for r, rk in enumerate(ranks):
        o, tp_losses = rk["c_train"], rk["a"]["losses"]
        print(f"[16c] cp 1x2 training rank {r}: losses {[round(x, 6) for x in o['losses']]} "
              f"(tp {[round(x, 6) for x in tp_losses]}, tol {CP_LOSS_TOL}), "
              f"{[round(x, 1) for x in o['step_ms']]} ms/step, launches {o['launches']}, "
              f"peak {o['peak_gib']:.2f} of {total:.1f} GiB")
        if any(abs(x - y) > CP_LOSS_TOL for x, y in zip(o["losses"], tp_losses)):
            fail(f"[16c] rank {r}: cp losses {o['losses']} vs tp {tp_losses}")
        if any(any(x) for x in o["launches"]):
            fail(f"[16c] rank {r}: the cp training launched a kernel: {o['launches']}")
    e = ranks[0]["e"]
    print(f"[16e] qwen2-1.5b x{spec['e_groups']} state after a tp step ({e['leaves']} leaves) "
          f"saved from 1x2 in {e['save_s']:.1f} s, "
          f"restored on 2x1 in {e['restore_2x1_s']:.1f} s and whole in "
          f"{e['restore_whole_s']:.1f} s: mismatches "
          f"{[m for rk in ranks for m in rk['e']['mismatches']]}")
    if any(rk["e"]["mismatches"] for rk in ranks):
        fail("[16e] a restored leaf differs from the saved state")
    out.update({part: [rk[part] for rk in ranks] for part in ("a", "b", "c_train")})
    out["total_gib"] = total
    out["serve"] = serve_mesh_report(torch, spec, serve, serve_refs, [rk["serve"] for rk in ranks])
    out["moe"] = moe_mesh_report(torch, K, spec, moe, moe_refs, [rk["moe"] for rk in ranks])
    out["cross"] = cross_mesh_report(torch, spec, cross, cross_refs,
                                     [rk["cross"] for rk in ranks])
    return out


def dist_launches(dist, name):
    """Phase 16's launches of kernel ``name`` on each rank by path, for the
    kernels line."""
    i = ("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv").index(name)
    out = {}
    for part, path in (("a", "tp_1x2"), ("b", "dp_fsdp_2x1"), ("c_train", "cp_1x2_train")):
        for r, rk in enumerate(dist[part]):
            out[f"qwen2-1.5b_{path}_rank{r}_{len(rk['launches'])}_steps"] = sum(
                x[i] for x in rk["launches"])
    if name == "taylor_fwd":
        for key, arch in (("c", "qwen2-1.5b"), ("d", "mamba2-780m")):
            for r, n in enumerate(dist[key]["launches"]):
                out[f"{arch}_cp_1x2_lm_apply_rank{r}"] = n
    for part, path in SERVE_MESH_PATHS.items():  # phase 17: serving reaches no kernel
        for r, rk in enumerate(dist["serve"]["ranks"]):
            out[f"{path}_rank{r}"] = rk[part]["launches"][i]
    for paths, key in ((MOE_MESH_PATHS, "moe"), (CROSS_MESH_PATHS, "cross")):  # 18, 19
        for part, path in paths.items():
            for r, rk in enumerate(dist[key]["ranks"]):
                launches = rk[part]["launches"]
                if part in ("a", "b"):
                    out[f"{path}_rank{r}_{len(launches)}_steps"] = sum(x[i] for x in launches)
                else:
                    out[f"{path}_rank{r}"] = launches[i]
    return out


# ---------------------------------------------------------------------------
# Phase 17: serving on a mesh
# ---------------------------------------------------------------------------

SERVE_MESH_PATHS = {"a": "qwen2-1.5b_serve_tp_1x2", "b": "qwen2-1.5b_serve_dp_2x1",
                    "c": "granite-20b_x2_serve_tp_1x2_dv", "d": "qwen2-1.5b_serve_tp_1x2_int8_nan"}


def serve_mesh_cfg(torch, spec, sm, mqa=False):
    """Phase 17's config in float32: qwen2-1.5b cut to ``sm["groups"]``
    layers, or granite-20b to ``sm["mqa_groups"]`` (the reduced ones in a
    rehearsal)."""
    from repro_torch.configs import get_config, get_reduced

    arch = sm["mqa_arch"] if mqa else sm["arch"]
    cfg = (get_reduced if spec["reduced"] else get_config)(arch).replace(dtype="float32")
    if not spec["reduced"]:
        cfg = cfg.replace(n_groups=sm["mqa_groups"] if mqa else sm["groups"])
    return cfg


def serve_mesh_prompts(cfg, sm):
    import torch

    gen = torch.Generator().manual_seed(2)
    return [torch.randint(0, cfg.vocab, (n,), generator=gen).numpy() for n in sm["lens"]]


def serve_mesh_once(torch, K, make_params, cfg, mesh, dev, sm, teacher=None, engine=None,
                    extras=None, probe=None, **engine_kw):
    """Phase 17's requests through one engine (``mesh=None``: unsharded):
    the first requests, one step, the late ones, ``run``.  The weights come
    from ``make_params`` and go to the engine alone (on a mesh it keeps
    this rank's blocks), or ``engine`` is one built already.  ``teacher`` = (tokens of request 0 from the
    unsharded engine, their unsharded logits), or "self" on the unsharded
    engine: the engine's forward runs ``lm_prefill`` on request 0's prompt
    and ``lm_decode_step`` on those tokens (its own, for "self", whose
    logits are returned), and the relative error against the given logits
    is measured.  ``extras``: each request's source (a cross family's), the
    first one's read by the teacher-forced prefill too; ``probe(eng)`` runs
    after the first step, its result under "probe".  Returns the tokens,
    statuses, stats, bytes, GiB, launches and collectives."""
    from repro_torch.distributed import collectives as col
    from repro_torch.models.lm import lm_decode_step, lm_prefill
    from repro_torch.serve import Request, ServeEngine

    eng = engine if engine is not None else ServeEngine(
        make_params(), cfg, max_slots=sm["slots"], n_max=sm["n_max"],
        decode_block=sm["decode_block"], prefill_chunk=sm["chunk"], mesh=mesh, device=dev,
        **engine_kw)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    dist_peak(torch, dev, reset=True)
    prompts = serve_mesh_prompts(cfg, sm)
    reqs = [Request(tokens=p, max_new_tokens=sm["new"], extras=extras[i] if extras else {})
            for i, p in enumerate(prompts)]
    first = len(reqs) - sm["late"]
    c0, n0 = taylor_counters(K), sum(col.calls.values())
    dist_sync(torch, dev)
    t0 = time.perf_counter()
    rids = [eng.submit(r) for r in reqs[:first]]
    eng.step()  # the first requests mid-flight: the rest are late admissions
    probed = probe(eng) if probe is not None else None
    rids += [eng.submit(r) for r in reqs[first:]]
    res = eng.run(return_results=True)
    dist_sync(torch, dev)
    out = dict(wall_s=time.perf_counter() - t0, held_gib=held, peak_gib=dist_peak(torch, dev),
               tokens=[res[r].tokens.tolist() for r in rids],
               status=[res[r].status.value for r in rids], stats=eng.stats(),
               slot_bytes=eng.live_state_bytes,
               launches=tuple(a - b for a, b in zip(taylor_counters(K), c0)),
               collectives=sum(col.calls.values()) - n0, probe=probed)
    if teacher is not None:
        toks, ref = (out["tokens"][0], None) if teacher == "self" else teacher
        ctx = eng._on_mesh(slotted=False)  # a request's batch: whole on every "data" rank
        with torch.no_grad(), ctx:
            p0 = torch.as_tensor(prompts[0], device=dev)[None].long()
            src = {k: torch.as_tensor(v, device=dev) for k, v in (extras or [{}])[0].items()}
            lg, caches = lm_prefill(eng.params, {"tokens": p0, **src}, cfg, sm["n_max"])
            steps = [lg[0]]
            for t in range(len(toks) - 1):
                tok = torch.tensor([toks[t]], device=dev)
                lg, caches = lm_decode_step(eng.params, tok, caches, len(prompts[0]) + t, cfg)
                steps.append(lg[0])
        got = torch.stack(steps).float().cpu()
        if ref is None:
            out["teacher_logits"] = got.numpy()
        else:
            out["teacher_rel_err"] = rel_err(torch, got, torch.as_tensor(ref))
        del caches, steps, got
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return out


def serve_mesh_params(torch, cfg, dev):
    from repro_torch.models import lm_init

    return lambda: lm_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)


def serve_mesh_refs(torch, K, spec, sm):
    """Phase 17's unsharded engines in this process: (a)'s (for (a) and (b)),
    (c)'s and (d)'s without the NaN, with (a)'s and (c)'s teacher-forced
    logits."""
    dev = torch.device(spec["device"])
    qwen, granite = serve_mesh_cfg(torch, spec, sm), serve_mesh_cfg(torch, spec, sm, mqa=True)
    refs = {}
    for part, cfg, kw in (("a", qwen, dict(teacher="self")), ("c", granite,
                                                               dict(teacher="self")),
                          ("d", qwen, dict(state_dtype="int8"))):
        refs[part] = serve_mesh_once(torch, K, serve_mesh_params(torch, cfg, dev), cfg, None,
                                     dev, sm, **kw)
    return refs


def serve_mesh_rank(torch, K, spec, sm, teach, dev, done):
    """One rank of phase 17 (a)-(d) on the engine's serving meshes."""
    from repro_torch.launch.mesh import make_serve_mesh
    from repro_torch.serve import FaultPlan, SlotCorruption

    world = spec["world"]
    tp, dp = make_serve_mesh(1, world, device=dev), make_serve_mesh(world, 1, device=dev)
    qwen, granite = serve_mesh_cfg(torch, spec, sm), serve_mesh_cfg(torch, spec, sm, mqa=True)
    q_params, g_params = serve_mesh_params(torch, qwen, dev), serve_mesh_params(torch, granite,
                                                                                dev)
    out = {"a": serve_mesh_once(torch, K, q_params, qwen, tp, dev, sm, teacher=teach["a"])}
    done("[17] (a)")
    out["b"] = serve_mesh_once(torch, K, q_params, qwen, dp, dev, sm)
    done("[17] (b)")
    out["c"] = serve_mesh_once(torch, K, g_params, granite, tp, dev, sm, teacher=teach["c"])
    done("[17] (c)")
    block, slot = sm["corrupt"]
    plan = FaultPlan(events=(SlotCorruption(at_block=block, slot=slot, mode="nan"),))
    out["d"] = serve_mesh_once(torch, K, q_params, qwen, tp, dev, sm, state_dtype="int8",
                               fault_plan=plan)
    done("[17] (d)")
    return out


def serve_mesh_summary(sv) -> str:
    """Phase 17's summary line."""
    def tps(st):
        return round(st["decode_tokens"] / st["decode_seconds"], 1)

    return (f"[17] summary ({sv['card']}; f32, {SERVE_MESH['slots']} slots, "
            f"{len(SERVE_MESH['lens'])} requests x {SERVE_MESH['new']} tokens, "
            f"{len(sv['ranks'])} ranks): " + "; ".join(
                f"{path}: decode tokens/s per rank {[tps(rk[part]['stats']) for rk in sv['ranks']]}"
                f" (unsharded {tps(sv[part]['ref_stats'])}), slot bytes per rank "
                f"{[rk[part]['slot_bytes'] for rk in sv['ranks']]} (unsharded "
                f"{sv[part]['ref_slot_bytes']}), tokens equal {sv[part]['tokens_equal']}"
                for part, path in SERVE_MESH_PATHS.items()))


def serve_mesh_gap(torch, spec, sm, cfg, prompt, want, t, extras=None):
    """The unsharded model's top-2 logit gap, and its logits' RMS, at the
    position of ``want[t]`` (prompt + ``want[:t]``, and the request's source
    ``extras``, through ``lm_prefill``)."""
    from repro_torch.models.lm import lm_prefill

    dev = torch.device(spec["device"])
    params = serve_mesh_params(torch, cfg, dev)()
    seq = torch.cat([torch.as_tensor(prompt), torch.as_tensor(want[:t])]).long().to(dev)[None]
    src = {k: torch.as_tensor(v, device=dev) for k, v in (extras or {}).items()}
    with torch.no_grad():
        lg = lm_prefill(params, {"tokens": seq, **src}, cfg, sm["n_max"])[0][0].float()
    top = lg.topk(2).values
    del params
    return float(top[0] - top[1]), float(lg.square().mean().sqrt())


def serve_mesh_report(torch, spec, sm, refs, ranks):
    """Phase 17's gates over every rank's results; prints each rank's
    numbers.  Returns the summary."""
    card = "no card"  # a CPU rehearsal
    if spec["device"] == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    victim = sm["corrupt"][1]
    parts = (("a", "qwen2-1.5b tp 1x2", "a"), ("b", "qwen2-1.5b dp 2x1", "a"),
             ("c", f"granite-20b x{sm['mqa_groups']} tp 1x2 (d_v split)", "c"),
             ("d", "qwen2-1.5b tp 1x2 int8 + NaN", "d"))
    summary = {"ranks": ranks, "card": card}
    for part, name, key in parts:
        ref = refs[key]
        cfg = serve_mesh_cfg(torch, spec, sm, mqa=part == "c")
        st_ref = ref["stats"]
        print(f"[17{part}] {name} ({card}): unsharded prefill {st_ref['prefill_seconds']:.3f} s, "
              f"decode {st_ref['decode_tokens'] / st_ref['decode_seconds']:.1f} tokens/s, "
              f"{ref['slot_bytes']} slot-cache bytes, held {ref['held_gib']:.2f} GiB, peak "
              f"{ref['peak_gib']:.2f} GiB")
        for r, rk in enumerate(ranks):
            o, st = rk[part], rk[part]["stats"]
            print(f"[17{part}] rank {r}: prefill {st['prefill_seconds']:.3f} s, decode "
                  f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s, "
                  f"{o['slot_bytes']} slot-cache bytes ({o['slot_bytes'] / ref['slot_bytes']:.4f} "
                  f"of unsharded), held {o['held_gib']:.2f} GiB, peak {o['peak_gib']:.2f} GiB, "
                  f"{st['decode_collectives'] / st['decode_tokens']:.1f} collectives per decode "
                  f"token ({o['collectives']} in all), wall {o['wall_s']:.1f} s, launches "
                  f"fwd,dq,dkv {o['launches']}, statuses {o['status']}"
                  + (f", teacher-forced logits rel_err {o['teacher_rel_err']:.3e} (tol "
                     f"{SERVE_MESH_LOGIT_TOL})" if "teacher_rel_err" in o else ""))
            if o["tokens"] != ranks[0][part]["tokens"]:
                fail(f"[17{part}] rank {r} emitted other tokens than rank 0")
            if any(o["launches"]):
                fail(f"[17{part}] rank {r}: serving launched a kernel: {o['launches']}")
            if "teacher_rel_err" in o and not o["teacher_rel_err"] < SERVE_MESH_LOGIT_TOL:
                fail(f"[17{part}] rank {r}: teacher-forced logits rel_err {o['teacher_rel_err']}")
            if any(s_ != "ok" for s_ in o["status"]):
                fail(f"[17{part}] rank {r}: statuses {o['status']}")
            share = o["slot_bytes"] / ref["slot_bytes"]
            if part in ("a", "d") and abs(share - 0.5) > 0.5 * SERVE_MESH_BYTES_TOL:
                fail(f"[17{part}] rank {r}: {share:.4f} of the slot-cache bytes, not half")
            if part == "b" and o["slot_bytes"] * sm["slots"] != ref["slot_bytes"] * (
                    sm["slots"] // spec["world"]):
                fail(f"[17b] rank {r}: {o['slot_bytes']} bytes, not {sm['slots'] // spec['world']}"
                     f" of {sm['slots']} slots")
            if part == "c" and not 0.5 <= share <= 1.0:
                fail(f"[17c] rank {r}: {share:.4f} of the slot-cache bytes")
            if part == "d" and not (o["stats"].get("quarantined") == 1
                                    and o["stats"].get("corruptions_injected") == 1):
                fail(f"[17d] rank {r}: quarantined {o['stats'].get('quarantined')}, injected "
                     f"{o['stats'].get('corruptions_injected')}")
        prompts = serve_mesh_prompts(cfg, sm)
        got = ranks[0][part]["tokens"]
        for i, (p, w, g) in enumerate(zip(prompts, ref["tokens"], got)):
            if w == g or (part == "d" and i == victim):
                continue
            t = next(j for j, (x, y) in enumerate(zip(w, g)) if x != y)
            gap, rms = serve_mesh_gap(torch, spec, sm, cfg, p, w, t)
            print(f"[17{part}] request {i} first differs at token {t}: unsharded top-2 gap "
                  f"{gap:.3e} (limit {SERVE_MESH_TIE} x RMS {rms:.3e})")
            if not gap < SERVE_MESH_TIE * rms:
                fail(f"[17{part}] request {i} differs from the unsharded engine's tokens")
        equal = all(w == g for i, (w, g) in enumerate(zip(ref["tokens"], got))
                    if not (part == "d" and i == victim))  # (d): the victim's retry re-prefills
        summary[part] = dict(tokens_equal=equal, ref_stats=st_ref,
                             ref_slot_bytes=ref["slot_bytes"], ref_peak_gib=ref["peak_gib"])
    return summary


# ---------------------------------------------------------------------------
# Phase 18: MoE on a mesh
# ---------------------------------------------------------------------------

MOE_MESH_PATHS = {"a": "qwen2-moe-a2.7b_x1_train_tp_ep_1x2",
                  "b": "qwen2-moe-a2.7b_x1_train_dp_fsdp_2x1",
                  "c": "qwen2-moe-a2.7b_layer0_int8_a2a_1x2",
                  "d_fwd": "kimi-k2-1t-a32b_x1_lm_apply_f32_and_bf16_1x2",
                  "d_serve": "kimi-k2-1t-a32b_x1_serve_1x2"}


def moe_mesh_cfg(torch, spec, mm, kimi=False):
    """Phase 18's config, ``impl="auto"`` at the published capacity 1.25:
    qwen2-moe-a2.7b in float32 cut to ``mm["groups"]`` layers, or kimi-k2
    with bf16 params and activations cut to ``mm["kimi_groups"]`` (the
    reduced ones, uncut, in a rehearsal; ``kimi_f32_cfg`` gives kimi's
    float32 activations)."""
    from repro_torch.configs import get_config, get_reduced

    cfg = (get_reduced if spec["reduced"] else get_config)(mm["kimi"] if kimi else mm["arch"])
    if not spec["reduced"]:
        cfg = cfg.replace(n_groups=mm["kimi_groups"] if kimi else mm["groups"])
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, impl="auto", capacity_factor=1.25))
    dtype = "bfloat16" if kimi else "float32"
    return cfg.replace(dtype=dtype, param_dtype=dtype)


def kimi_f32_cfg(kcfg):
    """(d)'s checked config: bf16 params, float32 activations."""
    return kcfg.replace(dtype="float32")


@contextlib.contextmanager
def plain_moe(dp_size, ep_size, capture=None):
    """The unsharded references' MoE layers: ``moe_apply`` with its routed
    experts through ``_moe_ep_a2a_plain`` at ``dp_size`` × ``ep_size`` (the
    mesh run's function on one device); ``capture`` (a list) receives the
    first layer's input of the first call."""
    from repro_torch.models import moe
    from repro_torch.models.layers import mlp_apply

    real = moe.moe_apply

    def apply(params, x, cfg):
        if capture is not None and not capture:
            capture.append(x.detach().clone())
        routed = {"router": params["router"], "experts": params["experts"]}
        y, aux = moe._moe_ep_a2a_plain(routed, x, cfg, dp_size, ep_size)
        if cfg.moe.n_shared_experts:
            y = y + mlp_apply(params["shared"], x, cfg.act)
        return y, aux

    moe.moe_apply = apply
    try:
        yield
    finally:
        moe.moe_apply = real


def moe_expert_share(torch, params, specs, mesh):
    """The bytes of the experts' leaves this rank holds, as a share of the
    whole leaves' bytes."""
    from repro_torch.distributed.sharding import global_shape

    held = whole = 0
    for blk, spec in zip(params["blocks"], specs["blocks"]):
        if blk is None or "moe" not in blk:
            continue
        for k_, x in blk["moe"]["experts"].items():
            held += x.numel() * x.element_size()
            whole += math.prod(global_shape(x.shape, spec["moe"]["experts"][k_], mesh)) * \
                x.element_size()
    return held / whole


def moe_layer_grads(torch, fn, routed, x, r):
    """``fn(routed, x) -> (y, aux)``: y, aux and the gradients of ``Σ y·r + 3
    aux`` (the router's and x's whole, the experts' as their sums of squares
    per expert)."""
    leaves = {"router": routed["router"]["w"].detach().requires_grad_(),
              **{k_: v.detach().requires_grad_() for k_, v in routed["experts"].items()}}
    xg = x.detach().requires_grad_()
    y, aux = fn({"router": {"w": leaves["router"]},
                 "experts": {k_: v for k_, v in leaves.items() if k_ != "router"}}, xg)
    grads = torch.autograd.grad((y.float() * r).sum() + 3.0 * aux.float(),
                                list(leaves.values()) + [xg])
    out = dict(y=y.detach(), aux=float(aux), x=grads[-1])
    for (k_, _), g in zip(leaves.items(), grads[:-1]):
        out[k_] = g if k_ == "router" else g.float().square().sum(dim=(1, 2))
    return out


def moe_mesh_refs(torch, K, spec, mm, work):
    """Phase 18's unsharded runs in this process: (a) and (b)'s training
    (their params saved under ``work``) with the MoE layers at (a)'s and
    (b)'s dp × ep, (c)'s layer-0 MoE on (a)'s real layer-0 input (saved for
    the ranks), and kimi-k2's forward and engine (d)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models import lm_init, moe
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import make_train_step, train_state_init
    from repro_torch.tree import tree_leaves

    dev = torch.device(spec["device"])
    world, steps = spec["world"], spec["steps"]
    cfg = moe_mesh_cfg(torch, spec, mm)
    batch = dist_batch(torch, spec, cfg, dev)
    opt = adamw(cosine_warmup(TRAIN["lr"], TRAIN["warmup"], steps))
    init = lambda: train_state_init(torch.Generator(device=dev).manual_seed(0), cfg, opt,
                                    device=dev)
    out, seen = {}, []
    for part, (dp, ep) in (("a", (1, world)), ("b", (world, 1))):
        gc.collect()
        torch.cuda.empty_cache()
        with plain_moe(dp, ep, capture=seen):
            state, losses, times, _, peak = train_steps(
                torch, K, cfg, init, make_train_step(cfg, opt), batch, steps,
                f"[18{part} unsharded]")
        save_checkpoint(f"{work}/moe_{part}", steps, state.params)
        out[part] = dict(losses=losses, step_ms=[t * 1e3 for t in times], peak_gib=peak / 2**30)
        del state
    # (c): layer 0's MoE on its real input (the step-1 forward's), the
    # plain version with the int8 payload and without it
    x0 = seen[0]
    moe0 = lm_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)["blocks"][0]["moe"]
    routed = {"router": moe0["router"], "experts": moe0["experts"]}
    del moe0
    for part, (dp, ep) in (("a", (1, world)), ("b", (world, 1))):
        out[part]["drops"] = moe.ep_a2a_drops(routed, x0, cfg, dp, ep)
    exact, c8 = moe_c_cfgs(cfg)
    r = torch.randn(x0.shape, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    plain8 = moe_layer_grads(torch, lambda p, x: moe._moe_ep_a2a_plain(p, x, c8, 1, world),
                             routed, x0, r)
    with torch.no_grad():
        y_exact = moe._moe_ep_a2a_plain(routed, x0, exact, 1, world)[0]
    torch.save(dict(x=x0, r=r, plain8=plain8, exact=y_exact), f"{work}/moe_c.pt")
    out["c"] = dict(rank=f"{work}/moe_c.pt", int8_vs_exact=rel_err(torch, plain8["y"], y_exact))
    del x0, r, plain8, y_exact, routed, seen
    # (d): kimi-k2 at published widths, the forward and the engine
    kcfg = moe_mesh_cfg(torch, spec, mm, kimi=True)
    gc.collect()
    torch.cuda.empty_cache()
    dist_peak(torch, dev, reset=True)
    params = lm_init(torch.Generator(device=dev).manual_seed(0), kcfg, device=dev)
    held = torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    seen = []
    with plain_moe(1, world, capture=seen):
        fwd = kimi_forwards(torch, K, spec, mm, params, kcfg, dev, contextlib.nullcontext)
    blk = params["blocks"][0]["moe"]
    d = dict(fwd=fwd, held_gib=held,
             drops=moe.ep_a2a_drops({"router": blk["router"], "experts": blk["experts"]},
                                    seen[0], kimi_f32_cfg(kcfg), 1, world),
             expert_bytes=sum(x.numel() * x.element_size() for x in blk["experts"].values()),
             params=sum(x.numel() for x in tree_leaves(params)))
    del seen, blk
    with plain_moe(1, world):
        d["serve"] = serve_mesh_once(torch, K, lambda: params, kimi_f32_cfg(kcfg), None, dev,
                                     mm["serve"], teacher="self")
    d["peak_gib"] = dist_peak(torch, dev)
    del params
    d["rank"] = (d["serve"]["tokens"][0], d["serve"]["teacher_logits"])
    out["d"] = d
    gc.collect()
    torch.cuda.empty_cache()
    return out


def kimi_forwards(torch, K, spec, mm, params, kcfg, dev, region):
    """(d)'s forward at ``mm["kimi_fwd"]`` (inside ``region()``), with float32
    activations (first: the checked one) and in bf16: per dtype the ms,
    launches, finiteness and every ``spec["stride"]``-th position's logits."""
    from repro_torch.distributed import collectives as col
    from repro_torch.models import lm_apply

    b, n = mm["kimi_fwd"]
    tokens = dist_tokens(torch, kcfg.vocab, b, n).to(dev)
    out = {}
    for name, cfg in (("f32", kimi_f32_cfg(kcfg)), ("bf16", kcfg)):
        K.taylor_fwd.launches = 0
        a0 = col.calls["all_to_all"]
        dist_peak(torch, dev, reset=True)
        with torch.no_grad(), region():
            dist_sync(torch, dev)
            t0 = time.perf_counter()
            logits, _ = lm_apply(params, {"tokens": tokens}, cfg)
            dist_sync(torch, dev)
            ms = (time.perf_counter() - t0) * 1e3
        out[name] = dict(ms=ms, launches=K.taylor_fwd.launches, peak_gib=dist_peak(torch, dev),
                         a2a_calls=col.calls["all_to_all"] - a0,
                         finite=bool(torch.isfinite(logits).all()),
                         sample=logits[:, ::spec["stride"]].float().cpu().numpy())
        del logits
    return out


def moe_c_cfgs(cfg):
    """(c)'s layer configs: the routed experts alone, exact and with the int8
    payload."""
    routed = dataclasses.replace(cfg.moe, n_shared_experts=0, d_ff_shared=0)
    return (cfg.replace(moe=routed),
            cfg.replace(moe=dataclasses.replace(routed, a2a_quant="int8")))


def moe_int8_rank(torch, K, spec, cfg, ref_path, mesh, dev):
    """(c) on this rank: layer 0's MoE with the int8 payload inside
    ``spmd.region`` on the rank's blocks, against the plain version's
    forward (same quantisation) and gradients, and the exact path."""
    from repro_torch.distributed import api as dist_api
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed import spmd
    from repro_torch.distributed.api import P
    from repro_torch.distributed.sharding import (Placements, block_of, distribute_tree,
                                                  gather_leaf, param_specs)
    from repro_torch.models import lm_init, moe

    ref = torch.load(ref_path, map_location=dev)
    _, c8 = moe_c_cfgs(cfg)
    rules = dist_api.rules_for_mesh(mesh)
    moe0 = lm_init(torch.Generator(device=dev).manual_seed(0), cfg, device=dev)["blocks"][0]["moe"]
    tree = {"moe": {"router": moe0["router"], "experts": moe0["experts"]}}
    del moe0
    specs = param_specs(tree, mesh, rules)
    blocks = distribute_tree(tree, Placements(mesh, specs))
    del tree
    b, n, d = ref["x"].shape
    lay = spmd.layout_for(mesh, rules, b, n, d)
    stream = P(lay.dp, lay.sp, None)
    xb = block_of(ref["x"], stream, mesh).contiguous()
    rb = block_of(ref["r"], stream, mesh)
    K.taylor_fwd.launches = K.taylor_bwd.dq_launches = K.taylor_bwd.dkv_launches = 0
    a0, b0 = col.calls["all_to_all"], col.sent_bytes["all_to_all"]

    def fn(p, x):
        y, aux = moe.moe_apply(p, x, c8)
        return y, aux

    with spmd.region(lay, blocks, specs):
        # the region's loss: Σ y·r over every rank's block, plus 3 aux
        leaves = {"router": blocks["moe"]["router"]["w"].requires_grad_(),
                  **{k_: v.requires_grad_() for k_, v in blocks["moe"]["experts"].items()}}
        xg = xb.requires_grad_()
        y, aux = fn(blocks["moe"], xg)
        loss = (y.float() * rb).sum()
        for axis in lay.dp_names + ((lay.sp,) if lay.sp else ()):
            loss = col.all_reduce(loss, mesh, axis)
        grads = torch.autograd.grad(loss + 3.0 * aux.float(), list(leaves.values()) + [xg])
    calls = col.calls["all_to_all"] - a0
    sent = col.sent_bytes["all_to_all"] - b0
    y = gather_leaf(y.detach(), stream, mesh)
    step = ref["plain8"]["y"].abs().amax(dim=-1, keepdim=True) / 127.0
    excess = float((((y - ref["plain8"]["y"]).abs() - step).clamp(min=0)).max())
    errs, finite, nonzero = {}, True, True
    espec = specs["moe"]["experts"]
    for (k_, _), g in zip(leaves.items(), grads[:-1]):
        if k_ != "router":  # each expert's sum of squares, gathered over "ep"
            g = gather_leaf(g.float().square().sum(dim=(1, 2)), P(espec[k_][0]), mesh)
        errs[k_] = rel_err(torch, g, ref["plain8"][k_])
        finite &= bool(torch.isfinite(g).all())
        nonzero &= bool(g.abs().sum() > 0)
    gx = gather_leaf(grads[-1], stream, mesh)
    errs["x"] = rel_err(torch, gx, ref["plain8"]["x"])
    return dict(step_excess=excess, vs_exact=rel_err(torch, y, ref["exact"]),
                aux_err=abs(float(aux) - ref["plain8"]["aux"]) / max(abs(ref["plain8"]["aux"]),
                                                                     1e-30),
                grad_errs=errs,
                grads_finite=finite and bool(torch.isfinite(gx).all()), grads_nonzero=nonzero,
                a2a_calls=calls, a2a_bytes=sent, launches=taylor_counters(K))


def moe_mesh_rank(torch, K, spec, mm, moe_ref, work, dev, done):
    """One rank of phase 18 (a)-(d)."""
    import torch.distributed as tdist

    from repro_torch.distributed import collectives as col
    from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh
    from repro_torch.models import lm_init
    from repro_torch.models.lm import tree_to
    from repro_torch.serve import ServeEngine

    world, steps = spec["world"], spec["steps"]
    cfg = moe_mesh_cfg(torch, spec, mm)
    tp = make_host_mesh(1, world, device=dev)
    out = {}
    for part, mesh in (("a", tp), ("b", make_host_mesh(world, 1, device=dev))):
        a0, b0 = col.calls["all_to_all"], col.sent_bytes["all_to_all"]
        state, pl, o = dist_train(torch, K, spec, cfg, mesh, dev)
        o["a2a_calls"] = (col.calls["all_to_all"] - a0) / steps
        o["a2a_bytes"] = (col.sent_bytes["all_to_all"] - b0) / steps
        o["held_gib"] = torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
        o["expert_share"] = moe_expert_share(torch, state.params, pl.specs.params, mesh)
        o["param_err"] = dist_param_err(torch, state, pl, f"{work}/moe_{part}", cfg, dev)
        del state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[part] = o
        done(f"[18] ({part})")
    out["c"] = moe_int8_rank(torch, K, spec, cfg, moe_ref["c"], tp, dev)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done("[18] (c)")

    # (d) kimi-k2: the ranks take turns to draw the whole weights on the card
    # and build the engine, which keeps this rank's blocks; a later rank
    # moves the tree to the host first (the engine then moves only its
    # blocks back), as the whole tree and its blocks do not fit beside the
    # earlier ranks' blocks
    kcfg = moe_mesh_cfg(torch, spec, mm, kimi=True)
    sm = mm["serve"]
    smesh = make_serve_mesh(1, world, device=dev)
    dist_peak(torch, dev, reset=True)
    t0 = time.perf_counter()
    eng = None
    for turn in range(world):
        if tdist.get_rank() == turn:
            host = lm_init(torch.Generator(device=dev).manual_seed(0), kcfg, device=dev)
            if turn:
                host = tree_to(host, "cpu")
                gc.collect()
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            eng = ServeEngine(host, kimi_f32_cfg(kcfg), max_slots=sm["slots"],
                              n_max=sm["n_max"],
                              decode_block=sm["decode_block"], prefill_chunk=sm["chunk"],
                              mesh=smesh, device=dev)
            del host
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()  # the whole tree's memory, for the next rank
        tdist.barrier()
    d = dict(build_s=time.perf_counter() - t0, build_peak_gib=dist_peak(torch, dev),
             held_gib=torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0,
             expert_share=moe_expert_share(torch, eng.params, eng._param_specs, smesh))
    done("[18] (d) engine built")
    d["fwd"] = kimi_forwards(torch, K, spec, mm, eng.params, kcfg, dev,
                             lambda: eng._on_mesh(slotted=False))
    done("[18] (d) forward")
    a0, b0 = col.calls["all_to_all"], col.sent_bytes["all_to_all"]
    d["serve"] = serve_mesh_once(torch, K, None, kimi_f32_cfg(kcfg), smesh, dev, sm,
                                 teacher=moe_ref["d"], engine=eng)
    d["serve"].update(a2a_calls=col.calls["all_to_all"] - a0,
                      a2a_bytes=col.sent_bytes["all_to_all"] - b0)
    del eng
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    out["d"] = d
    out["d_fwd"] = dict(launches=(d["fwd"]["f32"]["launches"] + d["fwd"]["bf16"]["launches"], 0,
                                  0))
    out["d_serve"] = dict(launches=d["serve"]["launches"])
    done("[18] (d) serving")
    return out


def moe_mesh_report(torch, K, spec, mm, refs, ranks):
    """Phase 18's gates over every rank's results; prints each rank's
    numbers.  Returns the summary."""
    card = "no card"  # a CPU rehearsal
    if spec["device"] == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    cfg = moe_mesh_cfg(torch, spec, mm)
    expect = kernel_launches_per_step(torch, cfg)
    world = spec["world"]
    summary = {"ranks": ranks, "card": card, "refs": {k_: v for k_, v in refs.items()
                                                     if k_ != "d"}}
    for part, name in (("a", f"tp/ep 1x{world}"), ("b", f"dp x fsdp {world}x1")):
        ref = refs[part]
        dropped, routed = ref["drops"]
        print(f"[18{part}] {cfg.name} x{cfg.n_layers} {name} ({card}): unsharded losses "
              f"{[round(x, 6) for x in ref['losses']]}, {[round(x, 1) for x in ref['step_ms']]} "
              f"ms/step, peak {ref['peak_gib']:.2f} GiB; layer 0 drops {dropped} of {routed} "
              f"routed pairs ({dropped / routed:.4f}) at capacity "
              f"{cfg.moe.capacity_factor}")
        for r, rk in enumerate(ranks):
            o = rk[part]
            print(f"[18{part}] rank {r}: losses {[round(x, 6) for x in o['losses']]}, params "
                  f"max|Δ| {o['param_err'][0]:.3e}, per-leaf RMS(Δ)/RMS(update) max "
                  f"{o['param_err'][1]:.3e} (tol {DIST_PARAM_TOL}), "
                  f"{[round(x, 1) for x in o['step_ms']]} ms/step, expert bytes held "
                  f"{o['expert_share']:.4f} of unsharded, held {o['held_gib']:.2f} GiB, peak "
                  f"{o['peak_gib']:.2f} GiB, all-to-all {o['a2a_calls']:.0f} calls and "
                  f"{o['a2a_bytes'] / 1e6:.1f} MB sent per step, launches fwd,dq,dkv per step "
                  f"{o['launches']}")
            if any(abs(x - y) > DIST_LOSS_TOL for x, y in zip(o["losses"], ref["losses"])):
                fail(f"[18{part}] rank {r}: losses {o['losses']} vs unsharded {ref['losses']}")
            if not o["param_err"][1] <= DIST_PARAM_TOL:
                fail(f"[18{part}] rank {r}: params differ from the unsharded run's: "
                     f"{o['param_err']}")
            if any(tuple(x) != expect for x in o["launches"]):
                fail(f"[18{part}] rank {r}: launches per step {o['launches']}, expected {expect}")
            if abs(o["expert_share"] - 1 / world) > 1e-9:
                fail(f"[18{part}] rank {r}: holds {o['expert_share']} of the expert bytes")
            if part == "a" and not o["a2a_calls"] > 0:
                fail(f"[18a] rank {r}: no all-to-all ran")
    print(f"[18c] layer 0's MoE, int8 payload, tp/ep 1x{world}: unsharded int8 vs exact rel_err "
          f"{refs['c']['int8_vs_exact']:.3e}")
    for r, rk in enumerate(ranks):
        o = rk["c"]
        errs = {k_: f"{v:.2e}" for k_, v in o["grad_errs"].items()}
        print(f"[18c] rank {r}: y beyond one int8 step of the plain version's "
              f"{o['step_excess']:.3e}, vs the exact path rel_err {o['vs_exact']:.3e} (tol "
              f"{MOE_INT8_TOL}), aux rel_err {o['aux_err']:.2e}, gradients vs the plain "
              f"version's rel {errs} (tol {MOE_GRAD_TOL}), finite {o['grads_finite']}, "
              f"non-zero {o['grads_nonzero']}, all-to-all {o['a2a_calls']} calls "
              f"{o['a2a_bytes'] / 1e6:.1f} MB")
        if not (o["step_excess"] <= 1e-5 and o["vs_exact"] < MOE_INT8_TOL
                and o["aux_err"] < 1e-5):
            fail(f"[18c] rank {r}: the int8 payload's forward is off: {o}")
        if not (o["grads_finite"] and o["grads_nonzero"]
                and all(v < MOE_GRAD_TOL for v in o["grad_errs"].values())):
            fail(f"[18c] rank {r}: the int8 payload's gradients are off: {o['grad_errs']}")
        if any(o["launches"]):
            fail(f"[18c] rank {r}: the MoE layer launched a kernel: {o['launches']}")
    # (d)
    kcfg = moe_mesh_cfg(torch, spec, mm, kimi=True)
    d = refs["d"]
    dropped, routed = d["drops"]
    st_ref = d["serve"]["stats"]
    fwd = {k_: f"{v['ms']:.1f} ms ({v['launches']} launches)" for k_, v in d["fwd"].items()}
    print(f"[18d] {kcfg.name} x{kcfg.n_layers} bf16 params ({d['params']:,}, experts "
          f"{d['expert_bytes'] / 1e9:.2f} GB) unsharded ({card}): held {d['held_gib']:.2f} GiB, "
          f"peak {d['peak_gib']:.2f} GiB, forward b={mm['kimi_fwd'][0]} n={mm['kimi_fwd'][1]} "
          f"{fwd}, layer 0 drops {dropped} of {routed} routed pairs ({dropped / routed:.4f}); "
          f"f32 serving prefill {st_ref['prefill_seconds']:.3f} s, decode "
          f"{st_ref['decode_tokens'] / st_ref['decode_seconds']:.1f} tokens/s")
    for r, rk in enumerate(ranks):
        o = rk["d"]
        s_, st = o["serve"], o["serve"]["stats"]
        errs = {k_: rel_err(torch, torch.as_tensor(v["sample"]), torch.as_tensor(
            d["fwd"][k_]["sample"])) for k_, v in o["fwd"].items()}
        o["fwd_rel_err"] = errs
        fwd = {k_: f"{v['ms']:.1f} ms, peak {v['peak_gib']:.2f} GiB, {v['launches']} launches, "
                   f"{v['a2a_calls']} all-to-alls, rel_err {errs[k_]:.3e}"
               for k_, v in o["fwd"].items()}
        print(f"[18d] rank {r}: built in {o['build_s']:.1f} s (peak {o['build_peak_gib']:.2f} "
              f"GiB), expert bytes held {o['expert_share']:.4f} of unsharded, held "
              f"{o['held_gib']:.2f} GiB; forward, logits at every {spec['stride']}th position "
              f"against the unsharded run's {fwd} (f32 tol {DIST_FWD_TOL}; bf16 reported); f32 "
              f"serving prefill {st['prefill_seconds']:.3f} s, decode "
              f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s, "
              f"{st['decode_collectives'] / st['decode_tokens']:.1f} collectives per decode "
              f"token, all-to-all {s_['a2a_calls']} calls {s_['a2a_bytes'] / 1e6:.1f} MB over "
              f"the run ({s_['a2a_calls'] / st['decode_tokens']:.1f} per decode token), peak "
              f"{s_['peak_gib']:.2f} GiB, teacher-forced logits rel_err "
              f"{s_['teacher_rel_err']:.3e} (tol {SERVE_MESH_LOGIT_TOL}), launches "
              f"{s_['launches']}, statuses {s_['status']}")
        if abs(o["expert_share"] - 1 / world) > 1e-9:
            fail(f"[18d] rank {r}: holds {o['expert_share']} of the expert bytes")
        if not (errs["f32"] < DIST_FWD_TOL and all(v["finite"] for v in o["fwd"].values())):
            fail(f"[18d] rank {r}: the forward disagrees with the unsharded one: {errs}")
        for k_, v in o["fwd"].items():
            if v["launches"] != kernel_layers(torch, kcfg) or not v["a2a_calls"]:
                fail(f"[18d] rank {r}: the {k_} forward launched {v['launches']}, "
                     f"{v['a2a_calls']} all-to-alls")
        if not s_["teacher_rel_err"] < SERVE_MESH_LOGIT_TOL:
            fail(f"[18d] rank {r}: teacher-forced logits rel_err {s_['teacher_rel_err']}")
        if s_["tokens"] != ranks[0]["d"]["serve"]["tokens"]:
            fail(f"[18d] rank {r} emitted other tokens than rank 0")
        if any(s_["launches"]) or any(x != "ok" for x in s_["status"]):
            fail(f"[18d] rank {r}: launches {s_['launches']}, statuses {s_['status']}")
    prompts = serve_mesh_prompts(kcfg, mm["serve"])
    got = ranks[0]["d"]["serve"]["tokens"]
    for i, (p, w, g) in enumerate(zip(prompts, d["serve"]["tokens"], got)):
        if w == g:
            continue
        t = next(j for j, (x, y) in enumerate(zip(w, g)) if x != y)
        with plain_moe(1, world):
            gap, rms = serve_mesh_gap(torch, spec, mm["serve"], kimi_f32_cfg(kcfg), p, w, t)
        print(f"[18d] request {i} first differs at token {t}: unsharded top-2 gap {gap:.3e} "
              f"(limit {SERVE_MESH_TIE} x RMS {rms:.3e})")
        if not gap < SERVE_MESH_TIE * rms:
            fail(f"[18d] request {i} differs from the unsharded engine's tokens")
    summary["d"] = dict(ref={k_: v for k_, v in d.items() if k_ != "rank"},
                        tokens_equal=got == d["serve"]["tokens"])
    return summary


def moe_mesh_summary(mo) -> str:
    """Phase 18's summary line."""
    ranks = mo["ranks"]

    def tps(st):
        return round(st["decode_tokens"] / st["decode_seconds"], 1)

    def step_ms(o):  # after the first step
        return round(sum(o["step_ms"][1:]) / max(len(o["step_ms"]) - 1, 1), 1)

    ab = "; ".join(
        f"{MOE_MESH_PATHS[p_]}: ms/step per rank {[step_ms(rk[p_]) for rk in ranks]} "
        f"(unsharded {step_ms(mo['refs'][p_])}), peak GiB "
        f"{[round(rk[p_]['peak_gib'], 2) for rk in ranks]} (unsharded "
        f"{mo['refs'][p_]['peak_gib']:.2f})" for p_ in ("a", "b"))
    d = mo["d"]["ref"]
    return (f"[18] summary ({mo['card']}; {len(ranks)} ranks): {ab}; kimi-k2 x1 bf16 on 1x"
            f"{len(ranks)}: expert share per rank "
            f"{[round(rk['d']['expert_share'], 4) for rk in ranks]}, "
            f"held GiB {[round(rk['d']['held_gib'], 2) for rk in ranks]} (unsharded "
            f"{d['held_gib']:.2f}), f32 forward ms "
            f"{[round(rk['d']['fwd']['f32']['ms'], 1) for rk in ranks]} (unsharded "
            f"{d['fwd']['f32']['ms']:.1f}), f32 decode tokens/s per rank "
            f"{[tps(rk['d']['serve']['stats']) for rk in ranks]} (unsharded "
            f"{tps(d['serve']['stats'])}), tokens equal {mo['d']['tokens_equal']}")


# ---------------------------------------------------------------------------
# Phase 19: the cross-attention families and Adafactor on a mesh
# ---------------------------------------------------------------------------

CROSS_MESH_PATHS = {"a": "whisper-medium_x4_train_tp_1x2",
                    "b": "whisper-medium_x4_train_adafactor_dp_fsdp_2x1",
                    "c_fwd": "llama-3.2-vision-11b_x1_lm_apply_1x2",
                    "c_serve": "llama-3.2-vision-11b_x1_serve_1x2",
                    "d": "whisper-medium_x4_serve_dp_2x1"}


def cross_mesh_cfg(torch, spec, cm, vlm=False):
    """Phase 19's config, float32 activations: whisper-medium cut to
    ``cm["groups"]`` encoder and decoder groups (f32 params), or the VLM to
    ``cm["vlm_groups"]`` (bf16 params); the reduced ones, uncut, in a
    rehearsal."""
    from repro_torch.configs import get_config, get_reduced

    cfg = (get_reduced if spec["reduced"] else get_config)(cm["vlm"] if vlm else cm["whisper"])
    if not spec["reduced"]:
        cfg = (cfg.replace(n_groups=cm["vlm_groups"]) if vlm else
               cfg.replace(n_groups=cm["groups"], n_encoder_groups=cm["groups"]))
    return cfg.replace(dtype="float32", param_dtype="bfloat16" if vlm else "float32")


def kv_src_probe(eng):
    """After admission: this rank's block of the slot cache's ``kv_src``
    (on the host), the first slot it holds and the occupied slots."""
    from repro_torch.distributed import collectives as col

    kv = eng.caches["kv_src"]
    entry = None
    if eng.mesh is not None:
        spec = eng.state_store.placements.specs["kv_src"]
        entry = spec[0] if len(spec) else None
    lo = col.axis_rank(eng.mesh, entry) * kv.shape[0] if entry else 0
    return dict(kv=kv.float().cpu(), lo=lo,
                occupied=[i for i, st in enumerate(eng._slots) if st.rid is not None])


def cross_stat_err(torch, state, pl, ref_dir):
    """(b)'s Adafactor statistics against the unsharded run's: the largest
    over the row/col leaves of RMS(Δ) / RMS(ref), each leaf's sums summed
    over its blocks."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.distributed import collectives as col
    from repro_torch.distributed.sharding import Placements
    from repro_torch.tree import tree_items, tree_leaves

    v, specs = state.opt_state.v, pl.specs.opt_state.v
    ref = restore_checkpoint(ref_dir, v, placements=Placements(pl.mesh, specs))
    worst, leaves = 0.0, 0
    for (path, x), r_, spec in zip(tree_items(v), tree_leaves(ref), tree_leaves(specs)):
        if path.endswith(".full") or tuple(x.shape) == (1,):
            continue  # a placeholder (the leaf factors) or an unfactored leaf's full
        d, r2 = x.double() - r_.double(), r_.double()
        sums = torch.stack([d.square().sum(), r2.square().sum()])
        for entry in spec:
            if entry:
                sums = col.all_reduce_values(sums, pl.mesh, entry)
        worst = max(worst, math.sqrt(float(sums[0]) / max(float(sums[1]), 1e-300)))
        leaves += 1
    return worst, leaves


def cross_mesh_refs(torch, K, spec, cm, work):
    """Phase 19's unsharded runs in this process: whisper's AdamW (a) and
    Adafactor (b) training (params, and (b)'s statistics, saved under
    ``work``), the VLM's forward and engine (c), whisper's engine (d; its
    ``kv_src`` after admission saved for the ranks)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.models import lm_apply, lm_init
    from repro_torch.train import make_train_step, train_state_init

    dev = torch.device(spec["device"])
    steps = spec["steps"]
    wcfg = cross_mesh_cfg(torch, spec, cm)
    batch = dist_batch(torch, spec, wcfg, dev)
    out = {}
    for part, name in (("a", "adamw"), ("b", "adafactor")):
        opt = dist_opt(spec, wcfg, name)
        init = lambda: train_state_init(torch.Generator(device=dev).manual_seed(0), wcfg,  # noqa: B023
                                        opt, device=dev)
        gc.collect()
        torch.cuda.empty_cache()
        state, losses, times, _, peak = train_steps(
            torch, K, wcfg, init, make_train_step(wcfg, opt), batch, steps,
            f"[19{part} unsharded]")
        save_checkpoint(f"{work}/cross_{part}", steps, state.params)
        if part == "b":
            save_checkpoint(f"{work}/cross_b_v", steps, state.opt_state.v)
        out[part] = dict(losses=losses, step_ms=[t * 1e3 for t in times], peak_gib=peak / 2**30)
        del state
    del batch
    # (c): the VLM's forward (float32 activations, bf16 params) and engine
    vcfg = cross_mesh_cfg(torch, spec, cm, vlm=True)
    gc.collect()
    torch.cuda.empty_cache()
    dist_peak(torch, dev, reset=True)
    params = lm_init(torch.Generator(device=dev).manual_seed(0), vcfg, device=dev)
    held = torch.cuda.memory_allocated(dev) / 2**30 if dev.type == "cuda" else 0.0
    b, n = cm["vlm_fwd"]
    fwd_batch = {"tokens": dist_tokens(torch, vcfg.vocab, b, n).to(dev),
                 **source_extras(torch, vcfg, b, 5, device=dev)}
    dist_sync(torch, dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, _ = lm_apply(params, fwd_batch, vcfg)
    dist_sync(torch, dev)
    out["c_fwd"] = dict(sample=logits[:, ::spec["stride"]].float().cpu(),
                        ms=(time.perf_counter() - t0) * 1e3, held_gib=held,
                        peak_gib=dist_peak(torch, dev))
    del logits, fwd_batch
    sv = cm["vlm_serve"]
    out["c_serve"] = serve_mesh_once(torch, K, lambda: params, vcfg, None, dev, sv,
                                     teacher="self",
                                     extras=request_extras(torch, vcfg, len(sv["lens"]), 6))
    del params
    # (d): whisper's engine
    sw = cm["whisper_serve"]
    out["d"] = serve_mesh_once(torch, K, serve_mesh_params(torch, wcfg, dev), wcfg, None, dev,
                               sw, teacher="self",
                               extras=request_extras(torch, wcfg, len(sw["lens"]), 7),
                               probe=kv_src_probe)
    torch.save(out["d"]["probe"], f"{work}/cross_d_probe.pt")
    gc.collect()
    torch.cuda.empty_cache()
    return out


def cross_mesh_rank(torch, K, spec, cm, teach, work, dev, done):
    """One rank of phase 19 (a)-(d)."""
    from repro_torch.launch.mesh import make_host_mesh, make_serve_mesh

    world = spec["world"]
    wcfg, vcfg = cross_mesh_cfg(torch, spec, cm), cross_mesh_cfg(torch, spec, cm, vlm=True)
    out = {}
    for part, mesh, name in (("a", make_host_mesh(1, world, device=dev), "adamw"),
                             ("b", make_host_mesh(world, 1, device=dev), "adafactor")):
        state, pl, o = dist_train(torch, K, spec, wcfg, mesh, dev,
                                  opt=dist_opt(spec, wcfg, name))
        o["param_err"] = dist_param_err(torch, state, pl, f"{work}/cross_{part}", wcfg, dev)
        if part == "b":
            o["stat_err"] = cross_stat_err(torch, state, pl, f"{work}/cross_b_v")
        del state
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        out[part] = o
        done(f"[19] ({part})")
    tp = make_host_mesh(1, world, device=dev)
    b, n = cm["vlm_fwd"]
    K.taylor_fwd.launches = 0
    out["c_fwd"] = dist_forward(torch, spec, vcfg, tp, dist_tokens(torch, vcfg.vocab, b, n), dev,
                                extras=source_extras(torch, vcfg, b, 5, device=dev))
    out["c_fwd"]["launches"] = (K.taylor_fwd.launches, 0, 0)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    done("[19] (c) forward")
    sv, sw = cm["vlm_serve"], cm["whisper_serve"]
    out["c_serve"] = serve_mesh_once(torch, K, serve_mesh_params(torch, vcfg, dev), vcfg,
                                     make_serve_mesh(1, world, device=dev), dev, sv,
                                     teacher=teach["c_serve"],
                                     extras=request_extras(torch, vcfg, len(sv["lens"]), 6))
    done("[19] (c) serving")
    out["d"] = serve_mesh_once(torch, K, serve_mesh_params(torch, wcfg, dev), wcfg,
                               make_serve_mesh(world, 1, device=dev), dev, sw,
                               teacher=teach["d"],
                               extras=request_extras(torch, wcfg, len(sw["lens"]), 7),
                               probe=kv_src_probe)
    ref = torch.load(f"{work}/cross_d_probe.pt")
    p = out["d"].pop("probe")
    rows = ref["kv"][p["lo"]:p["lo"] + p["kv"].shape[0]]
    out["d"]["kv_src"] = dict(rel_err=rel_err(torch, p["kv"], rows), lo=p["lo"],
                              rows=p["kv"].shape[0], occupied=p["occupied"],
                              ref_occupied=ref["occupied"])
    done("[19] (d)")
    return out


def cross_mesh_report(torch, spec, cm, refs, ranks):
    """Phase 19's gates over every rank's results; prints each rank's
    numbers.  Returns the summary."""
    card = "no card"  # a CPU rehearsal
    if spec["device"] == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              check=True).stdout.strip().splitlines()[0]
    wcfg, vcfg = cross_mesh_cfg(torch, spec, cm), cross_mesh_cfg(torch, spec, cm, vlm=True)
    summary = {"ranks": ranks, "card": card}
    for part, name in (("a", f"{wcfg.name} x{wcfg.n_groups}+{wcfg.n_encoder_groups} AdamW tp "
                             f"1x2"),
                       ("b", f"{wcfg.name} x{wcfg.n_groups}+{wcfg.n_encoder_groups} Adafactor "
                             f"dp x fsdp 2x1")):
        ref = refs[part]
        for r, rk in enumerate(ranks):
            o = rk[part]
            print(f"[19{part}] {name} ({card}) rank {r}: losses "
                  f"{[round(x, 6) for x in o['losses']]} (unsharded "
                  f"{[round(x, 6) for x in ref['losses']]}), params per-leaf RMS(Δ)/RMS(update) "
                  f"max {o['param_err'][1]:.3e} (tol {DIST_PARAM_TOL})"
                  + (f", row/col statistics RMS(Δ)/RMS(ref) max {o['stat_err'][0]:.3e} over "
                     f"{o['stat_err'][1]} leaves (tol {CROSS_STAT_TOL})" if part == "b" else "")
                  + f", {[round(x, 1) for x in o['step_ms']]} ms/step (unsharded "
                  f"{[round(x, 1) for x in ref['step_ms']]}), held {o['held_gib']:.2f} GiB, peak "
                  f"{o['peak_gib']:.2f} GiB (unsharded peak {ref['peak_gib']:.2f}), launches "
                  f"fwd,dq,dkv per step {o['launches']}")
            if any(abs(x - y) > DIST_LOSS_TOL for x, y in zip(o["losses"], ref["losses"])):
                fail(f"[19{part}] rank {r}: losses {o['losses']} vs unsharded {ref['losses']}")
            if not o["param_err"][1] <= DIST_PARAM_TOL:
                fail(f"[19{part}] rank {r}: params differ from the unsharded run's: "
                     f"{o['param_err']}")
            if part == "b" and not (o["stat_err"][1] and o["stat_err"][0] <= CROSS_STAT_TOL):
                fail(f"[19b] rank {r}: the Adafactor statistics differ: {o['stat_err']}")
            if any(any(x) for x in o["launches"]):
                fail(f"[19{part}] rank {r}: a cross model launched a kernel: {o['launches']}")
    sample = torch.cat([torch.from_numpy(rk["c_fwd"]["sample"]) for rk in ranks], dim=1)
    err = rel_err(torch, sample, refs["c_fwd"]["sample"])
    b, n = cm["vlm_fwd"]
    print(f"[19c] {vcfg.name} x{vcfg.n_groups} bf16 params f32 forward tp 1x2 b={b} n={n} "
          f"images {vcfg.n_image_tokens}x{vcfg.vision_dim} ({card}): logits at every "
          f"{spec['stride']}th position vs unsharded rel_err {err:.3e} (tol {DIST_FWD_TOL}); ms "
          f"per rank {[round(rk['c_fwd']['ms'], 1) for rk in ranks]} (unsharded "
          f"{refs['c_fwd']['ms']:.1f}); peak per rank "
          f"{[round(rk['c_fwd']['peak_gib'], 2) for rk in ranks]} GiB (unsharded held "
          f"{refs['c_fwd']['held_gib']:.2f}, peak {refs['c_fwd']['peak_gib']:.2f}); taylor_fwd "
          f"launches per rank {[rk['c_fwd']['launches'][0] for rk in ranks]}")
    if not (err < DIST_FWD_TOL and all(rk["c_fwd"]["finite"] for rk in ranks)):
        fail(f"[19c] the sharded VLM forward disagrees with the unsharded one: {err}")
    if any(rk["c_fwd"]["launches"][0] for rk in ranks):
        fail("[19c] the VLM forward launched a kernel")
    summary["c_fwd"] = dict(rel_err=err, ref_ms=refs["c_fwd"]["ms"])
    for part, name, sm, cfg, seed in (
            ("c_serve", f"{vcfg.name} x{vcfg.n_groups} tp 1x2", cm["vlm_serve"], vcfg, 6),
            ("d", f"{wcfg.name} x{wcfg.n_groups}+{wcfg.n_encoder_groups} dp 2x1",
             cm["whisper_serve"], wcfg, 7)):
        ref, st_ref = refs[part], refs[part]["stats"]
        print(f"[19{part}] {name} ({card}): unsharded prefill {st_ref['prefill_seconds']:.3f} s, "
              f"decode {st_ref['decode_tokens'] / st_ref['decode_seconds']:.1f} tokens/s, "
              f"{ref['slot_bytes']} slot-cache bytes, held {ref['held_gib']:.2f} GiB, peak "
              f"{ref['peak_gib']:.2f} GiB")
        for r, rk in enumerate(ranks):
            o, st = rk[part], rk[part]["stats"]
            share = o["slot_bytes"] / ref["slot_bytes"]
            print(f"[19{part}] rank {r}: prefill {st['prefill_seconds']:.3f} s, decode "
                  f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s, "
                  f"{o['slot_bytes']} slot-cache bytes ({share:.4f} of unsharded), held "
                  f"{o['held_gib']:.2f} GiB, peak {o['peak_gib']:.2f} GiB, "
                  f"{st['decode_collectives'] / st['decode_tokens']:.1f} collectives per decode "
                  f"token ({o['collectives']} in all), wall {o['wall_s']:.1f} s, launches "
                  f"fwd,dq,dkv {o['launches']}, statuses {o['status']}, teacher-forced logits "
                  f"rel_err {o['teacher_rel_err']:.3e} (tol {SERVE_MESH_LOGIT_TOL})"
                  + (f", kv_src rows {o['kv_src']['lo']}..{o['kv_src']['lo'] + o['kv_src']['rows'] - 1}"
                     f" vs unsharded rel_err {o['kv_src']['rel_err']:.3e} (occupied "
                     f"{o['kv_src']['occupied']})" if "kv_src" in o else ""))
            if o["tokens"] != ranks[0][part]["tokens"]:
                fail(f"[19{part}] rank {r} emitted other tokens than rank 0")
            if any(o["launches"]):
                fail(f"[19{part}] rank {r}: serving launched a kernel: {o['launches']}")
            if not o["teacher_rel_err"] < SERVE_MESH_LOGIT_TOL:
                fail(f"[19{part}] rank {r}: teacher-forced logits rel_err {o['teacher_rel_err']}")
            if any(s_ != "ok" for s_ in o["status"]):
                fail(f"[19{part}] rank {r}: statuses {o['status']}")
            if part == "c_serve" and not 0.5 <= share < 1.0:
                fail(f"[19c] rank {r}: {share:.4f} of the slot-cache bytes")
            if part == "d":
                kv = o["kv_src"]
                if o["slot_bytes"] * sm["slots"] != ref["slot_bytes"] * (sm["slots"] //
                                                                         spec["world"]):
                    fail(f"[19d] rank {r}: {o['slot_bytes']} bytes, not "
                         f"{sm['slots'] // spec['world']} of {sm['slots']} slots")
                if not (kv["rel_err"] < SERVE_MESH_LOGIT_TOL and kv["occupied"] ==
                        kv["ref_occupied"] and kv["occupied"]):
                    fail(f"[19d] rank {r}: its kv_src block is not the unsharded engine's rows "
                         f"{kv}")
        prompts = serve_mesh_prompts(cfg, sm)
        exs = request_extras(torch, cfg, len(sm["lens"]), seed)
        for i, (p, w, g) in enumerate(zip(prompts, ref["tokens"], ranks[0][part]["tokens"])):
            if w == g:
                continue
            t = next(j for j, (x, y) in enumerate(zip(w, g)) if x != y)
            gap, rms = serve_mesh_gap(torch, spec, sm, cfg, p, w, t, exs[i])
            print(f"[19{part}] request {i} first differs at token {t}: unsharded top-2 gap "
                  f"{gap:.3e} (limit {SERVE_MESH_TIE} x RMS {rms:.3e})")
            if not gap < SERVE_MESH_TIE * rms:
                fail(f"[19{part}] request {i} differs from the unsharded engine's tokens")
        summary[part] = dict(tokens_equal=ref["tokens"] == ranks[0][part]["tokens"],
                             ref_stats=st_ref, ref_slot_bytes=ref["slot_bytes"])
    summary["refs"] = {k: refs[k] for k in ("a", "b")}
    return summary


def cross_mesh_summary(cx) -> str:
    """Phase 19's summary line."""
    def tps(st):
        return round(st["decode_tokens"] / st["decode_seconds"], 1)

    ranks = cx["ranks"]
    return (f"[19] summary ({cx['card']}; {len(ranks)} ranks, f32 activations): whisper-medium "
            f"x{CROSS_MESH['groups']}+{CROSS_MESH['groups']} AdamW tp 1x2 ms/step per rank "
            f"{[round(rk['a']['step_ms'][-1], 1) for rk in ranks]} (unsharded "
            f"{round(cx['refs']['a']['step_ms'][-1], 1)}), peak per rank "
            f"{[round(rk['a']['peak_gib'], 2) for rk in ranks]} GiB (unsharded "
            f"{cx['refs']['a']['peak_gib']:.2f}); Adafactor dp x fsdp 2x1 ms/step "
            f"{[round(rk['b']['step_ms'][-1], 1) for rk in ranks]} (unsharded "
            f"{round(cx['refs']['b']['step_ms'][-1], 1)}), peak "
            f"{[round(rk['b']['peak_gib'], 2) for rk in ranks]} GiB (unsharded "
            f"{cx['refs']['b']['peak_gib']:.2f}); VLM x{CROSS_MESH['vlm_groups']} forward rel_err "
            f"{cx['c_fwd']['rel_err']:.2e}; decode tokens/s per rank: VLM tp 1x2 "
            f"{[tps(rk['c_serve']['stats']) for rk in ranks]} (unsharded "
            f"{tps(cx['c_serve']['ref_stats'])}), whisper dp 2x1 "
            f"{[tps(rk['d']['stats']) for rk in ranks]} (unsharded {tps(cx['d']['ref_stats'])}); "
            f"tokens equal {cx['c_serve']['tokens_equal']} / {cx['d']['tokens_equal']}")


def breadth_launches(br, name):
    """Phase 15's launches of kernel ``name`` by path, for the kernels line."""
    i = ("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv").index(name)
    a, c = br["a"], br["c"]
    out = {f"smollm-135m_launcher_{opt}_{BREADTH_STEPS}_steps": a[opt]["launches"][name]
           for opt in ("adamw", "adafactor", "sgdm")}
    out.update({f"smollm-135m_{opt}_{BREADTH_STEPS}_steps": a[opt]["launches"][name]
                for opt in ("adamw_bf16_moments", "adafactor_no_momentum")})
    out.update({f"smollm-135m_remat_{r}_step": br["b"][r]["launches"][i] for r in REMATS})
    out.update({f"qwen2-1.5b_launcher_adafactor_{run}": c[run]["launches"][name]
                for run in ("uninterrupted", "control", "stopped", "resumed")})
    out["qwen2-1.5b_adamw_bf16_2_steps"] = c["adamw_bf16"]["launches"][name]
    out[f"zamba2-7b_whole_train_{ZAMBA_WHOLE_STEPS}_steps"] = br["d"]["launches"][name]
    out["smollm-135m_step_after_jax_restore"] = br["e"]["launches"][i]
    return out


def cross_launches(cross, name):
    """Phase 14's launches of kernel ``name`` by path, for the kernels line
    (all 0: the kernels' envelope excludes cross models)."""
    i = ("taylor_fwd", "taylor_bwd_dq", "taylor_bwd_dkv").index(name)
    w, v = cross["whisper-medium"], cross["llama-3.2-vision-11b"]
    out = {f"whisper-medium_train_{WHISPER_TRAIN_STEPS}_steps": w["train"]["launches"][name],
           "whisper-medium_serving": cross["launches"]["whisper_serving"][i],
           "llama-3.2-vision-11b_serving": cross["launches"]["vlm_serving"][i],
           f"llama-3.2-vision-11b_x{VLM_TRAIN_GROUPS}_train_{VLM_TRAIN['steps']}_steps":
               v["train"]["launches"][name]}
    if name == "taylor_fwd":
        out.update({f"{arch}_lm_apply": cross[arch]["forward"]["launches"]
                    for arch in CROSS_ARCHS})
    return out


def zoo_launches(zoo, name):
    """Phase 12's launches of kernel ``name`` by path, for the kernels line."""
    out = {f"{arch}_train_{ZOO_TRAIN_STEPS[arch]}_steps": zoo[arch]["train"]["launches"][name]
           for arch in ZOO_TRAIN_STEPS}
    if name == "taylor_fwd":
        out.update({f"{arch}_lm_apply": zoo[arch]["forward"]["launches"]
                    for arch in ("qwen2-1.5b", "granite-20b", "qwen2-moe-a2.7b")})
    out[f"train_resume_{zoo['scripts']['steps']}_steps"] = zoo["scripts"]["launches"][name]
    return out


def ssm_launches(ssm, name):
    """Phase 13's launches of kernel ``name`` by path, for the kernels line."""
    out = {f"{arch}_train_{SSM_TRAIN_STEPS[arch]}_steps": ssm[arch]["train"]["launches"][name]
           for arch in SSM_TRAIN_STEPS}
    if name == "taylor_fwd":
        out.update({f"{arch}_lm_apply": ssm[arch]["forward"]["launches"] for arch in ssm})
    return out


def zoo_rows(zoo, name):
    """Phase 12 (b)'s rows of kernel ``name``, one per ZOO_CASES case: {case: row}."""
    return {case: dict(row[name], shape=row["shape"]) for case, row in zoo["cases"].items()}


# Phase 20: the dry run against the card.  (a)'s peak ratio, predicted
# over measured, must lie in [1 / PEAK_RATIO, PEAK_RATIO].
PEAK_RATIO = 2.0
DRYRUN_CELL = ("smollm-135m", "train_4k")  # (d): one production cell on the 16×16 pod


def record_table(records):
    """{(kind, site): [calls, result bytes]} of a rank's collective records."""
    out = {}
    for kind, nbytes, _, site in records:
        row = out.setdefault((kind, site), [0, 0])
        row[0] += 1
        row[1] += nbytes
    return out


def phase_dryrun(torch, K, cfg, train, dist, smi):
    """Phase 20: the analysis layer's predictions held to the card.  (a)
    phase 7's step traced on a 1×1 ``AbstractMesh`` (FLOPs, peak live bytes)
    against one real step of the same config under ``FlopCounterMode``; (b)
    its roofline on the H100 beside phase 7's ms/step; (c) phase 16 (a)'s
    rank programs traced on an abstract 1×2 mesh against the records each
    rank made in its step 2; (d) one production cell of the dry run."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.flops import trace
    from repro_torch.analysis.roofline import H100, roofline_report
    from repro_torch.data import make_task
    from repro_torch.distributed import api as dist_api
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh, abstract_production_mesh
    from repro_torch.launch.train import make_sharded_state_and_step
    from repro_torch.models.config import count_active_params
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.train import make_train_step, train_state_init

    out = {}
    t_phase = time.perf_counter()
    meta = torch.device("meta")
    # (a) phase 7's step: predicted on a 1×1 abstract mesh, then run once
    tr = TRAIN
    opt = adamw(cosine_warmup(tr["lr"], tr["warmup"], tr["steps"]))
    batch = bigram_batch(torch, make_task, cfg)
    shapes = {k_: torch.empty_like(x, device=meta) for k_, x in batch.items()}
    t0 = time.perf_counter()
    mesh = AbstractMesh((1, 1), ("data", "model"))
    state, step, _, _ = make_sharded_state_and_step(cfg, opt, mesh,
                                                    dist_api.rules_for_mesh(mesh), shapes,
                                                    device=meta)
    pred = trace(step, state, shapes)
    del state
    predict_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    state = train_state_init(torch.Generator(device="cuda").manual_seed(0), cfg, opt)
    real_step = make_train_step(cfg, opt)
    c0 = taylor_counters(K)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        state, m = real_step(state, batch)
        float(m["loss"])
    torch.cuda.synchronize()
    real_peak = torch.cuda.max_memory_allocated()
    launches = tuple(a - b for a, b in zip(taylor_counters(K), c0))
    del state
    real_flops = fc.get_total_flops()
    ratio = pred.peak_bytes / real_peak
    print(f"[20a] smollm-135m {cfg.dtype} remat={cfg.remat} AdamW b={tr['b']} n={tr['n']}: "
          f"predicted (1x1 abstract mesh, traced in {predict_s:.1f} s) matmul FLOPs "
          f"{pred.counts['matmul_flops']:.6e}, all FLOPs {pred.counts['flops']:.6e}, bytes "
          f"{pred.counts['bytes']:.6e}; one real step under FlopCounterMode: {real_flops:.6e} "
          f"FLOPs, launches fwd,dq,dkv {launches}")
    print(f"[20a] peak bytes predicted {pred.peak_bytes} ({pred.peak_bytes / 2**30:.3f} GiB) vs "
          f"measured {real_peak} ({real_peak / 2**30:.3f} GiB): ratio {ratio:.4f} "
          f"(fails outside [{1 / PEAK_RATIO}, {PEAK_RATIO}]) on {smi}")
    if real_flops != pred.counts["matmul_flops"]:
        fail(f"[20a] the real step's FLOPs {real_flops} differ from the predicted "
             f"{pred.counts['matmul_flops']}")
    if launches != kernel_launches_per_step(torch, cfg):
        fail(f"[20a] the real step launched {launches}, expected "
             f"{kernel_launches_per_step(torch, cfg)}")
    if not 1 / PEAK_RATIO <= ratio <= PEAK_RATIO:
        fail(f"[20a] predicted peak bytes / measured = {ratio}")
    out["a"] = dict(matmul_flops=pred.counts["matmul_flops"], flops=pred.counts["flops"],
                    bytes=pred.counts["bytes"], real_flops=real_flops,
                    peak_pred=pred.peak_bytes, peak_real=real_peak, peak_ratio=ratio,
                    launches=launches)

    # (b) the roofline on the H100 beside phase 7's measured step
    model_flops = 6.0 * count_active_params(cfg) * tr["b"] * tr["n"]
    rep = roofline_report(pred.counts, pred.records, 1, H100, model_flops=model_flops)
    step_s = train["step_ms"] / 1e3
    share = model_flops / (step_s * H100.peak_flops)
    print(f"[20b] roofline on {H100.name}: compute {rep['compute_s'] * 1e3:.4f} ms, memory "
          f"{rep['memory_s'] * 1e3:.4f} ms, collective {rep['collective_s'] * 1e3:.4f} ms; "
          f"t_lower_bound {rep['t_lower_bound_s'] * 1e3:.4f} ms ({rep['dominant']}) vs phase "
          f"7's {train['step_ms']:.1f} ms/step; model FLOPs {model_flops:.6e}, share of the "
          f"bf16 peak (model_flops / (step s x {H100.peak_flops:.0f})) {share:.4%} on {smi}")
    out["b"] = dict(t_lower_bound_ms=rep["t_lower_bound_s"] * 1e3, dominant=rep["dominant"],
                    step_ms=train["step_ms"], model_flops=model_flops, peak_share=share)

    # (c) phase 16 (a)'s rank programs on an abstract 1×2 mesh vs each rank's step 2
    dcfg = dist_cfg(torch, DIST, "arch", DIST["ab_groups"])
    dbatch = {k_: torch.empty_like(x, device=meta)
              for k_, x in dist_batch(torch, DIST, dcfg, torch.device("cpu")).items()}
    out["c"] = []
    for r, rank_out in enumerate(dist["a"]):
        mesh = AbstractMesh((1, DIST["world"]), ("data", "model"), (0, r))
        state, step, _, _ = make_sharded_state_and_step(dcfg, dist_opt(DIST, dcfg), mesh,
                                                        dist_api.rules_for_mesh(mesh), dbatch,
                                                        device=meta)
        want = record_table(tuple(x) for x in trace(step, state, dbatch).records)
        got = record_table(rank_out["records"])
        del state
        bad = sorted(k_ for k_ in set(want) | set(got) if want.get(k_) != got.get(k_))
        print(f"[20c] {DIST['arch']} x{DIST['ab_groups']} tp 1x2 rank {r}: predicted "
              f"{sum(v[0] for v in want.values())} collectives, {sum(v[1] for v in want.values())} "
              f"result bytes over {len(want)} (kind, site) rows; step 2 recorded "
              f"{sum(v[0] for v in got.values())}, {sum(v[1] for v in got.values())}; rows that "
              f"differ: {[(k_, want.get(k_), got.get(k_)) for k_ in bad[:5]]}")
        if bad:
            fail(f"[20c] rank {r}'s collectives differ from the abstract mesh's prediction")
        out["c"].append(dict(calls=sum(v[0] for v in got.values()),
                             bytes=sum(v[1] for v in got.values()), rows=len(got)))

    # (d) one production cell
    t0 = time.perf_counter()
    rec, _ = dryrun.lower_cell(*DRYRUN_CELL, abstract_production_mesh())
    print(f"[20d] {DRYRUN_CELL[0]} x {DRYRUN_CELL[1]} x pod in {time.perf_counter() - t0:.1f} s: "
          + json.dumps({k_: v for k_, v in rec.items() if k_ != "roofline"})
          + " roofline " + json.dumps({k_: v for k_, v in rec["roofline"].items()
                                       if k_ not in ("collective_breakdown", "walker")}))
    out["d"] = dict(fits_hbm=rec["fits_hbm"], peak=rec["hbm_peak_bytes_per_chip"],
                    dominant=rec["roofline"]["dominant"])
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[20] phase 20 took {out['phase_s']:.1f} s")
    return out


def main() -> int:
    # phase 12 trains billion-parameter models next to what serving left
    # allocated: growable segments keep the allocator from fragmenting
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.core.feature_map import layernorm_no_affine
    from repro_torch.kernels.taylor_attention import kernel as K
    from repro_torch.kernels.taylor_attention import ops
    from repro_torch.kernels.taylor_attention import ref as ref_mod
    from repro_torch.data import make_task
    from repro_torch.models import lm_apply, lm_decode_step, lm_init, lm_init_caches
    from repro_torch.optim import adamw, cosine_warmup
    from repro_torch.serve import Request, ServeEngine
    from repro_torch.train import loss_and_grads, make_loss_fn, make_train_step
    from repro_torch.train import train_state_init
    from repro_torch.tree import tree_leaves

    # ---- 1. device ----
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 2. build (one nvcc per source, in parallel) ----
    t0 = time.perf_counter()
    K.build()
    print(f"[2] built {', '.join(K.SOURCES)} in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary(K.build_log):
        print(f"[2] {line}")
    count, spills = ptxas_spills(K.build_log)
    print(f"[2] ptxas: {count} kernel instantiations (every d and order), "
          f"{len(spills)} with spills" + "".join(f"\n[2]   {x}" for x in spills))

    # ---- 3. kernels against their plain versions ----
    ln = layernorm_no_affine
    krows = phase_kernel(torch, K, ops, ref_mod, ln)
    brows = phase_backward(torch, K, ops, ref_mod, ln)

    # ---- 4. full-width forward through the kernel ----
    cfg = get_config("smollm-135m")
    params = lm_init(torch.Generator().manual_seed(0), cfg)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (4, 1024), generator=gen).cuda()
    K.taylor_fwd.launches = 0
    with torch.no_grad():
        logits, _ = lm_apply(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    launches = K.taylor_fwd.launches
    print(f"[4] lm_apply smollm-135m b=4 n=1024 {cfg.dtype}: taylor_fwd launches={launches}")
    if launches != cfg.n_layers:
        fail(f"lm_apply launched taylor_fwd {launches} times, expected {cfg.n_layers}")
    if logits.shape != (4, 1024, cfg.vocab) or not torch.isfinite(logits).all():
        fail("lm_apply logits have the wrong shape or are not finite")
    infer = torch.no_grad()(lm_apply)
    ref_logits, _ = infer(params, {"tokens": tokens}, cfg.replace(attn_impl="torch"))
    fwd_err = rel_err(torch, logits, ref_logits)
    agree = float((logits.argmax(-1) == ref_logits.argmax(-1)).float().mean())
    fwd_ms = cuda_ms(torch, lambda: infer(params, {"tokens": tokens}, cfg), 3)
    ref_ms = cuda_ms(
        torch, lambda: infer(params, {"tokens": tokens}, cfg.replace(attn_impl="torch")), 3
    )
    print(f"[4] logits vs attn_impl='torch': rel_err={fwd_err:.3e} argmax_agree={agree:.4f} "
          f"forward_ms={fwd_ms:.2f} forward_ms(torch attention)={ref_ms:.2f}")
    # bf16 activations: both paths round each layer's attention output to bf16
    # after float32 sums taken in different orders; over 30 layers that moves
    # logits by a few bf16 ulps of their range.  (argmax agreement is only
    # reported: random weights give many near-tied logits.)
    if not fwd_err < 5e-2:
        fail(f"kernel forward disagrees with the torch forward: rel err {fwd_err}")
    cfg32 = cfg.replace(dtype="float32")
    err32 = rel_err(torch, infer(params, {"tokens": tokens}, cfg32)[0],
                    infer(params, {"tokens": tokens}, cfg32.replace(attn_impl="torch"))[0])
    print(f"[4] float32 activations: logits rel_err kernel vs torch = {err32:.3e} (tol 1e-3)")
    if not err32 < 1e-3:
        fail(f"float32 kernel forward disagrees with the torch forward: {err32}")
    qa = torch.randn(4, cfg.n_heads, 1024, 64, device="cuda", dtype=torch.bfloat16)
    ka, va = (torch.randn(4, cfg.n_kv_heads, 1024, 64, device="cuda", dtype=torch.bfloat16)
              for _ in range(2))
    with torch.no_grad():
        layer_ms = cuda_ms(torch, lambda: ops.taylor_attention_kernel_trainable(qa, ka, va), 5)
    del logits, ref_logits
    print(f"[4] one layer's taylor_attention_kernel_trainable at b=4 n=1024 bf16 (with layout and "
          f"LayerNorm): {layer_ms:.4f} ms; x{cfg.n_layers} layers = "
          f"{cfg.n_layers * layer_ms:.2f} ms of the {fwd_ms:.2f} ms forward")

    # ---- 5. serving ----
    K.taylor_fwd.launches = 0
    prompts, outs, st, wall, _ = serve_requests(torch, ServeEngine, Request, params, cfg)
    print(f"[5] served {len(outs)} requests x {MAX_NEW} tokens on 4 slots in {wall:.2f} s: "
          f"prefill {st['prefill_seconds']:.3f} s over {st['prefill_dispatches']} dispatches "
          f"({st['prefill_tokens']} tokens), decode {st['decode_tokens']} tokens in "
          f"{st['decode_seconds']:.3f} s = {st['decode_tokens'] / st['decode_seconds']:.1f} "
          f"tokens/s, taylor_fwd launches {K.taylor_fwd.launches}")

    # one decode step of 4 slots: host time to enqueue it vs time to finish it
    caches = lm_init_caches(cfg, 4, 1024)
    tok = torch.zeros(4, dtype=torch.int64, device="cuda")
    pos = torch.full((4,), 100, dtype=torch.int32, device="cuda")
    lm_decode_step(params, tok, caches, pos, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lm_decode_step(params, tok, caches, pos, cfg)
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    print(f"[5] one decode step (4 slots, 30 layers): host enqueue {enqueue_ms:.2f} ms, "
          f"finished after {step_ms:.2f} ms")

    # ---- 6. cross-check in float32: engine tokens vs lm_apply argmax ----
    prompts, outs, st, _, _ = serve_requests(torch, ServeEngine, Request, params, cfg32)
    mismatches, near_ties = cross_check(torch, infer, params, cfg32, prompts, outs)
    print(f"[6] f32 engine tokens vs lm_apply argmax over {len(outs) * MAX_NEW} positions: "
          f"mismatches={mismatches} near_ties(gap<{NEAR_TIE})={near_ties}; f32 decode "
          f"{st['decode_tokens'] / st['decode_seconds']:.1f} tokens/s")
    if mismatches:
        fail(f"{mismatches} engine tokens differ from the kernel forward's argmax")

    # ---- 7. full-width training through the kernels ----
    del params
    train = phase_train(torch, K, cfg, make_task, adamw, cosine_warmup, train_state_init,
                        make_train_step, make_loss_fn, loss_and_grads, tree_leaves)

    # ---- 8. the baselines at full width ----
    serve_fn = lambda p_, c_: serve_requests(torch, ServeEngine, Request, p_, c_)
    cross_fn = lambda p_, c_, prompts_, outs_: cross_check(torch, infer, p_, c_, prompts_, outs_)
    base_summary, base_launches = phase_baselines(torch, K, infer, serve_fn, cross_fn)

    # ---- 9. the hybrid schedule and the Taylor variants at full width ----
    hybrid = phase_hybrid(torch, K, infer, serve_fn, cross_fn, (prompts, outs, st))
    print("[9] summary (smollm-135m full width; forward b=4 n=1024 bf16, training b=4 n=1024 "
          "bf16 remat full, decode f32 on 4 slots): "
          f"hybrid: forward {hybrid['forward_ms']:.2f} ms, train "
          f"{hybrid['train_ms_per_step']:.1f} ms/step ({hybrid['train_tokens_per_s']:.0f} "
          f"tokens/s, peak {hybrid['peak_gib']:.2f} GiB), decode "
          f"{hybrid['decode_tokens_per_s']:.1f} tokens/s, prefill {hybrid['prefill_s']:.3f} s, "
          f"{hybrid['slot_bytes']} bytes per slot (order-2 taylor {hybrid['taylor_slot_bytes']}); "
          f"sym_state: decode {hybrid['sym_state']['decode_tokens_per_s']:.1f} tokens/s "
          f"(full {hybrid['sym_state']['full_decode_tokens_per_s']:.1f}), "
          f"{hybrid['sym_state']['slot_bytes']} bytes per slot "
          f"(full {hybrid['sym_state']['full_slot_bytes']}); decay {DECAY}: train "
          f"{hybrid['decay']['train_ms_per_step']:.1f} ms/step, decode "
          f"{hybrid['decay']['decode_tokens_per_s']:.1f} tokens/s")

    # ---- 10. serving under load at full width ----
    load = phase_serving_load(torch, K, infer, (prompts, outs, st))
    print("[10] summary (smollm-135m full width, order 2, f32, 4 slots): chunked prefill "
          f"{load['chunked_order2']['chunked_s'] * 1e3:.1f} ms vs whole "
          f"{load['chunked_order2']['whole_s'] * 1e3:.1f} ms at {CHUNK_CASES[0][0]} tokens; "
          f"TTFT of the urgent {URGENT[0][0]}-token request {load['ttft_ms']['slo']:.1f} ms "
          f"(SLO) vs {load['ttft_ms']['fifo']:.1f} ms (FIFO); replay "
          f"{load['replay']['wall_s']:.2f} s wall, decode "
          f"{load['replay']['decode_tokens_per_s']:.1f} tokens/s; sweep "
          f"{load['health_ms']:.3f} ms per block")

    # ---- 11. speculative decoding and the slot-state codecs at full width ----
    t0 = time.perf_counter()
    spec = phase_spec_state(torch, K, infer, (prompts, outs, st),
                            base_summary["softmax"]["tokens"])
    print(f"[11] phase 11 took {time.perf_counter() - t0:.1f} s")
    print("[11] summary (smollm-135m full width, order 2, f32, 4 slots): dispatches per "
          f"emitted token plain(decode_block=1) {spec['plain_db1']['dispatches_per_token']:.3f}, "
          f"ngram {spec['ngram']['dispatches_per_token']:.3f} (acceptance "
          f"{spec['ngram']['acceptance']:.3f}), order1 "
          f"{spec['order1']['dispatches_per_token']:.3f} (acceptance "
          f"{spec['order1']['acceptance']:.3f}); decode tokens/s plain(decode_block=1) "
          f"{spec['plain_db1']['tokens_per_s']:.1f}, ngram {spec['ngram']['tokens_per_s']:.1f}, "
          f"order1 {spec['order1']['tokens_per_s']:.1f}; bytes per slot int8 "
          f"{spec['int8']['slot_bytes']} ({spec['int8']['ratio']:.4f} of dense), fp8 "
          f"{spec['fp8']['slot_bytes']}; paged softmax peak {spec['paged']['peak_pages']} of "
          f"{spec['paged']['total_pages']} pages")

    # ---- 12. the model zoo's dense and MoE decoders ----
    t0 = time.perf_counter()
    zoo = phase_zoo(torch, K, ref_mod, ln, infer)
    q, g, e = zoo["qwen2-1.5b"], zoo["granite-20b"], zoo["qwen2-moe-a2.7b"]
    print(f"[12] phase 12 took {time.perf_counter() - t0:.1f} s")
    print("[12] summary (full widths; forward and training b=4 n=1024 bf16 remat full, "
          "serving f32): qwen2-1.5b forward "
          f"{q['forward']['forward_ms']:.2f} ms, train {q['train']['step_ms']:.1f} ms/step "
          f"({q['train']['tokens_per_s']:.0f} tokens/s, peak {q['train']['peak_gib']:.2f} GiB), "
          f"decode {q['serve']['decode_tokens_per_s']:.1f} tokens/s at "
          f"{q['serve']['slot_bytes']} bytes per slot; granite-20b x{ZOO_DEPTH['granite-20b']} "
          f"groups train {g['train']['step_ms']:.1f} ms/step, decode "
          f"{g['serve']['decode_tokens_per_s']:.1f} tokens/s at {g['serve']['slot_bytes']} "
          f"bytes per slot; gemma-7b x{ZOO_DEPTH['gemma-7b']} decode "
          f"{zoo['gemma-7b']['decode_tokens_per_s']:.1f} tokens/s at "
          f"{zoo['gemma-7b']['slot_bytes']} bytes per slot; qwen2-moe-a2.7b "
          f"x{ZOO_DEPTH['qwen2-moe-a2.7b']} train (ep) {e['train']['step_ms']:.1f} ms/step, "
          f"decode {e['serve']['decode_tokens_per_s']:.1f} tokens/s")

    # ---- 13. Mamba2 (SSD): mamba2-780m and zamba2-7b ----
    t0 = time.perf_counter()
    ssm = phase_ssm(torch, K, infer)
    a, z = ssm["mamba2-780m"], ssm["zamba2-7b"]
    print(f"[13] phase 13 took {time.perf_counter() - t0:.1f} s")
    print("[13] summary (full widths; forward and training b=4 n=1024 bf16 remat full, "
          f"serving f32): mamba2-780m forward {a['forward']['forward_ms']:.2f} ms, train "
          f"{a['train']['step_ms']:.1f} ms/step ({a['train']['tokens_per_s']:.0f} tokens/s, "
          f"peak {a['train']['peak_gib']:.2f} GiB), decode "
          f"{a['serve']['decode_tokens_per_s']:.1f} tokens/s at {a['serve']['slot_bytes']} "
          f"bytes per slot; zamba2-7b forward {z['forward']['forward_ms']:.2f} ms "
          f"({z['forward']['launches']} taylor_fwd launches), decode "
          f"{z['serve']['decode_tokens_per_s']:.1f} tokens/s at {z['serve']['slot_bytes']} "
          f"bytes per slot (int8 {z['int8_slot_bytes']}); zamba2-7b x{SSM_TRAIN_GROUPS} "
          f"groups train {z['train']['step_ms']:.1f} ms/step, peak "
          f"{z['train']['peak_gib']:.2f} GiB")

    # ---- 14. cross-attention: whisper-medium and llama-3.2-vision-11b ----
    t0 = time.perf_counter()
    cross = phase_cross(torch, K, infer)
    w, wb, v = cross["whisper-medium"], cross["whisper-medium-softmax"], cross[
        "llama-3.2-vision-11b"]
    print(f"[14] phase 14 took {time.perf_counter() - t0:.1f} s")
    print("[14] summary (full widths; forward n=1024 bf16, training b=4 n=1024 bf16 remat "
          f"full, serving f32; no kernel launches): whisper-medium forward (b=4) "
          f"{w['forward']['forward_ms']:.2f} ms, train {w['train']['step_ms']:.1f} ms/step "
          f"({w['train']['tokens_per_s']:.0f} tokens/s, peak {w['train']['peak_gib']:.2f} GiB), "
          f"decode {w['serve']['decode_tokens_per_s']:.1f} tokens/s at "
          f"{w['serve']['slot_bytes']} bytes per slot (int8 {w['int8']['slot_bytes']}), softmax "
          f"baseline decode {wb['decode_tokens_per_s']:.1f} tokens/s at {wb['slot_bytes']} bytes "
          f"per slot; llama-3.2-vision-11b forward (b=2) {v['forward']['forward_ms']:.2f} ms, "
          f"decode {v['serve']['decode_tokens_per_s']:.1f} tokens/s at "
          f"{v['serve']['slot_bytes']} bytes per slot; x{VLM_TRAIN_GROUPS} group "
          f"({v['train_params']} params) train {v['train']['step_ms']:.1f} ms/step, peak "
          f"{v['train']['peak_gib']:.2f} GiB")

    # ---- 15. training breadth: optimizers, remat, the launcher, checkpoints ----
    t0 = time.perf_counter()
    breadth = phase_breadth(torch, K, q["train"]["peak_gib"])
    a, c, d = breadth["a"], breadth["c"], breadth["d"]
    print(f"[15] phase 15 took {time.perf_counter() - t0:.1f} s")
    print("[15] summary (full widths; b=4 n=1024 bf16 activations, remat full): smollm-135m "
          "ms/step (peak GiB) through the launcher: " + ", ".join(
              f"{k} {a[k]['step_ms']:.1f} ({a[k]['peak_gib']:.2f})"
              for k in ("adamw", "adafactor", "sgdm", "adamw_bf16_moments",
                        "adafactor_no_momentum")) +
          "; one step (forward + backward) per remat mode: " + ", ".join(
              f"{r} {breadth['b'][r]['step_ms']:.1f} ms ({breadth['b'][r]['peak_gib']:.2f} GiB)"
              for r in REMATS) +
          f"; qwen2-1.5b Adafactor {c['uninterrupted']['step_ms']:.1f} ms/step, peak "
          f"{c['uninterrupted']['peak_gib']:.2f} GiB, AdamW bf16 moments peak "
          f"{c['adamw_bf16']['peak_gib']:.2f} GiB (f32 {q['train']['peak_gib']:.2f}); zamba2-7b "
          f"whole (bf16 params, Adafactor without momentum) {d['step_ms']:.1f} ms/step, peak "
          f"{d['peak_gib']:.2f} GiB")

    # ---- 16. distributed training on a mesh ----
    t0 = time.perf_counter()
    dist = phase_distributed(torch, K)
    a0, c0 = dist["a"][0], dist["c_train"][0]
    print(f"[16] phases 16-19 took {time.perf_counter() - t0:.1f} s (phase 17's unsharded "
          f"engines {dist['serve_refs_s']:.1f} s, phase 18's unsharded runs "
          f"{dist['moe_refs_s']:.1f} s, phase 19's {dist['cross_refs_s']:.1f} s of it)")
    print(f"[16] summary (qwen2-1.5b x{DIST['ab_groups']} of 28, f32, b={DIST['b']} "
          f"n={DIST['n']} remat full, "
          f"AdamW; {DIST['world']} ranks): tp 1x2 {sum(a0['step_ms'][1:]) / max(len(a0['step_ms']) - 1, 1):.1f} ms/step "
          f"(rank 0), peak per rank {[round(x['peak_gib'], 2) for x in dist['a']]} GiB vs "
          f"unsharded {dist['ref']['peak_gib']:.2f} GiB at "
          f"{sum(dist['ref']['step_ms'][1:]) / max(len(dist['ref']['step_ms']) - 1, 1):.1f} ms/step; dp x fsdp 2x1 peak per rank "
          f"{[round(x['peak_gib'], 2) for x in dist['b']]} GiB; cp 1x2 training "
          f"{sum(c0['step_ms'][1:]) / max(len(c0['step_ms']) - 1, 1):.1f} ms/step; cp forward n={DIST['cp_fwd'][1]} "
          f"peak per rank {dist['c']['peak_gib']} GiB vs unsharded "
          f"{dist['c']['ref_peak_gib']:.2f}; mamba2-780m cp forward n={DIST['ssd_fwd'][1]} "
          f"rel_err {dist['d']['rel_err']:.2e}")

    # ---- 17. serving on a mesh (run in phase 16's spawn) ----
    print(serve_mesh_summary(dist["serve"]))

    # ---- 18. MoE on a mesh (run in phase 16's spawn) ----
    print(moe_mesh_summary(dist["moe"]))

    # ---- 19. the cross families and Adafactor on a mesh (phase 16's spawn) ----
    print(cross_mesh_summary(dist["cross"]))

    # ---- 20. the dry run against the card ----
    dry = phase_dryrun(torch, K, cfg, train, dist, smi)

    # ---- 21. kernels line ----
    row = krows["bfloat16"]
    shape = dict(MAIN, dtype="bfloat16")
    src = "src/repro_torch/kernels/taylor_attention/"
    kernels = [{
        "name": "taylor_fwd",
        "route": "cuda",
        "source": src + "csrc/taylor_fwd.cu",
        "replaces": "src/repro/kernels/taylor_attention/kernel.py:107",
        "launches": train["launches"]["taylor_fwd"],
        "launches_by_path": {
            "lm_apply": launches, "train_8_steps": train["launches"]["taylor_fwd"],
            "order1_lm_apply": base_launches["lm_apply"],
            f"order1_train_{BASELINE_STEPS}_steps": base_launches["train"]["taylor_fwd"],
            "hybrid_lm_apply": hybrid["lm_apply_launches"]["taylor_fwd"],
            f"hybrid_train_{HYBRID_STEPS}_steps": hybrid["train_launches"]["taylor_fwd"],
            "phase11_serving": spec["launches"],
            "phase20_step": dry["a"]["launches"][0],
            **zoo_launches(zoo, "taylor_fwd"),
            **ssm_launches(ssm, "taylor_fwd"),
            **cross_launches(cross, "taylor_fwd"),
            **breadth_launches(breadth, "taylor_fwd"),
            **dist_launches(dist, "taylor_fwd")},
        "max_abs_err": row["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],  # tensor cores: the products as the kernel issues them
        "bound_by": row["bound_by"],
        "library_ms": None,
        "bound_f32_cores_ms": row["bound_f32_cores_ms"],
        "ms_train_shape": krows[case_name(TRAIN_ATTN, "bfloat16")]["ms"],
        "plain_ms_train_shape": krows[case_name(TRAIN_ATTN, "bfloat16")]["plain_ms"],
        "shape": shape,
        "zoo_cases": zoo_rows(zoo, "taylor_fwd"),
    }]
    for name, line in (("taylor_bwd_dq", 55), ("taylor_bwd_dkv", 158)):
        b = brows["bfloat16"][name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": src + "csrc/taylor_bwd.cu",
            "replaces": f"src/repro/kernels/taylor_attention/kernel_bwd.py:{line}",
            "launches": train["launches"][name],
            "launches_by_path": {
                "train_8_steps": train["launches"][name],
                "phase20_step": dry["a"]["launches"][1 if name == "taylor_bwd_dq" else 2],
                f"order1_train_{BASELINE_STEPS}_steps": base_launches["train"][name],
                "hybrid_lm_apply": hybrid["lm_apply_launches"][name],
                f"hybrid_train_{HYBRID_STEPS}_steps": hybrid["train_launches"][name],
                **zoo_launches(zoo, name),
                **ssm_launches(ssm, name),
                **cross_launches(cross, name),
                **breadth_launches(breadth, name),
                **dist_launches(dist, name)},
            "max_abs_err": b["max_abs_err"],
            "ms": b["ms"],
            "plain_ms": b["plain_ms"],
            "bound_ms": b["bound_ms"],  # tensor cores: the products as the kernel issues them
            "bound_by": b["bound_by"],
            "library_ms": None,
            "bound_f32_cores_ms": b["bound_f32_cores_ms"],
            "ms_train_shape": brows[case_name(TRAIN_ATTN, "bfloat16")][name]["ms"],
            "plain_ms_train_shape": brows[case_name(TRAIN_ATTN, "bfloat16")][name]["plain_ms"],
            "shape": shape,
            "zoo_cases": zoo_rows(zoo, name),
        })
    print(json.dumps({"kernels": kernels}))

    # ---- 22. device line ----
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
