"""Render the dry run's tables from artifacts/dryrun_torch/*.json.

The port's copy of the JAX package's ``analysis/report.py``: the same
tables from the same record keys (``launch/dryrun.py`` writes them), with
the H100's 80 GB in the fits column.  The "compile" column reads
``compile_s``, which the port's dry run fills with the seconds it took to
trace the rank's program (nothing is compiled).

Usage: PYTHONPATH=src python -m repro_torch.analysis.report [--dir artifacts/dryrun_torch]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
ARCH_ORDER = [
    "zamba2-7b", "granite-20b", "qwen2-1.5b", "gemma-7b", "smollm-135m",
    "kimi-k2-1t-a32b", "qwen2-moe-a2.7b", "whisper-medium", "mamba2-780m",
    "llama-3.2-vision-11b",
]


def load(directory: str) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def variant_table(recs: List[Dict]) -> str:
    """§Perf: variant cells next to their baselines."""
    base = {(r["arch"], r["shape"], r.get("mesh")): r for r in recs
            if r.get("status") == "ok" and not r.get("variant")}
    rows = [
        "| cell | variant | Δcollective | Δmemory-term | ΔHBM peak | detail |",
        "|---|---|---|---|---|---|",
    ]
    for r in recs:
        v = r.get("variant")
        if not v or r.get("status") != "ok":
            continue
        b = base.get((r["arch"], r["shape"], r.get("mesh")))
        if not b:
            continue
        rb, rv = b["roofline"], r["roofline"]
        dc = f"{rb['collective_s']:.2f}s → {rv['collective_s']:.2f}s"
        dm = f"{rb['memory_s']:.2f}s → {rv['memory_s']:.2f}s"
        dh = (f"{b['hbm_peak_bytes_per_chip'] / 2**30:.1f} → "
              f"{r['hbm_peak_bytes_per_chip'] / 2**30:.1f} GiB"
              f"{' (fits)' if r['fits_hbm'] and not b['fits_hbm'] else ''}")
        frac = (f"roofline {rb.get('roofline_fraction', 0) * 100:.2f}% → "
                f"{rv.get('roofline_fraction', 0) * 100:.2f}%")
        rows.append(f"| {r['arch']}×{r['shape']}×{r['mesh']} | {v} | {dc} | {dm} | {dh} | {frac} |")
    return "\n".join(rows)


def _fmt_bytes(b) -> str:
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.2f}ms"
    return f"{x * 1e6:.1f}µs"


def _key(r):
    a = ARCH_ORDER.index(r["arch"]) if r["arch"] in ARCH_ORDER else 99
    s = SHAPE_ORDER.index(r["shape"]) if r["shape"] in SHAPE_ORDER else 99
    return (a, s, r.get("mesh", ""))


def dryrun_table(recs: List[Dict], mesh: str) -> str:
    rows = [
        "| arch | shape | backend | status | HBM/chip (peak) | fits 80 GB | "
        "FLOPs/chip | coll. link B/chip | compile |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        if r.get("mesh") != mesh:
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | - | **{r.get('error','ERR')}** "
                        f"| - | - | - | - | - |")
            continue
        ro = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['backend']} | ok "
            f"| {_fmt_bytes(r['hbm_peak_bytes_per_chip'])} "
            f"| {'✓' if r['fits_hbm'] else '**✗**'} "
            f"| {ro['flops_per_chip']:.2e} "
            f"| {_fmt_bytes(ro['collective_link_bytes_per_chip'])} "
            f"| {r['compile_s']:.0f}s |"
        )
    return "\n".join(rows)


def roofline_table(recs: List[Dict], mesh: str) -> str:
    rows = [
        "| arch | shape | compute | memory | collective | dominant | "
        "useful/compiled FLOPs | roofline frac | lever |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        if r.get("mesh") != mesh or r.get("status") != "ok":
            continue
        ro = r["roofline"]
        dom = ro["dominant"].replace("_s", "")
        lever = LEVERS.get((r["arch"], r["shape"]), LEVER_BY_DOM.get(dom, ""))
        rows.append(
            f"| {r['arch']} | {r['shape']} "
            f"| {_fmt_s(ro['compute_s'])} | {_fmt_s(ro['memory_s'])} "
            f"| {_fmt_s(ro['collective_s'])} | {dom} "
            f"| {ro.get('useful_flops_ratio', 0):.3f} "
            f"| {ro.get('roofline_fraction', 0) * 100:.2f}% "
            f"| {lever} |"
        )
    return "\n".join(rows)


LEVER_BY_DOM = {
    "compute": "cut non-model FLOPs: remat policy (dots_saveable), symvec state, smaller chunk overhead",
    "memory": "fuse/relayout: bigger chunks, bf16 activations, avoid resharding between blocks",
    "collective": "re-rule sharding: lower TP degree / FSDP-only for small models, overlap via async collectives",
}

# per-cell one-sentence levers (hand-written where the generic one is off).
# These and LEVER_BY_DOM are the JAX package's, word for word: its findings
# on TPUs (its "§Perf" too), none measured on the H100.
LEVERS = {
    ("kimi-k2-1t-a32b", "train_4k"):
        "EP a2a + ZeRO-3 all-gathers dominate: prefetch next layer's expert shards (overlap), int8 cross-pod grads",
    ("smollm-135m", "train_4k"):
        "tp=16 is wasted on a 135M model: drop TP, go pure DP/FSDP (validated in §Perf)",
    ("mamba2-780m", "long_500k"):
        "decode is tiny: batch more sequences per chip or colocate with prefill",
}


def summarize(recs: List[Dict]) -> str:
    ok = [r for r in recs if r.get("status") == "ok"]
    bad = [r for r in recs if r.get("status") != "ok"]
    fits = [r for r in ok if r.get("fits_hbm")]
    lines = [
        f"- cells compiled: **{len(ok)}**; failed: **{len(bad)}**",
        f"- fits 80 GB HBM/chip: {len(fits)}/{len(ok)} "
        f"(see notes for the over-budget cells)",
    ]
    for r in ok:
        if not r.get("fits_hbm"):
            lines.append(
                f"  - over budget: {r['arch']}×{r['shape']}×{r['mesh']} "
                f"peak {_fmt_bytes(r['hbm_peak_bytes_per_chip'])}"
            )
    return "\n".join(lines)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="artifacts/dryrun_torch")
    args = ap.parse_args()
    recs = load(args.dir)
    baselines = [r for r in recs if not r.get("variant")]
    meshes = sorted({r.get("mesh") for r in baselines if r.get("mesh")})
    print("## Summary (baselines)\n")
    print(summarize(baselines))
    for mesh in meshes:
        print(f"\n## Dry-run — mesh {mesh}\n")
        print(dryrun_table(baselines, mesh))
        print(f"\n## Roofline — mesh {mesh}\n")
        print(roofline_table(baselines, mesh))
    if any(r.get("variant") for r in recs):
        print("\n## §Perf variants (vs baseline)\n")
        print(variant_table(recs))


if __name__ == "__main__":
    main()
