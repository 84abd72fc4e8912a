"""Roofline terms of one rank's program, from counts and collective records.

The port's counterpart of the JAX package's ``analysis/roofline.py``.  The
reference reads a compiled executable (XLA's cost analysis and its HLO
text); the port has no compiler between the program and the card, so its
terms come from the program itself:

    compute    = FLOPs        / peak FLOP/s      (``analysis/flops.count_fn``)
    memory     = bytes        / HBM B/s          (the same count)
    collective = link bytes   / link B/s each way (``collective_bytes`` of the
                                                   rank's ``collectives.Record``s)

All three are per chip: the dry run traces one rank's program (its blocks
of the state and its rows of the batch), which is what the reference's
per-partition numbers are.  ``bound_ms`` is the least time of one kernel
launch on the card, as ``chip_smoke.py`` prints it beside the launch's
time.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float      # per chip, bf16 (dense, on the matrix units)
    hbm_bw: float          # B/s per chip
    link_bw: float         # B/s per link, each way
    hbm_bytes: float       # capacity per chip


# Kept for parity with the reference's tables; the port runs on no TPU.
TPUV5E = HardwareSpec(
    name="tpu_v5e",
    peak_flops=197e12,
    hbm_bw=819e9,
    link_bw=50e9,
    hbm_bytes=16e9,
)

# One NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense rates):
# NVLink 900 GB/s to the host's other cards, 450 GB/s each way.
H100 = HardwareSpec(
    name="h100_sxm",
    peak_flops=989e12,
    hbm_bw=3.35e12,
    link_bw=450e9,
    hbm_bytes=80e9,
)
# Its other peaks, which ``bound_ms`` reads: TF32 on the tensor cores, and
# float32 off them
H100_TF32_FLOPS = 495e12
H100_F32_FLOPS = 67e12

# The reference's names for the collectives; ``collectives.Record.kind`` uses
# the first four (the port issues no collective-permute).
COLLECTIVES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)


def operand_link_bytes(kind: str, result_bytes: float, group: int):
    """(operand bytes, link bytes) of one collective by the reference's ring
    model (``repro/analysis/roofline.py:131``), from its result's bytes on
    a rank and its group's size g:

        all-gather      operand = result/g,  link = result·(g-1)/g
        reduce-scatter  operand = result·g,  link = result·(g-1)
        all-reduce      operand = result,    link = 2·result·(g-1)/g
        all-to-all      operand = result,    link = result·(g-1)/g
        collective-perm operand = result,    link = result
    """
    rb, g = result_bytes, max(group, 1)
    if kind == "all-gather":
        return rb / g, rb * (g - 1) / g
    if kind == "reduce-scatter":
        return rb * g, rb * (g - 1)
    if kind == "all-reduce":
        return rb, 2 * rb * (g - 1) / g
    if kind == "all-to-all":
        return rb, rb * (g - 1) / g
    if kind == "collective-permute":
        return rb, rb
    raise ValueError(f"unknown collective {kind!r}")


def collective_bytes(records: Iterable) -> Dict[str, Dict[str, int]]:
    """Per-kind {"operand_bytes", "link_bytes"} of a rank's collective
    records (``distributed.collectives.Record``: kind, result bytes, group
    size), the reference's ``collective_bytes`` of its HLO."""
    out = {k: {"operand_bytes": 0.0, "link_bytes": 0.0} for k in COLLECTIVES}
    for r in records:
        operand, link = operand_link_bytes(r.kind, r.nbytes, r.group)
        out[r.kind]["operand_bytes"] += operand
        out[r.kind]["link_bytes"] += link
    return {k: {kk: int(vv) for kk, vv in v.items()} for k, v in out.items()}


def roofline_report(
    counts: Dict[str, float],
    records: Iterable,
    n_chips: int,
    hw: HardwareSpec = H100,
    model_flops: Optional[float] = None,
) -> Dict[str, float]:
    """The three-term report of one (arch × shape × mesh) cell, with the
    reference's keys where they apply.

    Args:
      counts: ``analysis.flops.count_fn`` of ONE rank's program (per chip):
        ``flops`` and ``bytes`` (operands plus results of every op: a
        consistent upper bound on HBM traffic).
      records: that rank's ``collectives.Record``s.
      n_chips: ranks of the mesh.
      hw: the chip.
      model_flops: the useful FLOPs of the whole step (6·N·tokens for
        training, 2·N·tokens for serving), for ``useful_flops_ratio`` and
        ``roofline_fraction``.
    """
    coll = collective_bytes(records)
    coll_link = float(sum(v["link_bytes"] for v in coll.values()))
    coll_operand = float(sum(v["operand_bytes"] for v in coll.values()))
    flops_dev = float(counts["flops"])
    bytes_dev = float(counts["bytes"])
    terms = {
        "compute_s": flops_dev / hw.peak_flops,
        "memory_s": bytes_dev / hw.hbm_bw,
        "collective_s": coll_link / hw.link_bw,
    }
    bound = max(terms.values())
    report = {
        **terms,
        "dominant": max(terms, key=terms.get),
        "flops_per_chip": flops_dev,
        "bytes_per_chip": bytes_dev,
        "collective_link_bytes_per_chip": coll_link,
        "collective_operand_bytes_per_chip": coll_operand,
        "collective_breakdown": coll,
        "n_chips": n_chips,
        # step-time bounds: perfect overlap vs fully serial
        "t_lower_bound_s": bound,
        "t_serial_s": sum(terms.values()),
        "walker": {k: float(v) for k, v in counts.items()},
        "hardware": hw.name,
    }
    if model_flops:
        report["model_flops"] = model_flops
        report["useful_flops_ratio"] = model_flops / max(flops_dev * n_chips, 1.0)
        # roofline fraction: useful model FLOP/s at the binding term vs peak
        report["roofline_fraction"] = (model_flops / max(bound, 1e-12)) / (
            n_chips * hw.peak_flops)
    return report


def bound_ms(flops, nbytes, tensor=None, products=None):
    """(least ms of one kernel launch on the ``H100``, what bounds it): the
    operations at their type's peak against the bytes at HBM's rate.  The
    operations run at the f32 CUDA-core peak, except the ``tensor``
    contractions ({name: operations}), which take ``products[name]`` TF32
    products each at the tensor-core peak (``kernels/taylor_attention/
    cost.py`` gives both for the Taylor kernels)."""
    tensor = tensor or {}
    t_ops = ((flops - sum(tensor.values())) / H100_F32_FLOPS
             + sum(f * products[k] for k, f in tensor.items()) / H100_TF32_FLOPS)
    t_bytes = nbytes / H100.hbm_bw
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
