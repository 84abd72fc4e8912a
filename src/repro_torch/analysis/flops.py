"""FLOP and byte counts of a program, with exact trip counts.

The port's counterpart of the JAX package's ``analysis/flops.py``, which
walks a jaxpr.  PyTorch runs eagerly: a Python loop unrolls as it runs, so
a loop of 17 counts 17 bodies (the reference's ``scan`` × ``length``), and
the recompute under ``torch.utils.checkpoint`` counts as it reruns.
``count_fn`` runs the program once on meta tensors inside
``device.card_trace`` — the card's program: the Taylor kernels' route, the
kernels' ``torch.library`` ops dispatched to their fake implementations,
nothing allocated or launched — and counts every op it dispatches:

  * ``matmul_flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count
    (mm, bmm, addmm, baddbmm, convolution, and the three Taylor kernels
    through the flop formulas of ``kernels/taylor_attention/kernel.py``);
  * ``elementwise_flops``: 1 per output element of every other op that
    computes (views and other aliasing ops compute nothing);
  * ``bytes``: operand plus result bytes of every op that computes.  This
    ignores fusion and caching, so it is an upper bound on HBM traffic, but
    a consistent one, as the reference's.

The same holds for real tensors (CPU or CUDA): ``FlopCounterMode`` around a
real step on the card counts what ``count_fn`` predicts for it.

Where the program runs on an ``AbstractMesh`` (``launch/dryrun.py``), the
counts are one rank's: per chip, not global as the reference's walker.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves, tree_map
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.analysis.memory import PeakMemory
from repro_torch.configs import TensorSpec
from repro_torch.device import card_trace
from repro_torch.distributed import collectives as col

FLOP_REPORT_KEYS = ("flops", "bytes", "matmul_flops", "elementwise_flops")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _OpCounter(TorchDispatchMode):
    """Bytes of every op that computes, and 1 FLOP per output element of
    those that ``FlopCounterMode`` does not count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.elementwise = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func is torch.ops.aten.detach.default:
            return out
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        ins = [t for t in tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if func._overloadpacket not in flop_registry:
            self.elementwise += sum(t.numel() for t in outs)
        return out


class Traced(NamedTuple):
    """What one traced run of a program gave."""

    counts: Dict[str, float]       # FLOP_REPORT_KEYS
    peak_bytes: int                # ``PeakMemory`` over the run, its inputs included
    records: List[col.Record]      # the collectives it made


def materialise(tree):
    """``tree`` with every ``TensorSpec`` replaced by a meta tensor of it."""
    return tree_map(lambda x: x.empty() if isinstance(x, TensorSpec) else x, tree,
                    is_leaf=lambda x: isinstance(x, TensorSpec))


def trace(fn, *args, **kwargs) -> Traced:
    """Runs ``fn(*args, **kwargs)`` once as the card would (``card_trace``)
    and counts it.  ``args`` may hold ``TensorSpec``s (made meta tensors),
    meta tensors or real ones."""
    args, kwargs = materialise((args, kwargs))
    ops = _OpCounter()
    with card_trace(), col.recording() as records, FlopCounterMode(display=False) as fc:
        with PeakMemory(args, kwargs) as mem, ops:
            fn(*args, **kwargs)
    matmul = float(fc.get_total_flops())
    counts = {"flops": matmul + ops.elementwise, "bytes": float(ops.bytes),
              "matmul_flops": matmul, "elementwise_flops": float(ops.elementwise)}
    return Traced(counts, mem.peak, records)


def count_fn(fn, *args, **kwargs) -> Dict[str, float]:
    """Trip-exact FLOPs and bytes of ``fn(*args, **kwargs)`` (FLOP_REPORT_KEYS);
    ``args`` may be ``TensorSpec``s."""
    return trace(fn, *args, **kwargs).counts
