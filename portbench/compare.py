"""The comparisons that decide ``correct``: each returns one number, which the
run prints beside the cell's limit for it.

Norms are compared leaf by leaf, by the gap between the program's norm and
the reference's (not the norm of their difference), measured against the
reference's norm of that leaf or of the median leaf, whichever is larger,
and the worst leaf is the number.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional, Tuple

Key = Tuple[str, str]


def loss_gap(program: Iterable[float], reference: Iterable[float]) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference))


def worst_leaf_gap(program: Dict[Key, float], reference: Dict[Key, float],
                   keep: Optional[Iterable[Key]] = None) -> float:
    """The gap of the worst leaf among ``keep`` (default: all)."""
    keys = list(reference if keep is None else keep)
    median = statistics.median(reference[k] for k in keys)
    return max(abs(program[k] - reference[k]) / max(reference[k], median, 1e-30) for k in keys)


def moved_leaves(first_grad: Dict[Key, float]) -> list:
    """The leaves whose first reference gradient is at least a thousandth of
    the median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(first_grad.values())
    return [k for k, v in first_grad.items() if v >= 1e-3 * median]


def logit_gap(ref_logits, tokens) -> float:
    """The widest gap by which a token's reference logit lies below the
    reference's best at its position: ref_logits [m, V], tokens [m]."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())
