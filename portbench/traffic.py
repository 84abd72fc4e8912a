"""The one traffic generator: every traffic mix is parameters in a cell's
file, read here.

Training rows are uniform token ids.  Open-loop serving offers a Poisson
process at the cell's rate, with log-uniform or uniform prompt and output
lengths, stratified so that the seed orders the work and does not change
it: a window of ``seconds`` holds ``N = round(rate · seconds)`` requests,
whose gaps are the N quantiles of the exponential distribution at the
cell's rate (scaled so that all N are due inside the window) and whose
prompt and output lengths are the N quantiles of their distributions.  The
run's seed shuffles each of the three sets and draws the token ids, so
every seed offers the same set of gaps and lengths in another order.  The
gaps and lengths follow the seeded ``poisson_trace`` of the port's
``serve/load.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch


def train_rows(seed: int, count: int, seq: int, vocab: int, device) -> torch.Tensor:
    """``count`` rows of ``seq + 1`` uniform token ids, drawn on ``device``:
    row i feeds tokens ``[:-1]`` and labels ``[1:]``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    return torch.randint(0, vocab, (count, seq + 1), generator=gen, device=device)


@dataclasses.dataclass
class Arrival:
    due_s: float          # seconds after the window opens
    prompt: np.ndarray    # [n] int64
    max_new: int


def _quantiles(dist: dict, count: int) -> np.ndarray:
    u = (np.arange(count) + 0.5) / count
    lo, hi = dist["lo"], dist["hi"]
    if dist["dist"] == "loguniform":
        x = lo * (hi / lo) ** u
    elif dist["dist"] == "uniform":
        x = lo + u * (hi - lo + 1) - 0.5
    else:
        raise ValueError(f"unknown length distribution {dist['dist']!r}")
    return np.clip(np.rint(x), lo, hi).astype(np.int64)


def open_loop(seed: int, traffic: dict, seconds: float, vocab: int) -> List[Arrival]:
    """The requests due in a window of ``seconds``, in due order."""
    rate = float(traffic["rate_per_s"])
    count = max(1, round(rate * seconds))
    rng = np.random.default_rng(int(seed))
    if traffic["arrivals"] != "poisson":
        raise ValueError(f"unknown arrival process {traffic['arrivals']!r}")
    u = (np.arange(count) + 0.5) / count
    gaps = rng.permutation(-np.log1p(-u) / rate)
    due = np.cumsum(gaps)
    due *= seconds * (1.0 - 0.5 / count) / due[-1]
    prompts = rng.permutation(_quantiles(traffic["prompt"], count))
    outputs = rng.permutation(_quantiles(traffic["output"], count))
    return [Arrival(float(due[i]), rng.integers(0, vocab, int(prompts[i]), dtype=np.int64),
                    int(outputs[i])) for i in range(count)]


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in [0, 100]); ``inf`` counts."""
    xs = sorted(values)
    if not xs:
        return math.nan
    return xs[max(0, math.ceil(q / 100 * len(xs)) - 1)]
