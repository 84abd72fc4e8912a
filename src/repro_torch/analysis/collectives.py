"""Attribute a rank's collective traffic to the model's sites.

The reference aggregates the link bytes of its HLO's collectives by the
``op_name`` that XLA keeps on each; the port's collectives carry their site
themselves (``distributed.collectives.Record.site``: the layer and the
``distributed.spmd`` hook that called them, ``"layer3/attn"``, with
``"/bwd"`` for a backward's), so this is a sum over the records.

Usage:
  PYTHONPATH=src python -m repro_torch.analysis.collectives \\
      artifacts/dryrun_torch/X.records.jsonl
(or call ``attribute(records)`` on ``collectives.recording()``'s list).
"""

from __future__ import annotations

import json
import sys
from collections import defaultdict
from typing import Dict, Iterable, Tuple

from repro_torch.analysis.roofline import operand_link_bytes
from repro_torch.distributed.collectives import Record


def attribute(records: Iterable[Record]) -> Dict[Tuple[str, str], float]:
    """Link bytes by (kind, site), by the reference's ring model."""
    out: Dict[Tuple[str, str], float] = defaultdict(float)
    for r in records:
        out[(r.kind, r.site)] += operand_link_bytes(r.kind, r.nbytes, r.group)[1]
    return dict(out)


def top_table(records: Iterable[Record], k: int = 25) -> str:
    rows = sorted(attribute(records).items(), key=lambda kv: -kv[1])[:k]
    lines = [f"{'link GB':>10}  {'kind':<18} source", "-" * 90]
    for (kind, src), b in rows:
        lines.append(f"{b / 2**30:10.2f}  {kind:<18} {src}")
    return "\n".join(lines)


def load_records(path: str):
    """The records that ``launch/dryrun.py --save-records`` wrote, one JSON
    list a line."""
    with open(path) as f:
        return [Record(*json.loads(line)) for line in f if line.strip()]


if __name__ == "__main__":
    print(top_table(load_records(sys.argv[1])))
