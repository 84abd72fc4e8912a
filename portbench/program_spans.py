"""What the readers of the program's own spans and counters share
(``repro_torch.spans`` in the port): the device time of the traced calls of
named spans, a step, and the program's registry.

A program without those spans gives None, and the metric is left out of
the result line."""

from __future__ import annotations

import sys
from typing import Iterable, Optional

PREFIX = "repro_torch."


def device_ms_a_step(ctx: dict, names: Iterable[str], one_a_step: bool = False
                     ) -> Optional[float]:
    """The device milliseconds of every kernel launched inside the traced
    calls of the spans ``names`` (``summarise``'s ``op_calls``), over the
    window's steps.  None without steps, without a call of each span, with
    no device time (a CPU run), or, with ``one_a_step``, where a span's
    calls are not one a step."""
    steps = (ctx.get("layer") or {}).get("steps")
    op_calls = (ctx.get("trace") or {}).get("op_calls") or {}
    if not steps:
        return None
    spent = 0.0
    for name in names:
        calls = op_calls.get(PREFIX + name) or []
        if not calls or (one_a_step and len(calls) != steps):
            return None
        spent += sum(c["device_s"] for c in calls)
    return 1e3 * spent / steps if spent > 0 else None


def snapshot() -> Optional[dict]:
    """The registry of spans and counters of the program that ran in this
    process (the kinds load it), or None where the program has none.  The
    harness meets the program only in ``program.py`` and the kinds: this
    reads the loaded module and imports nothing."""
    spans = sys.modules.get("repro_torch.spans")
    return None if spans is None else spans.snapshot()
