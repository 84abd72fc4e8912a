"""A kernel's share of its roofline from the traced ops' calls: the frozen
least time of every call (its work from ``counts/taylor.py`` at the model's
head dim, the operations at the bf16 peak against the bytes at HBM's rate)
over the device time of every kernel the calls launched.

Every call of a cell is taken at the cell's one launch shape, which its
configuration and traffic fix: a training step of ``batch`` rows of
``seq`` tokens launches each kernel over ``batch · n_kv_heads`` rows of
``n_heads / n_kv_heads`` query heads, at the model's head dim (the trace
records no input shapes)."""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from portbench.counts import peaks


def launch(ctx: dict) -> Optional[Tuple[int, int, int, int, int]]:
    """(bk, g, n, d, dv) of the cell's kernel launches; None where the
    cell's layer readings give no batch and sequence."""
    layer, cfg = ctx.get("layer") or {}, ctx["config"]
    if not layer.get("batch") or not layer.get("seq"):
        return None
    hk, hd = cfg["n_kv_heads"], cfg["head_dim"]
    return layer["batch"] * hk, cfg["n_heads"] // hk, layer["seq"], hd, hd


def share(ctx: dict, work: Dict[str, Callable]) -> Optional[float]:
    """``work`` maps each op name to its (operations, bytes) function of
    (bk, g, n, d, dv, itemsize); None when an op has no call or no device
    time in the trace."""
    shape = launch(ctx)
    if shape is None:
        return None
    itemsize = 2 if ctx["cell"]["precision"]["dtype"] in ("bfloat16", "float16") else 4
    least = device = 0.0
    for op, fn in work.items():
        calls = ((ctx.get("trace") or {}).get("op_calls") or {}).get(op) or []
        spent = sum(c["device_s"] for c in calls)
        if spent <= 0:
            return None
        device += spent
        least += len(calls) * peaks.least_seconds(*fn(*shape, itemsize))
    return 100.0 * least / device
