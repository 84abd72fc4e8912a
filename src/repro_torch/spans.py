"""Spans and counters at the port's layer boundaries.

    with spans.span("optimizer"):       # a span: calls, host seconds, parent
        ...
    spans.count("name", n)              # a counter
    with spans.once("train.first_step"):  # a set-up span
        ...
    spans.snapshot()                    # what was recorded, as plain dicts

A span records while the torch profiler records (the check that
``record_function`` itself makes) or after ``enable()``; nothing else turns
it on.  Off, ``span`` returns one shared empty context: it calls no
``record_function`` (~15 µs a call even with the profiler off) and no CUDA
API.  On, each span adds to the registry its calls, its host seconds and
its parent (the span open around it on its thread) and, while the profiler
records, opens ``record_function("repro_torch." + name)``, so that the
span lies on the profiler's clock beside the device's activity.

A ``once`` span records the first time the process enters its name,
whether or not anything records, and is the shared empty context after
that: it is for set-up, which runs once.

``backward_begin`` and ``backward_end`` bracket a span over part of a
backward pass: identities in the forward whose gradients open and close
the span where the autograd engine passes them, on the thread that
launches that part's kernels.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional

import torch

PREFIX = "repro_torch."
# the caching allocator's statistics a span with ``device=`` counts across itself
ALLOC_STATS = ("num_alloc_retries", "num_device_alloc", "num_device_free")

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled
_enabled = False
_lock = threading.Lock()
_spans: Dict[str, dict] = {}
_counters: Dict[str, int] = defaultdict(int)
_entered: set = set()
_local = threading.local()


def enable() -> None:
    """Record spans and counters without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record only while the profiler records."""
    global _enabled
    _enabled = False


def _stack() -> List[str]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _alloc_stats(device) -> Dict[str, int]:
    stats = torch.cuda.memory_stats(device)
    return {k: stats.get(k, 0) for k in ALLOC_STATS}


class _Span:
    __slots__ = ("name", "device", "parent", "t0", "rf", "stats")

    def __init__(self, name: str, device=None):
        self.name, self.device = name, device

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.stats = _alloc_stats(self.device) if self.device is not None else None
        self.rf = None
        if _profiling():
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        stack = _stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        with _lock:
            entry = _spans.setdefault(self.name, {"calls": 0, "seconds": 0.0, "parents": {}})
            entry["calls"] += 1
            entry["seconds"] += seconds
            entry["parents"][self.parent] = entry["parents"].get(self.parent, 0) + 1
        if self.stats is not None:
            after = _alloc_stats(self.device)
            for k, v in self.stats.items():
                count(f"{self.name}.{k}", after[k] - v)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A span named ``name`` (``record_function("repro_torch." + name)``
    under the profiler).  ``device``: where it is a CUDA device, the span
    also adds the caching allocator's ``ALLOC_STATS`` deltas across it to
    the counters ``<name>.<stat>``."""
    if not (_enabled or _profiling()):
        return _OFF
    return _Span(name, device if device is not None and device.type == "cuda" else None)


def once(name: str):
    """A set-up span: recorded the first time the process enters ``name``,
    traced or not; the shared empty context after that."""
    if name in _entered:
        return _OFF
    with _lock:
        if name in _entered:
            return _OFF
        _entered.add(name)
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to the counter ``name`` while recording."""
    if _enabled or _profiling():
        with _lock:
            _counters[name] += n


def snapshot() -> dict:
    """``{"spans": {name: {"calls", "seconds", "parents": {parent: calls}}},
    "counters": {name: n}}``, a copy (a root span's parent is None)."""
    with _lock:
        return {"spans": {k: dict(v, parents=dict(v["parents"])) for k, v in _spans.items()},
                "counters": dict(_counters)}


def reset() -> None:
    """Empties the registry (a ``once`` name entered before stays entered)."""
    with _lock:
        _spans.clear()
        _counters.clear()


class _BackwardEdge(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name: str, opens: bool):
        ctx.name, ctx.opens = name, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        open_ = getattr(_local, "backward", None)
        if open_ is None:
            open_ = _local.backward = defaultdict(list)
        if ctx.opens:
            s = span(ctx.name)
            s.__enter__()
            open_[ctx.name].append(s)
        elif open_[ctx.name]:
            open_[ctx.name].pop().__exit__(None, None, None)
        return grad, None, None


def _edge(x: torch.Tensor, name: str, opens: bool) -> torch.Tensor:
    if not (_enabled or _profiling()) or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _BackwardEdge.apply(x, name, opens)


def backward_begin(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` itself; while recording, the span ``name`` opens where the
    backward pass reaches ``x``'s gradient."""
    return _edge(x, name, True)


def backward_end(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x`` itself; while recording, the span ``name`` that a
    ``backward_begin`` opened on this thread closes where the backward pass
    leaves ``x``."""
    return _edge(x, name, False)
