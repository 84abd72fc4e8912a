"""The traced run's profiler and what the metric readers read from it.

``Tracer`` wraps the measured window in ``torch.profiler`` (CPU and CUDA
activities, no input shapes: recording them slows every op the host issues)
and the harness's own calls into each layer in ``record_function`` spans
named ``portbench.<layer>``.  With
tracing off it records nothing and its spans are empty contexts.

``summarise`` reduces the trace to:

  * ``window_s``: the length of the ``portbench.window`` span;
  * ``busy_s``: the union of the device's activity intervals inside it;
  * ``op_calls``: for each dispatcher op asked for, one entry per call with
    the device seconds of every kernel it launched, whatever the kernels are named (a kernel belongs to
    the innermost op recorded when it was launched, and that op lies inside
    the call's interval on the call's thread);
  * ``device_ops``: the ten kernel names with the most device time;
  * ``idle_gaps``: device idle time inside the window, summed by what the
    host was doing at each gap's middle (the innermost harness span and the
    innermost op there), the ten largest.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, Iterable, List

import torch

WINDOW = "portbench.window"


class Tracer:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        return torch.profiler.record_function(f"portbench.{name}")

    @contextlib.contextmanager
    def window(self):
        """The measured window: profiled when tracing, a plain block when not."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(WINDOW):
                yield
        self.prof = prof


def _union(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def summarise(prof, ops: Iterable[str]) -> Dict:
    ops = set(ops)
    cpu, dev = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            cpu.append(e)
        elif not (e.is_user_annotation() or e.name().startswith("portbench.")):
            dev.append(e)  # the device's own work; a span's mirror on its timeline is not
    win = [e for e in cpu if e.name() == WINDOW]
    if not win:
        raise RuntimeError("the trace has no window span")
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    by_corr = {e.correlation_id(): e for e in cpu}

    intervals, by_name = [], defaultdict(float)
    per_kernel = []
    for e in dev:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t > s:
            intervals.append((s, t))
        by_name[e.name()] += e.duration_ns() / 1e9
        per_kernel.append(e)
    busy = _union(intervals)
    busy_s = sum(t - s for s, t in busy) / 1e9

    # each asked-for op call: its interval on its thread
    calls: Dict[str, List[dict]] = {op: [] for op in ops}
    spans_by_thread: Dict[int, List[tuple]] = defaultdict(list)
    for e in cpu:
        if e.name() in ops:
            call = {"device_s": 0.0}
            calls[e.name()].append(call)
            spans_by_thread[e.start_thread_id()].append((e.start_ns(), e.end_ns(), call))
    starts = {tid: [s for s, _, _ in sorted(v, key=lambda x: x[0])]
              for tid, v in spans_by_thread.items()}
    spans_sorted = {tid: sorted(v, key=lambda x: x[0]) for tid, v in spans_by_thread.items()}
    for k in per_kernel:
        launcher = by_corr.get(k.linked_correlation_id())
        if launcher is None:
            continue
        tid = launcher.start_thread_id()
        if tid not in starts:
            continue
        i = bisect.bisect_right(starts[tid], launcher.start_ns()) - 1
        if i >= 0:
            s, t, call = spans_sorted[tid][i]
            if s <= launcher.start_ns() <= t:
                call["device_s"] += k.duration_ns() / 1e9

    # idle gaps, labelled by what the window's thread was inside at each
    # gap's middle: its events nest, so a stack walked in time order holds
    # exactly the events open at a moment
    tid = win[0].start_thread_id()
    host = sorted(((e.start_ns(), e.end_ns(), e.name()) for e in cpu
                   if e.start_thread_id() == tid and e.name() != WINDOW
                   and w0 <= e.start_ns() <= w1), key=lambda x: (x[0], -x[1]))
    gaps, prev = [], w0
    for s, t in busy + [(w1, w1)]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    idle: Dict[str, float] = defaultdict(float)
    stack: List[tuple] = []
    j = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        op = stack[-1][2] if stack and not stack[-1][2].startswith("portbench.") else ""
        span = next((h[2] for h in reversed(stack) if h[2].startswith("portbench.")), "host")
        idle[f"{span} / {op}" if op else span] += (g1 - g0) / 1e9
    top = lambda d: [[k[:200], v] for k, v in sorted(d.items(), key=lambda x: -x[1])[:10]]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_s, "op_calls": calls,
            "device_ops": top(by_name), "idle_gaps": top(idle)}
