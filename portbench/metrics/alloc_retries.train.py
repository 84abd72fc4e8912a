"""alloc_retries.train: the caching allocator's retries a step in the
traced window (each a free of cached blocks and a second try, which
synchronises the device): the program's counters
``<phase>.num_alloc_retries`` of its forward, backward and optimizer spans,
summed, over the steps.  The counters count only while the profiler
records, which in a traced run is the window."""

from portbench.program_spans import snapshot

SUFFIX = ".num_alloc_retries"


def read(ctx):
    steps = (ctx.get("layer") or {}).get("steps")
    snap = snapshot()
    if not steps or snap is None:
        return None
    found = [n for name, n in snap["counters"].items() if name.endswith(SUFFIX)]
    return sum(found) / steps if found else None
