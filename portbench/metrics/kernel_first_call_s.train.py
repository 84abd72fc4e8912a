"""kernel_first_call_s.train: the host seconds of the Taylor ops' first
calls in the process (set-up spans ``kernels.first_call.<op>``, which hold
the kernels' build and binding), summed."""

from portbench.program_spans import snapshot

PREFIX = "kernels.first_call."


def read(ctx):
    snap = snapshot()
    if snap is None:
        return None
    found = [s["seconds"] for name, s in snap["spans"].items() if name.startswith(PREFIX)]
    return sum(found) if found else None
