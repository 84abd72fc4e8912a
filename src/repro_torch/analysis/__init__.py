"""Analysis of one rank's program: FLOPs, bytes, live memory, collectives
and their roofline on a chip, counted by running the program on meta tensors
as the card would (``device.card_trace``)."""

from repro_torch.analysis.flops import FLOP_REPORT_KEYS, count_fn, trace
from repro_torch.analysis.memory import PeakMemory
from repro_torch.analysis.roofline import (
    H100,
    TPUV5E,
    HardwareSpec,
    collective_bytes,
    roofline_report,
)

__all__ = ["FLOP_REPORT_KEYS", "H100", "TPUV5E", "HardwareSpec", "PeakMemory",
           "collective_bytes", "count_fn", "roofline_report", "trace"]
