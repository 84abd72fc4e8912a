"""Serving: slotted decode caches, the continuous-batching engine with its
SLO scheduler and resilience boundary, fault injection, the virtual-clock
load harness, and generate.

``ServeEngine`` + ``Request`` are the serving API (scheduler.py), with
chunked long-prompt admission (``prefill_chunk=``).  Every request ends in
a terminal ``Status`` carried by a ``RequestResult``; ``ResiliencePolicy``
configures shedding, degradation, deadlines and retries;
``SchedulerPolicy`` priority admission, the decode/prefill interleave, fat
chunks and preemption with state handoff; ``faults.FaultPlan`` injects
seeded failures; ``load.py`` replays seeded arrival traces under a
virtual clock.
"""

from repro_torch.serve.engine import (
    decode_scan,
    decode_step,
    generate,
    generate_loop,
    prefill,
    prefill_chunked,
    sample_tokens,
)
from repro_torch.serve.faults import (
    DispatchFailure,
    FaultPlan,
    InjectedDispatchError,
    InjectedFault,
    PrefillStall,
    QueueFlood,
    SlotCorruption,
    standard_trace,
)
from repro_torch.serve.load import (
    SLO,
    CostModel,
    LoadReport,
    Trace,
    TraceItem,
    VirtualClock,
    bursty_trace,
    poisson_trace,
    run_trace,
)
from repro_torch.serve.scheduler import (
    QueueOverflow,
    Request,
    RequestRejected,
    RequestResult,
    ResiliencePolicy,
    SchedulerPolicy,
    ServeEngine,
    Status,
)
from repro_torch.serve.slots import (
    clear_slot,
    corrupt_slot,
    init_slot_caches,
    read_slot,
    select_slots,
    slot_bytes,
    slot_health,
    write_slot,
)

__all__ = [
    "CostModel",
    "DispatchFailure",
    "FaultPlan",
    "InjectedDispatchError",
    "InjectedFault",
    "LoadReport",
    "PrefillStall",
    "QueueFlood",
    "QueueOverflow",
    "Request",
    "RequestRejected",
    "RequestResult",
    "ResiliencePolicy",
    "SLO",
    "SchedulerPolicy",
    "ServeEngine",
    "SlotCorruption",
    "Status",
    "Trace",
    "TraceItem",
    "VirtualClock",
    "bursty_trace",
    "clear_slot",
    "corrupt_slot",
    "decode_scan",
    "decode_step",
    "generate",
    "generate_loop",
    "init_slot_caches",
    "poisson_trace",
    "prefill",
    "prefill_chunked",
    "read_slot",
    "run_trace",
    "sample_tokens",
    "select_slots",
    "slot_bytes",
    "slot_health",
    "standard_trace",
    "write_slot",
]
