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

Speculative decoding (speculative.py): with
``SchedulerPolicy(speculative_k=k)`` greedy slots draft ``k`` tokens per
round (``NgramProposer`` or the order-1 ``Order1SelfDraft``) and verify
them in one chunk pass on the moment state.  State representations
(state_repr.py): ``make_state_store`` / ``SlotStateStore`` hold the slot
state dense, with int8/fp8-quantised Taylor moments, or as paged softmax
KV, and own the quantise/dequantise boundary.
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
from repro_torch.serve.speculative import (
    DraftProposer,
    NgramProposer,
    Order1SelfDraft,
    Speculator,
    draft_available,
    has_proposer,
    proposer_names,
    register_proposer,
)
from repro_torch.serve.state_repr import (
    PageAllocator,
    SlotStateStore,
    make_state_store,
    wrap_cache_fn,
)

__all__ = [
    "CostModel",
    "DispatchFailure",
    "DraftProposer",
    "FaultPlan",
    "InjectedDispatchError",
    "InjectedFault",
    "LoadReport",
    "NgramProposer",
    "Order1SelfDraft",
    "PageAllocator",
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
    "SlotStateStore",
    "Speculator",
    "Status",
    "Trace",
    "TraceItem",
    "VirtualClock",
    "bursty_trace",
    "clear_slot",
    "corrupt_slot",
    "decode_scan",
    "decode_step",
    "draft_available",
    "generate",
    "generate_loop",
    "has_proposer",
    "init_slot_caches",
    "make_state_store",
    "poisson_trace",
    "prefill",
    "prefill_chunked",
    "proposer_names",
    "read_slot",
    "register_proposer",
    "run_trace",
    "sample_tokens",
    "select_slots",
    "slot_bytes",
    "slot_health",
    "standard_trace",
    "wrap_cache_fn",
    "write_slot",
]
