"""Serving: slotted decode caches, the continuous-batching engine, generate."""

from repro_torch.serve.engine import (
    decode_scan,
    decode_step,
    generate,
    generate_loop,
    prefill,
    sample_tokens,
)
from repro_torch.serve.scheduler import Request, ServeEngine

__all__ = [
    "Request",
    "ServeEngine",
    "decode_scan",
    "decode_step",
    "generate",
    "generate_loop",
    "prefill",
    "sample_tokens",
]
