"""Deterministic fault injection for the serve engine (the JAX package's
``serve/faults.py``, kept as the port's own copy).

A ``FaultPlan`` is a seeded, replayable schedule of faults the engine
consults at its dispatch boundaries (``ServeEngine(fault_plan=...)``).
Faults model the failure classes a production engine must survive:

  * ``DispatchFailure``  — a compiled decode dispatch raises
    (``InjectedDispatchError``) before it executes, modelling a transient
    device/runtime failure whose input state survived.  The engine's
    retry loop and, when retries are exhausted, its rebuild-and-requeue
    path absorb it.
  * ``SlotCorruption``   — one slot's decode state (taylor S1/S2 moments,
    softmax KV) is overwritten with NaN/Inf after a dispatch
    — the silent-poison case the ``state_health`` sweep exists for.
  * ``PrefillStall``     — an in-progress chunked prefill makes no
    progress for a number of engine steps (a stalled long-prompt
    admission); deadlines retire the victim, other slots keep decoding.
  * ``QueueFlood``       — a burst of synthetic requests is submitted at
    a block boundary, driving the bounded queue into its shed/degrade
    admission policy.

Determinism contract: a plan is pure data plus a seeded generator for the
flood prompts, so (plan seed, engine generator, greedy requests) fully
determine a run: every ``Status.OK`` output is token-identical to a
fault-free run (tests/test_torch_sched.py), and the same seed draws the
same plan and flood prompts as the JAX package's ``FaultPlan``.

Plans are consumed as they fire; call ``reset()`` (or build a fresh plan)
before replaying one.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np


class InjectedFault(RuntimeError):
    """Base class of all errors raised by fault injection."""


class InjectedDispatchError(InjectedFault):
    """Raised in place of a decode dispatch by ``DispatchFailure``."""


@dataclasses.dataclass(frozen=True)
class DispatchFailure:
    """Make ``count`` decode dispatches raise, starting at engine block
    ``at_block`` (1-based engine step counter).  The failure fires before
    the dispatch executes, so the cache survives — the engine's in-place
    retry must produce token-identical output."""

    at_block: int
    count: int = 1


@dataclasses.dataclass(frozen=True)
class SlotCorruption:
    """Overwrite slot ``slot``'s decode-state leaves with ``mode``
    ("nan" | "inf") after the dispatch of the first block >= ``at_block``.
    The tokens of that block predate the corruption and stay valid; the
    health sweep must quarantine the slot before any poisoned token is
    accepted."""

    at_block: int
    slot: int
    mode: str = "nan"


@dataclasses.dataclass(frozen=True)
class PrefillStall:
    """Stall the in-progress chunked prefill for ``steps`` engine steps
    starting at the first step >= ``at_block`` where a partial admission
    is in flight (no prompt chunk is absorbed while stalled)."""

    at_block: int
    steps: int = 1


@dataclasses.dataclass(frozen=True)
class QueueFlood:
    """Submit ``count`` synthetic greedy requests (seeded random prompts
    of ``prompt_len`` tokens, ``max_new_tokens`` budget) at the first
    block >= ``at_block`` — the overload that exercises admission control."""

    at_block: int
    count: int
    prompt_len: int = 8
    max_new_tokens: int = 4


FaultEvent = object  # union of the event dataclasses above


class FaultPlan:
    """A seeded, single-use schedule of fault events (see module doc).

    The engine calls the ``check_dispatch`` / ``take_corruptions`` /
    ``prefill_stalled`` / ``flood_requests`` hooks at its block
    boundaries; each event fires once, at the first opportunity at or
    after its ``at_block``, and is then consumed.
    """

    def __init__(self, events=(), seed: int = 0):
        """Builds a plan from a list of fault events.

        Args:
          events: iterable of ``DispatchFailure`` / ``SlotCorruption`` /
            ``PrefillStall`` / ``QueueFlood`` instances.
          seed: seed of the generator that draws flood prompt tokens
            (the only random component; everything else is pure data).
        """
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self.seed = int(seed)
        self.reset()

    def reset(self) -> None:
        """Restore every consumed event (replay the plan from scratch)."""
        self._failures: List[List[int]] = [
            [e.at_block, e.count] for e in self.events
            if isinstance(e, DispatchFailure)
        ]
        self._corruptions = [e for e in self.events
                             if isinstance(e, SlotCorruption)]
        self._stalls = [e for e in self.events if isinstance(e, PrefillStall)]
        self._stall_until: Optional[int] = None
        self._floods = [e for e in self.events if isinstance(e, QueueFlood)]
        self._rng = np.random.default_rng(self.seed)

    # -- engine hooks --------------------------------------------------------

    def check_dispatch(self, block: int) -> None:
        """Raise ``InjectedDispatchError`` if a ``DispatchFailure`` is due
        at engine block ``block`` (consumes one failure per call)."""
        for f in self._failures:
            if f[0] <= block and f[1] > 0:
                f[1] -= 1
                raise InjectedDispatchError(
                    f"injected dispatch failure at block {block}"
                )

    def take_corruptions(self, block: int) -> List[SlotCorruption]:
        """Consume and return every ``SlotCorruption`` due at ``block``."""
        due = [e for e in self._corruptions if e.at_block <= block]
        self._corruptions = [e for e in self._corruptions
                             if e.at_block > block]
        return due

    def prefill_stalled(self, block: int) -> bool:
        """True while a ``PrefillStall`` window covers engine block
        ``block`` (the first due stall opens its window when queried)."""
        if self._stall_until is not None:
            if block < self._stall_until:
                return True
            self._stall_until = None
        for i, e in enumerate(self._stalls):
            if e.at_block <= block:
                self._stalls.pop(i)
                self._stall_until = block + e.steps
                return True
        return False

    def flood_requests(self, block: int, vocab: int) -> list:
        """Consume every ``QueueFlood`` due at ``block`` and materialise
        its synthetic requests (greedy, seeded random prompts).

        Args:
          block: current engine block (1-based step counter).
          vocab: vocabulary size to draw prompt tokens from.

        Returns:
          List of ``repro_torch.serve.Request`` to submit (possibly empty).
        """
        from repro_torch.serve.scheduler import Request  # noqa: PLC0415 (cycle)

        due = [e for e in self._floods if e.at_block <= block]
        self._floods = [e for e in self._floods if e.at_block > block]
        out = []
        for e in due:
            for _ in range(e.count):
                toks = self._rng.integers(
                    0, vocab, (e.prompt_len,)
                ).astype(np.int32)
                out.append(Request(tokens=toks,
                                   max_new_tokens=e.max_new_tokens))
        return out

    # -- constructors --------------------------------------------------------

    @classmethod
    def random(
        cls,
        seed: int,
        *,
        horizon: int = 12,
        slots: int = 2,
        max_floods: int = 2,
        flood_prompt_len: int = 8,
        flood_max_new: int = 4,
    ) -> "FaultPlan":
        """A randomized (but seed-deterministic) plan for fuzzing.

        Draws 0-2 of each event class with blocks in ``[1, horizon]`` and
        slot indices in ``[0, slots)``; flood prompts use lengths/budgets
        the caller knows fit the engine's ``n_max``.

        Args:
          seed: determines the whole plan (events AND flood prompts).
          horizon: latest block an event may fire at.
          slots: engine ``max_slots`` (corruption target range).
          max_floods: cap on flood events.
          flood_prompt_len: prompt length of synthetic flood requests.
          flood_max_new: decode budget of synthetic flood requests.

        Returns:
          A fresh ``FaultPlan``.
        """
        r = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        for _ in range(int(r.integers(0, 3))):
            events.append(DispatchFailure(at_block=int(r.integers(1, horizon)),
                                          count=int(r.integers(1, 3))))
        for _ in range(int(r.integers(0, 3))):
            events.append(SlotCorruption(
                at_block=int(r.integers(1, horizon)),
                slot=int(r.integers(0, slots)),
                mode=("nan", "inf")[int(r.integers(0, 2))],
            ))
        for _ in range(int(r.integers(0, 2))):
            events.append(PrefillStall(at_block=int(r.integers(1, horizon)),
                                       steps=int(r.integers(1, 4))))
        for _ in range(int(r.integers(0, max_floods + 1))):
            events.append(QueueFlood(
                at_block=int(r.integers(1, horizon)),
                count=int(r.integers(1, 5)),
                prompt_len=flood_prompt_len,
                max_new_tokens=flood_max_new,
            ))
        return cls(events, seed=seed)


def standard_trace(slot: int = 0, seed: int = 0) -> FaultPlan:
    """The repo's standard fault trace: 1 dispatch failure + 1 NaN slot
    corruption + a queue-overflow flood.

    Under it the engine must finish with every request in a terminal
    status and every ``Status.OK`` output token-identical to a fault-free
    run (tests/test_torch_sched.py, ``chip_smoke.py`` phase 10).

    Args:
      slot: slot index the NaN corruption targets.
      seed: flood-prompt seed.

    Returns:
      A fresh ``FaultPlan`` with the three standard events.
    """
    return FaultPlan(
        events=(
            QueueFlood(at_block=1, count=6, prompt_len=8, max_new_tokens=4),
            DispatchFailure(at_block=2, count=1),
            SlotCorruption(at_block=3, slot=slot, mode="nan"),
        ),
        seed=seed,
    )
