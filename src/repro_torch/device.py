"""Device resolution for the port's entry points, and the card's trace.

``card_trace`` lets a program run on meta tensors as it would on the card:
inside it ``on_card`` holds for the meta device, so every choice that the
port makes by device (the Taylor kernels' route, their checks) takes the
CUDA branch, and the kernels' ``torch.library`` ops dispatch to their fake
implementations.  Nothing is allocated or launched.  The analysis layer
(``repro_torch.analysis``) and the dry run (``launch/dryrun.py``) count
FLOPs, bytes, live memory and collectives that way, on this or any host.
(A fake tensor that claims ``cuda`` serves a forward, but autograd over one
aborts the process where torch is built without CUDA: it asks for a CUDA
device guard.  Meta tensors have no such need.)
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional, Union

import torch

_CARD_TRACE: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_card_trace", default=False)


@contextlib.contextmanager
def card_trace():
    """Within it, meta tensors stand for tensors on the CUDA card."""
    token = _CARD_TRACE.set(True)
    try:
        yield
    finally:
        _CARD_TRACE.reset(token)


def on_card(device: torch.device) -> bool:
    """True for a CUDA device, and for the meta device inside ``card_trace``."""
    return device.type == "cuda" or (device.type == "meta" and _CARD_TRACE.get())


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the CUDA card: it raises when CUDA is unavailable rather
    than running on the CPU unasked.  Pass ``device="cpu"`` to run the plain
    PyTorch paths on the CPU (the tests do).

    Args:
      device: ``None``, ``"cpu"``, ``"cuda"``, ``"cuda:N"`` or a
        ``torch.device``.

    Returns:
      The resolved ``torch.device``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev
