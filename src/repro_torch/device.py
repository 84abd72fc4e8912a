"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


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
