"""Peak live bytes of a program: the counterpart of the reference's
``compiled.memory_analysis()``.

``PeakMemory`` is a ``TorchDispatchMode`` that follows every storage it
sees, by the storage itself: the tensors handed to it at the start (a
step's state and batch) and every tensor an op reads or writes while it is
on.  A storage counts its bytes from first sight until the storage dies (a
``weakref.finalize`` on the untyped storage), views count once, and
``peak`` is the most bytes live at once.  It works alike on real, fake and
meta tensors, so a traced rank's program (meta tensors under
``device.card_trace``) predicts what ``torch.cuda.max_memory_allocated``
reads on the card for the same program, short of the caching allocator's
rounding and the libraries' workspaces.
"""

from __future__ import annotations

import weakref
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


class PeakMemory(TorchDispatchMode):
    """Peak live bytes over the ops run while it is on.

    Args:
      *trees: tensors (in any nesting of lists, tuples and dicts) live from
        the start.
    """

    def __init__(self, *trees):
        super().__init__()
        self.live: Dict[int, int] = {}
        self.current = 0
        self.peak = 0
        for t in tree_leaves(trees):
            self._see(t)

    def _see(self, t) -> None:
        if not isinstance(t, torch.Tensor):
            return
        s = t.untyped_storage()
        key = id(s)
        if key in self.live:
            return
        n = s.nbytes()
        self.live[key] = n
        self.current += n
        self.peak = max(self.peak, self.current)
        weakref.finalize(s, self._free, key)

    def _free(self, key: int) -> None:
        self.current -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in tree_leaves((args, kwargs)):
            self._see(t)
        out = func(*args, **kwargs)
        for t in tree_leaves(out):
            self._see(t)
        return out
