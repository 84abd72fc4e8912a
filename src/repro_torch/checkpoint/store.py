"""Atomic, async checkpoint store (the JAX package's layout).

Layout:  <dir>/step_<N>/host_0.npz + COMMIT marker (one host).

  * atomic — arrays land in ``step_N.tmp/`` first, the file is moved
    into ``step_N/`` and a COMMIT file is written last; a crash mid-save
    leaves no half-readable checkpoint and ``latest_step`` ignores
    uncommitted directories.
  * async — ``save_checkpoint(..., block=False)`` copies the tree to host
    memory at once and writes it on a daemon thread; ``wait_for_saves()``
    joins pending writes.
  * retention — keep the newest ``keep`` checkpoints.

Leaves are keyed by their tree path (``repro_torch.tree``).  numpy has no
bfloat16, so bf16 tensors are stored as their uint16 bit pattern (a torch
``.view``) beside a dtype manifest; ``restore_checkpoint`` casts each leaf
to its template's dtype and device.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_unflatten

_PENDING: List[threading.Thread] = []
_MANIFEST = "__dtype_manifest__"
_FILE = "host_0.npz"  # the JAX package's name for host 0's shard


def _encode(t: torch.Tensor):
    """Tensor -> (numpy array, dtype name when stored as raw bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), None


def _decode(arr: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    block: bool = True,
    keep: int = 3,
) -> str:
    """Write ``tree`` at ``step``.  Returns the final path."""
    os.makedirs(directory, exist_ok=True)
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    # snapshot to host memory NOW (so async writes see a consistent state)
    flat, manifest = {}, {}
    for key, leaf in tree_items(tree):
        flat[key], ext = _encode(torch.as_tensor(leaf))
        if ext:
            manifest[key] = ext

    def write():
        os.makedirs(tmp, exist_ok=True)
        flat[_MANIFEST] = np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8)
        np.savez(os.path.join(tmp, _FILE), **flat)
        os.makedirs(final, exist_ok=True)
        os.replace(os.path.join(tmp, _FILE), os.path.join(final, _FILE))
        shutil.rmtree(tmp, ignore_errors=True)
        with open(os.path.join(final, "COMMIT"), "w") as f:  # last
            json.dump({"step": step}, f)
        _retention(directory, keep)

    if block:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    return final


def wait_for_saves() -> None:
    """Join every pending asynchronous save."""
    while _PENDING:
        _PENDING.pop().join()


def _retention(directory: str, keep: int) -> None:
    steps = sorted(_committed_steps(directory))
    for s in steps[:-keep] if keep else []:
        shutil.rmtree(_step_dir(directory, s), ignore_errors=True)


def _committed_steps(directory: str) -> List[int]:
    out = []
    if not os.path.isdir(directory):
        return out
    for name in os.listdir(directory):
        if name.startswith("step_") and os.path.exists(
            os.path.join(directory, name, "COMMIT")
        ):
            try:
                out.append(int(name.split("_")[1]))
            except ValueError:  # a step_N.tmp directory
                continue
    return out


def latest_step(directory: str) -> Optional[int]:
    """Newest committed step in ``directory`` (None when there is none)."""
    steps = _committed_steps(directory)
    return max(steps) if steps else None


def restore_checkpoint(directory: str, template: Any, step: Optional[int] = None) -> Any:
    """Load into the structure of ``template``; each leaf takes its template
    leaf's dtype and device.  ``step`` defaults to the newest committed one.
    Raises when the file's keys or shapes differ from the template's."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(_step_dir(directory, step), _FILE)
    with np.load(path) as data:
        manifest = {}
        if _MANIFEST in data:
            manifest = json.loads(bytes(data[_MANIFEST]).decode())
        items = list(tree_items(template))
        extra = set(data.files) - {_MANIFEST} - {key for key, _ in items}
        if extra:
            raise ValueError(f"{path} holds keys the template lacks: {sorted(extra)[:5]}")
        leaves = []
        for key, tmpl in items:
            t = _decode(data[key], manifest.get(key))
            tmpl = torch.as_tensor(tmpl)
            if t.shape != tmpl.shape:
                raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, template "
                                 f"{tuple(tmpl.shape)}")
            leaves.append(t.to(device=tmpl.device, dtype=tmpl.dtype))
    return tree_unflatten(template, leaves)
