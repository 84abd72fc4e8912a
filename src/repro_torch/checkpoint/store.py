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

A sharded tree (each rank's blocks, ``placements=`` a
``distributed.sharding.Placements``) is saved as its whole leaves, put
together on every rank and written once, by rank 0; every rank of the
mesh must call ``save_checkpoint``, and the save blocks.  Restoring with
``placements=`` cuts each whole leaf into this rank's block, on any mesh:
the elastic reshard path.  ``np.savez`` stores its members uncompressed,
so a restore maps each member's bytes from the file (after checking its
CRC-32) and copies only the block it needs.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import warnings
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import TYPE_CHECKING, Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.tree import tree_items, tree_unflatten

if TYPE_CHECKING:
    from repro_torch.distributed.sharding import Placements

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
    """The stored array as a tensor over the same memory (a read-only map
    of the file: the caller copies what it keeps)."""
    if name == "bfloat16":
        arr = arr.view(np.int16)
    with warnings.catch_warnings():  # read-only: torch warns, nothing writes to it
        warnings.simplefilter("ignore", UserWarning)
        t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def _members(path: str) -> Dict[str, np.ndarray]:
    """Each ``.npy`` member of an ``.npz`` as a read-only map of its bytes
    in the file (no copy), after a check of every member's CRC-32 against
    the archive's (threads share the members): a corrupted or truncated
    checkpoint raises.  ``np.savez`` stores members uncompressed; a
    compressed member raises."""
    spans = []
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED or not info.filename.endswith(".npy"):
                raise ValueError(f"{path}: member {info.filename} is not a stored .npy "
                                 "(the store reads np.savez archives)")
            f.seek(info.header_offset + 26)  # the local header's name and extra lengths
            name_len, extra_len = struct.unpack("<HH", f.read(4))
            spans.append((info, info.header_offset + 30 + name_len + extra_len))
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        crcs = list(pool.map(lambda span: _crc32(path, span[1], span[0].file_size), spans))
    out = {}
    with open(path, "rb") as f:
        for (info, start), crc in zip(spans, crcs):
            if crc != info.CRC:
                raise ValueError(f"{path}: member {info.filename} fails its CRC-32 check "
                                 "(a corrupted or truncated checkpoint)")
            f.seek(start)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            order = "F" if fortran else "C"
            if dtype.hasobject:
                raise ValueError(f"{path}: member {info.filename} holds Python objects")
            if int(np.prod(shape)) == 0:
                out[info.filename[:-4]] = np.empty(shape, dtype=dtype, order=order)
                continue
            out[info.filename[:-4]] = np.memmap(path, dtype=dtype, mode="r", offset=f.tell(),
                                                shape=shape, order=order)
    return out


def _crc32(path: str, offset: int, size: int, block: int = 1 << 26) -> int:
    """CRC-32 of ``size`` bytes of the file from ``offset``."""
    crc = 0
    with open(path, "rb") as f:
        f.seek(offset)
        while size > 0:
            chunk = f.read(min(block, size))
            if not chunk:
                break  # truncated: the CRC cannot match
            crc = zlib.crc32(chunk, crc)
            size -= len(chunk)
    return crc


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:010d}")


def save_checkpoint(
    directory: str,
    step: int,
    tree: Any,
    block: bool = True,
    keep: int = 3,
    placements: Optional["Placements"] = None,
) -> str:
    """Write ``tree`` at ``step``.  Returns the final path.  With
    ``placements`` the leaves are blocks: they are gathered whole (one leaf
    at a time), rank 0 writes them and every rank waits until it has."""
    final = _step_dir(directory, step)
    tmp = final + ".tmp"
    writer = placements is None or _rank() == 0
    specs = None if placements is None else [s for _, s in tree_items(placements.specs)]
    # snapshot to host memory NOW (so async writes see a consistent state);
    # a block is gathered whole one leaf at a time
    flat, manifest = {}, {}
    for i, (key, leaf) in enumerate(tree_items(tree)):
        leaf = torch.as_tensor(leaf)
        if specs is not None:
            from repro_torch.distributed.sharding import gather_leaf  # noqa: PLC0415

            leaf = gather_leaf(leaf, specs[i], placements.mesh)
        if writer:
            flat[key], ext = _encode(leaf)
            if ext:
                manifest[key] = ext
        del leaf

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

    if writer and (block or placements is not None):
        write()
    elif writer:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _PENDING.append(t)
    if placements is not None:
        _barrier()  # every rank returns once the checkpoint is committed
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


def _rank() -> int:
    import torch.distributed as dist  # noqa: PLC0415

    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    import torch.distributed as dist  # noqa: PLC0415

    if dist.is_initialized():
        dist.barrier()


def restore_checkpoint(directory: str, template: Any, step: Optional[int] = None,
                       placements: Optional["Placements"] = None) -> Any:
    """Load into the structure of ``template``; each leaf takes its template
    leaf's dtype and device.  ``step`` defaults to the newest committed one.
    Raises when the file's keys or shapes differ from the template's.

    With ``placements`` (a ``distributed.sharding.Placements`` congruent to
    ``template``) the template's leaves are this rank's blocks: each whole
    leaf is read and cut to the block its spec gives on the placements'
    mesh, whatever mesh wrote it."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    path = os.path.join(_step_dir(directory, step), _FILE)
    data = _members(path)
    manifest = {}
    if _MANIFEST in data:
        manifest = json.loads(bytes(data.pop(_MANIFEST)).decode())
    items = list(tree_items(template))
    extra = set(data) - {key for key, _ in items}
    if extra:
        raise ValueError(f"{path} holds keys the template lacks: {sorted(extra)[:5]}")
    specs = [None] * len(items)
    if placements is not None:
        from repro_torch.distributed.sharding import block_of, global_shape  # noqa: PLC0415

        specs = [s for _, s in tree_items(placements.specs)]
    leaves = []
    for (key, tmpl), spec in zip(items, specs):
        if key not in data:
            raise KeyError(f"{path} lacks {key!r}")
        t = _decode(data.pop(key), manifest.get(key))
        tmpl = torch.as_tensor(tmpl)
        shape = tuple(tmpl.shape)
        if spec is not None:
            shape = global_shape(shape, spec, placements.mesh)
        if tuple(t.shape) != shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, template {shape}")
        if spec is not None:  # cut before the copy
            t = block_of(t, spec, placements.mesh)
        leaves.append(t.to(device=tmpl.device, dtype=tmpl.dtype, copy=True))
        del t
    return tree_unflatten(template, leaves)
