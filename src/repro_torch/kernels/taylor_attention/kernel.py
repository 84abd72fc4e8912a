"""Hand-written CUDA forward kernel for causal Taylor attention: build + binding.

``taylor_fwd`` is the raw kernel entry in kernel layout (grouped, padded,
pre-normalised).  On a CUDA tensor it launches ``csrc/taylor_fwd.cu``
(compiled with ``nvcc`` for ``sm_90a`` at first use, loaded with ctypes)
and counts the launch in ``taylor_fwd.launches``; on a CPU tensor it runs
the plain PyTorch version (``ref.taylor_attention_ref``).  A failed build
or launch raises — nothing falls back to the plain version on the card.

It replaces the TPU kernel ``repro/kernels/taylor_attention/kernel.py::
_taylor_fwd_kernel``; the design notes are at the top of the CUDA source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels.taylor_attention.ref import taylor_attention_ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "taylor_fwd.cu"
# <repo>/build/repro_torch: listed in .gitignore, made at first use.
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Head dim -> (value tile, chunk) of one block; mirrors ``Tiles<D>`` in the
# CUDA source.  The wrapper pads d up to a key, dv to a multiple of the value
# tile and n to a multiple of the chunk.
TILES = {16: (16, 128), 32: (32, 128), 64: (8, 128), 128: (1, 64)}
MAX_HEAD_DIM = max(TILES)

_lib: Optional[ctypes.CDLL] = None
build_log = ""


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build taylor_fwd")
    return found


def build() -> Path:
    """Compile ``csrc/taylor_fwd.cu`` into a shared library (cached by content).

    Returns the library path.  The compiler's output (``-Xptxas=-v``:
    registers, shared memory, spills) is kept in ``build_log``."""
    global build_log
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    lib_path = BUILD_DIR / f"taylor_fwd_{key.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, lib_path)
    build_log += f"\nbuilt {lib_path.name} in {time.perf_counter() - t0:.1f} s\n"
    return lib_path


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        p = ctypes.c_void_p
        i = ctypes.c_int
        lib.taylor_fwd_launch.argtypes = [
            p, p, p, p, i, i, i, i, i, ctypes.c_float, i, i, p,
        ]
        lib.taylor_fwd_launch.restype = ctypes.c_int
        lib.taylor_fwd_error_string.argtypes = [ctypes.c_int]
        lib.taylor_fwd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def taylor_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    alpha: float,
    order: int = 2,
) -> torch.Tensor:
    """Causal Taylor attention in kernel layout.

    Args:
      q: grouped, pre-normalised queries ``[bk, g, n, d]``.
      k: pre-normalised keys ``[bk, n, d]``.
      v: values ``[bk, n, dv]``.
      alpha: logit scale, ``a = 1 / (alpha·√d)`` with this (padded) d.
      order: Taylor order, 1 or 2.

    On CUDA tensors ``d`` must be a key of ``TILES`` and ``dv``/``n``
    multiples of its value tile and chunk (``ops._kernel_layout`` pads
    them), and all three tensors contiguous float32 or bfloat16 of one
    dtype.

    Returns:
      ``[bk, g, n, dv]`` in v's dtype.
    """
    bk, g, n, d = q.shape
    dv = v.shape[-1]
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    if k.shape != (bk, n, d) or v.shape[:2] != (bk, n):
        raise ValueError(f"shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")
    if q.device.type == "cpu" and k.device.type == "cpu" and v.device.type == "cpu":
        return taylor_attention_ref(
            q[None], k[None], v[None], alpha=alpha, order=order
        )[0]
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError(f"taylor_fwd needs all-CPU or all-CUDA tensors, got "
                         f"{q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
        torch.float32, torch.bfloat16
    ):
        raise TypeError(f"taylor_fwd takes float32 or bfloat16 q/k/v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if d not in TILES:
        raise ValueError(f"head dim {d} not in the kernel's tiles {sorted(TILES)}")
    dvt, chunk = TILES[d]
    if n % chunk or dv % dvt:
        raise ValueError(f"n={n} must be a multiple of {chunk} and dv={dv} of {dvt}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((bk, g, n, dv), dtype=v.dtype, device=v.device)
    a = 1.0 / (alpha * d**0.5)
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.taylor_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bk, g, n, d, dv, a, order, int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = lib.taylor_fwd_error_string(err).decode()
        raise RuntimeError(f"taylor_fwd launch failed: {msg} ({err})")
    taylor_fwd.launches += 1
    return out


taylor_fwd.launches = 0
