"""Hand-written CUDA kernels for causal Taylor attention: build + binding.

``taylor_fwd`` and ``taylor_bwd`` are the raw kernel entries in kernel
layout (grouped, padded, pre-normalised).  On CUDA tensors they launch the
kernels of ``csrc/`` (compiled with ``nvcc`` for ``sm_90a`` at first use,
one shared library per source, loaded with ctypes) and count each launch
(``taylor_fwd.launches``, ``taylor_bwd.dq_launches``,
``taylor_bwd.dkv_launches``; ``taylor_fwd.tensor_row_launches``,
``taylor_bwd.dq_tensor_row_launches`` and
``taylor_bwd.dkv_tensor_row_launches`` count the launches at a head dim of
``TENSOR_ROWS``, whose intra-chunk tiles run on the tensor cores); on CPU
tensors they run the plain PyTorch versions of ``ref.py``.  A failed build
or launch raises — nothing falls back to the plain version on the card.
The three kernels are the
``torch.library`` ops ``repro_torch::taylor_fwd``, ``taylor_bwd_dq`` and
``taylor_bwd_dkv``, each with a fake implementation (meta and fake tensors:
shapes only, no launch, no count) and a flop formula from ``cost.py``.
Set-up spans (``repro_torch.spans.once``): ``kernels.first_call.<op>``
around each CUDA implementation's first call, and inside it
``kernels.build.<source>`` and ``kernels.bind.<source>``.

They replace the TPU kernels of ``repro/kernels/taylor_attention/``:
``kernel.py::_taylor_fwd_kernel`` (``csrc/taylor_fwd.cu``) and
``kernel_bwd.py::_taylor_bwd_dq_kernel`` / ``_taylor_bwd_dkv_kernel``
(``csrc/taylor_bwd.cu``); the design notes are at the top of each source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch import spans
from repro_torch.device import on_card
from repro_torch.kernels.taylor_attention.cost import taylor_bwd_cost, taylor_fwd_cost
from repro_torch.kernels.taylor_attention.ref import (
    taylor_attention_ref,
    taylor_bwd_dkv_ref,
    taylor_bwd_dq_ref,
)

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"taylor_fwd": CSRC / "taylor_fwd.cu", "taylor_bwd": CSRC / "taylor_bwd.cu"}
# <repo>/build/repro_torch: listed in .gitignore, made at first use.
BUILD_DIR = Path(__file__).resolve().parents[4] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

# Head dim -> (value tile, chunk) of one forward block; mirrors ``Tiles<D>`` in
# taylor_fwd.cu (the backward uses the same value tiles and a chunk of
# BWD_CHUNK, which divides every forward chunk).  The wrapper pads d up to a
# key, dv to a multiple of the value tile and n to a multiple of the chunk.
TILES = {16: (16, 128), 32: (32, 128), 64: (8, 128), 128: (1, 64)}
MAX_HEAD_DIM = max(TILES)
# Head dims whose kernels run the causal intra-chunk tiles on the tensor cores,
# with all eight warps: those whose block holds one value column; mirrors
# ``Layout<D>::tensor_rows`` in taylor_fwd.cu and ``Dims<D>::tensor_rows`` in
# taylor_bwd.cu (both DVT == 1).  The others walk their rows on the CUDA cores.
TENSOR_ROWS = frozenset(d for d, (dvt, _) in TILES.items() if dvt == 1)
BWD_CHUNK = 64

_libs: Dict[str, ctypes.CDLL] = {}
build_log = ""


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build the kernels")
    return found


def _lib_path(name: str) -> Path:
    """The library built from ``SOURCES[name]``, named by a hash of the source,
    every header of ``csrc/`` (the sources include them) and the flags."""
    key = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"


def build(*names: str) -> Dict[str, Path]:
    """Compile the named sources (default: all of ``SOURCES``) into shared
    libraries, cached by content; one ``nvcc`` per source, all started
    together.

    Returns the library path of each name.  The compiler's output
    (``-Xptxas=-v``: registers, shared memory, spills) is kept in
    ``build_log``."""
    global build_log
    names = names or tuple(SOURCES)
    paths = {name: _lib_path(name) for name in names}
    todo = {name: path for name, path in paths.items() if not path.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, path in todo.items():
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log = proc.communicate()[0]
        build_log += f"--- nvcc {SOURCES[name].name}\n{log}"
        if proc.returncode != 0:
            failed.append(f"{name} ({proc.returncode})")
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{build_log}")
    build_log += (f"built {', '.join(p.name for p in todo.values())} in "
                  f"{time.perf_counter() - t0:.1f} s\n")
    return paths


def bind(path: Path, name: str) -> ctypes.CDLL:
    """Loads a shared library built from ``SOURCES[name]`` (or another build
    of the same source) and declares its C functions' signatures."""
    lib = ctypes.CDLL(str(path))
    p = ctypes.c_void_p
    i = ctypes.c_int
    f = ctypes.c_float
    if name == "taylor_fwd":
        lib.taylor_fwd_launch.argtypes = [p, p, p, p, i, i, i, i, i, f, i, i, p]
        lib.taylor_fwd_launch.restype = i
    else:
        for fn in (lib.taylor_bwd_dq_launch, lib.taylor_bwd_dkv_launch):
            fn.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, p]
            fn.restype = i
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [i]
    err_fn.restype = ctypes.c_char_p
    return lib


def _library(name: str) -> ctypes.CDLL:
    if name not in _libs:
        with spans.once(f"kernels.build.{name}"):
            path = build(name)[name]
        with spans.once(f"kernels.bind.{name}"):
            _libs[name] = bind(path, name)
    return _libs[name]


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for all-CPU tensors, False for all-CUDA ones (or all-meta ones
    inside ``device.card_trace``, which stand for CUDA ones); raises
    otherwise."""
    if all(t.device.type == "cpu" for t in tensors):
        return True
    if all(on_card(t.device) for t in tensors):
        return False
    raise ValueError("the Taylor kernels need all-CPU or all-CUDA tensors, got "
                     + ", ".join(str(t.device) for t in tensors))


def _check_cuda_inputs(what: str, *tensors: torch.Tensor) -> None:
    dtype = tensors[0].dtype
    if dtype not in (torch.float32, torch.bfloat16) or any(
        t.dtype != dtype for t in tensors
    ):
        raise TypeError(f"{what} takes float32 or bfloat16 tensors of one dtype, got "
                        + ", ".join(str(t.dtype) for t in tensors))


def _fwd_chunk(d: int) -> int:
    """The forward's chunk at head dim ``d`` (the tile ``d`` pads up to)."""
    return TILES[next((t for t in sorted(TILES) if t >= d), MAX_HEAD_DIM)][1]


# ---------------------------------------------------------------------------
# The kernels as ``torch.library`` ops.  Each op has three implementations:
# CUDA (the ctypes launch, counted), CPU (the plain version of ``ref.py``)
# and fake (shapes and dtypes only; it serves meta and fake tensors, so a
# traced program allocates and launches nothing).  Each has a flop formula
# from ``cost.py`` for ``torch.utils.flop_counter.FlopCounterMode``: the
# kernels are reached through ctypes, which the counter cannot see into.
# ---------------------------------------------------------------------------


@torch.library.custom_op("repro_torch::taylor_fwd", mutates_args=(), device_types="cpu")
def _fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, alpha: float,
            order: int) -> torch.Tensor:
    return taylor_attention_ref(q[None], k[None], v[None], alpha=alpha, order=order)[0]


@_fwd_op.register_kernel("cuda")
def _fwd_cuda(q, k, v, alpha, order):
    q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
               for t in (q.contiguous(), k.contiguous(), v.contiguous()))
    with spans.once("kernels.first_call.taylor_fwd"):
        out = launch_fwd(_library("taylor_fwd"), q, k, v, alpha, order)
    taylor_fwd.launches += 1
    if q.shape[-1] in TENSOR_ROWS:
        taylor_fwd.tensor_row_launches += 1
    return out


@_fwd_op.register_fake
def _fwd_fake(q, k, v, alpha, order):
    return v.new_empty(q.shape[:3] + v.shape[-1:])


@register_flop_formula(torch.ops.repro_torch.taylor_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, alpha, order, *args, **kwargs) -> int:
    bk, g, n, d = q_shape
    return round(taylor_fwd_cost(bk, g, n, d, v_shape[-1], _fwd_chunk(d), 0, order)[0])


@torch.library.custom_op("repro_torch::taylor_bwd_dq", mutates_args=(), device_types="cpu")
def _dq_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
           out: torch.Tensor, alpha: float, order: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(t[0] for t in taylor_bwd_dq_ref(
        q[None], k[None], v[None], dout[None], out[None], alpha=alpha, order=order))


@_dq_op.register_kernel("cuda")
def _dq_cuda(q, k, v, dout, out, alpha, order):
    ins = [t.contiguous() for t in (q, k, v, dout, out)]
    with spans.once("kernels.first_call.taylor_bwd_dq"):
        grads = launch_bwd_dq(_library("taylor_bwd"), *ins, alpha, order)
    taylor_bwd.dq_launches += 1
    if q.shape[-1] in TENSOR_ROWS:
        taylor_bwd.dq_tensor_row_launches += 1
    return grads


@_dq_op.register_fake
def _dq_fake(q, k, v, dout, out, alpha, order):
    f32 = torch.float32
    return (q.new_empty(q.shape, dtype=f32), q.new_empty(q.shape[:3], dtype=f32),
            q.new_empty(q.shape[:3], dtype=f32))


@register_flop_formula(torch.ops.repro_torch.taylor_bwd_dq)
def _dq_flops(q_shape, k_shape, v_shape, dout_shape, out_shape_, alpha, order, *args,
              **kwargs) -> int:
    bk, g, n, d = q_shape
    cost = taylor_bwd_cost(bk, g, n, d, v_shape[-1], BWD_CHUNK, 0, order)
    return round(cost["taylor_bwd_dq"][0])


@torch.library.custom_op("repro_torch::taylor_bwd_dkv", mutates_args=(), device_types="cpu")
def _dkv_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
            den: torch.Tensor, dden: torch.Tensor, alpha: float, order: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    dk, dv = taylor_bwd_dkv_ref(q[None], k[None], v[None], dout[None], den[None],
                                dden[None], alpha=alpha, order=order)
    return dk[0], dv[0]


@_dkv_op.register_kernel("cuda")
def _dkv_cuda(q, k, v, dout, den, dden, alpha, order):
    ins = [t.contiguous() for t in (q, k, v, dout, den, dden)]
    with spans.once("kernels.first_call.taylor_bwd_dkv"):
        grads = launch_bwd_dkv(_library("taylor_bwd"), *ins, alpha, order)
    taylor_bwd.dkv_launches += 1
    if q.shape[-1] in TENSOR_ROWS:
        taylor_bwd.dkv_tensor_row_launches += 1
    return grads


@_dkv_op.register_fake
def _dkv_fake(q, k, v, dout, den, dden, alpha, order):
    f32 = torch.float32
    return k.new_empty(k.shape, dtype=f32), v.new_empty(v.shape, dtype=f32)


@register_flop_formula(torch.ops.repro_torch.taylor_bwd_dkv)
def _dkv_flops(q_shape, k_shape, v_shape, dout_shape, den_shape, dden_shape, alpha, order,
               *args, **kwargs) -> int:
    bk, g, n, d = q_shape
    cost = taylor_bwd_cost(bk, g, n, d, v_shape[-1], BWD_CHUNK, 0, order)
    return round(cost["taylor_bwd_dkv"][0])


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
    them), and all three tensors float32 or bfloat16 of one dtype; they
    are made contiguous and 16-byte aligned (the kernel loads 16 bytes at
    a time) by a copy where they are not.  Runs the op
    ``repro_torch::taylor_fwd``.

    Returns:
      ``[bk, g, n, dv]`` in v's dtype.
    """
    bk, g, n, d = q.shape
    dv = v.shape[-1]
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    if k.shape != (bk, n, d) or v.shape[:2] != (bk, n):
        raise ValueError(f"shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}")
    if not _on_cpu(q, k, v):
        _check_cuda_inputs("taylor_fwd", q, k, v)
        if d not in TILES:
            raise ValueError(f"head dim {d} not in the kernel's tiles {sorted(TILES)}")
        dvt, chunk = TILES[d]
        if n % chunk or dv % dvt:
            raise ValueError(f"n={n} must be a multiple of {chunk} and dv={dv} of {dvt}")
    return _fwd_op(q, k, v, float(alpha), int(order))


taylor_fwd.launches = 0
taylor_fwd.tensor_row_launches = 0


def launch_fwd(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               alpha: float, order: int) -> torch.Tensor:
    """Runs ``taylor_fwd_launch`` of ``lib`` (see ``bind``) on checked,
    contiguous, 16-byte aligned CUDA tensors; raises on a launch error.
    Counts nothing: the op's CUDA implementation is the counted entry."""
    bk, g, n, d = q.shape
    dv = v.shape[-1]
    out = torch.empty((bk, g, n, dv), dtype=v.dtype, device=v.device)
    a = 1.0 / (alpha * d**0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.taylor_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            bk, g, n, d, dv, a, order, int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"taylor_fwd launch failed: "
                           f"{lib.taylor_fwd_error_string(err).decode()} ({err})")
    return out


def _bwd_checks(q, k, v, dout, order, *more) -> bool:
    """Validates a backward launch; True when it runs the plain version (all
    tensors, ``more`` included, on the CPU)."""
    bk, g, n, d = q.shape
    dv = v.shape[-1]
    if order not in (1, 2):
        raise ValueError(f"order must be 1 or 2, got {order}")
    if k.shape != (bk, n, d) or v.shape[:2] != (bk, n) or dout.shape != (bk, g, n, dv):
        raise ValueError(f"shape mismatch: q {q.shape}, k {k.shape}, v {v.shape}, "
                         f"dout {dout.shape}")
    if _on_cpu(q, k, v, dout, *more):
        return True
    _check_cuda_inputs("taylor_bwd", q, k, v, dout)
    if d not in TILES:
        raise ValueError(f"head dim {d} not in the kernel's tiles {sorted(TILES)}")
    dvt = TILES[d][0]
    if n % BWD_CHUNK or dv % dvt:
        raise ValueError(f"n={n} must be a multiple of {BWD_CHUNK} and dv={dv} of {dvt}")
    return False


def launch_bwd_dq(lib: ctypes.CDLL, q, k, v, dout, out, alpha: float, order: int):
    """Runs ``taylor_bwd_dq_launch`` of ``lib`` (see ``bind``) on checked,
    contiguous CUDA tensors: ``(dq, den, dden)`` float32; raises on a launch
    error.  Counts nothing: the op's CUDA implementation is the counted
    entry."""
    bk, g, n, d = q.shape
    dq = torch.zeros((bk, g, n, d), dtype=torch.float32, device=q.device)
    den = torch.empty((bk, g, n), dtype=torch.float32, device=q.device)
    dden = torch.empty_like(den)
    _launch_bwd(lib, "taylor_bwd_dq_launch", (q, k, v, dout, out), (dq, den, dden),
                alpha, order)
    return dq, den, dden


def launch_bwd_dkv(lib: ctypes.CDLL, q, k, v, dout, den, dden, alpha: float, order: int):
    """Runs ``taylor_bwd_dkv_launch`` of ``lib`` as ``launch_bwd_dq`` does:
    ``(dk, dv)`` float32."""
    bk, g, n, d = q.shape
    dk = torch.zeros((bk, n, d), dtype=torch.float32, device=q.device)
    dv = torch.empty((bk, n, v.shape[-1]), dtype=torch.float32, device=q.device)
    _launch_bwd(lib, "taylor_bwd_dkv_launch", (q, k, v, dout, den, dden), (dk, dv),
                alpha, order)
    return dk, dv


def _launch_bwd(lib, fn_name: str, tensors, outs, alpha, order) -> None:
    bk, g, n, d = tensors[0].shape
    a = 1.0 / (alpha * d**0.5)
    bf16 = int(tensors[0].dtype == torch.bfloat16)
    with torch.cuda.device(tensors[0].device):
        stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
        err = getattr(lib, fn_name)(
            *(t.data_ptr() for t in tensors), *(t.data_ptr() for t in outs),
            bk, g, n, d, tensors[2].shape[-1], a, order, bf16, stream,
        )
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: {lib.taylor_bwd_error_string(err).decode()} "
                           f"({err})")


def taylor_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    out: torch.Tensor, *, alpha: float, order: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward pass 1 (kernel layout): ``(dq, den, dden)`` float32.

    ``dq [bk, g, n, d]``; ``den`` (clamped) and ``dden`` ``[bk, g, n]`` feed
    pass 2.  Runs the op ``repro_torch::taylor_bwd_dq``, whose CUDA
    implementation counts its launch in ``taylor_bwd.dq_launches`` (and in
    ``taylor_bwd.dq_tensor_row_launches`` at a head dim of ``TENSOR_ROWS``)."""
    if out.shape != dout.shape:
        raise ValueError(f"out {out.shape} and dout {dout.shape} differ in shape")
    if not _bwd_checks(q, k, v, dout, order, out):
        _check_cuda_inputs("taylor_bwd", q, out)
    return _dq_op(q, k, v, dout, out, float(alpha), int(order))


def taylor_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, dout: torch.Tensor,
    den: torch.Tensor, dden: torch.Tensor, *, alpha: float, order: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backward pass 2 (kernel layout): ``(dk [bk, n, d], dv [bk, n, dv])``
    float32 from pass 1's ``den``/``dden``.  Runs the op
    ``repro_torch::taylor_bwd_dkv``, whose CUDA implementation counts its
    launch in ``taylor_bwd.dkv_launches`` (and in
    ``taylor_bwd.dkv_tensor_row_launches`` at a head dim of ``TENSOR_ROWS``)."""
    bk, g, n, d = q.shape
    if not _bwd_checks(q, k, v, dout, order, den, dden) and (
        den.dtype != torch.float32 or dden.dtype != torch.float32
        or not den.shape == dden.shape == (bk, g, n)
    ):
        raise ValueError("den and dden must be float32 [bk, g, n] (pass 1's rows)")
    return _dkv_op(q, k, v, dout, den, dden, float(alpha), int(order))


def taylor_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    dout: torch.Tensor,
    out: torch.Tensor,
    *,
    alpha: float,
    order: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Gradients of ``taylor_fwd`` in kernel layout, via the two-pass pair.

    Args:
      q: grouped, pre-normalised queries ``[bk, g, n, d]``.
      k: pre-normalised keys ``[bk, n, d]``.
      v: values ``[bk, n, dv]``.
      dout: output cotangent ``[bk, g, n, dv]`` (zero in padded rows/columns).
      out: the saved forward output ``[bk, g, n, dv]``.
      alpha: the forward's logit scale, ``a = 1 / (alpha·√d)``.
      order: Taylor order, 1 or 2.

    On CUDA tensors ``d`` must be a key of ``TILES``, ``dv`` a multiple of
    its value tile and ``n`` of ``BWD_CHUNK``, and q/k/v/dout/out float32 or
    bfloat16 of one dtype.  On CPU tensors it runs the plain version
    (``ref.taylor_attention_bwd_ref``).

    Returns:
      ``(dq [bk, g, n, d], dk [bk, n, d], dv [bk, n, dv])`` float32.
    """
    dq, den, dden = taylor_bwd_dq(q, k, v, dout, out, alpha=alpha, order=order)
    dk, dv_ = taylor_bwd_dkv(q, k, v, dout, den, dden, alpha=alpha, order=order)
    return dq, dk, dv_


taylor_bwd.dq_launches = 0
taylor_bwd.dkv_launches = 0
taylor_bwd.dq_tensor_row_launches = 0
taylor_bwd.dkv_tensor_row_launches = 0
