"""Frozen work counts of the three Taylor-attention kernels: operations and
bytes of one launch, from its shape alone.

The formulas are those of the port's ``kernels/taylor_attention/cost.py``
as it stood when this benchmark was written, changed in three ways so that
they count the work and not one way of doing it: the chunk is fixed at
``CHUNK`` whatever chunk a kernel uses; every operation counts once, at the
bf16 peak, whatever precision or split a kernel computes it in; and ``d``
and ``dv`` are the model's own head dims, not a kernel's padding.
Operations count a multiply-add as two; bytes count each input read once
and each output written once.
"""

from __future__ import annotations

from typing import Dict, Tuple

CHUNK = 64


def fwd(bk: int, g: int, n: int, d: int, dv: int, itemsize: int, order: int = 2
        ) -> Tuple[float, float]:
    """(operations, bytes) of one forward launch: ``bk`` batch·kv-head rows,
    ``g`` query heads per kv head, ``n`` positions."""
    sq, cube = (2 * d * d, 2 * d * d * dv) if order >= 2 else (0, 0)
    lin = 2 * d * dv + 2 * d
    tri = (CHUNK + 1) / 2
    tensor = bk * g * n * cube + bk * g * n * sq + bk * n * cube + bk * n * sq
    ops = bk * (g * n * tri * 2 * (d + dv) + (g + 1) * n * lin) + tensor
    nbytes = itemsize * (bk * g * n * d + bk * n * d + bk * n * dv + bk * g * n * dv)
    return ops, nbytes


def bwd(bk: int, g: int, n: int, d: int, dv: int, itemsize: int, order: int = 2
        ) -> Dict[str, Tuple[float, float]]:
    """{"dq", "dkv", "pair"}: (operations, bytes) of the backward pair's
    launches (den and dden pass from the first to the second and are not
    the pair's bytes)."""
    sq = 2 * d * d if order >= 2 else 0
    cube = 2 * d * d * dv if order >= 2 else 0
    fold = 2 * d * dv if order >= 2 else 0
    lin = 2 * d * dv
    rows = g * n
    tri = (CHUNK + 1) / 2
    dq_tensor = bk * rows * cube + bk * rows * sq + bk * n * cube + bk * n * sq
    dq_ops = bk * (
        rows * tri * (2 * d + 2 * dv + 2 * d)
        + rows * (2 * d + 2 * dv)
        + rows * (lin + 2 * d)
        + rows * (fold + (4 * d if order >= 2 else 0))
        + n * (lin + d)
    ) + dq_tensor
    dkv_tensor = bk * n * cube + bk * n * sq + bk * rows * cube + bk * rows * sq
    dkv_ops = bk * (
        n * (2 * lin + 2 * fold)
        + rows * tri * (2 * d + 2 * dv + 2 * dv + 2 * d)
        + rows * (lin + 2 * d + dv)
    ) + dkv_tensor
    f32 = 4
    inputs = itemsize * bk * (g * n * d + n * d + n * dv + g * n * dv)
    out_b = itemsize * bk * g * n * dv
    rows_b = 2 * f32 * bk * g * n
    dq_b = f32 * bk * g * n * d
    dkdv_b = f32 * bk * n * (d + dv)
    return {
        "dq": (dq_ops, inputs + out_b + dq_b + rows_b),
        "dkv": (dkv_ops, inputs + rows_b + dkdv_b),
        "pair": (dq_ops + dkv_ops, inputs + out_b + dq_b + dkdv_b),
    }

