"""Cost models of the three Taylor-attention kernels: operations and bytes.

One count serves every reader of a kernel's work: the flop formulas of the
kernels' ``torch.library`` ops (``kernel.py``, read by
``torch.utils.flop_counter.FlopCounterMode`` and ``analysis/flops.py``),
the bounds of ``analysis/roofline.py::bound_ms`` and ``chip_smoke.py``'s
kernel rows.  Operations count each multiply-add as two; bytes count each
input read once and each output written once.
"""

from __future__ import annotations

# TF32 products per operation of each tensor-core contraction of
# csrc/taylor_fwd.cu, as it issues them: the f32 operand is split in two, and
# bf16 q and k are exact in TF32, so the z2 update of bf16 keys takes one.
FWD_TF32_PRODUCTS = {
    "bfloat16": {"s2_read": 2, "z2_read": 2, "s2_update": 2, "z2_update": 1},
    "float32": {"s2_read": 3, "z2_read": 3, "s2_update": 3, "z2_update": 3},
}

# The same for the backward's contractions (csrc/taylor_bwd.cu): pass 1's S2
# and z2 reads and its state update, pass 2's carry read (one product for dk
# and dv), dz2 read and carry update.  Only pass 1's z2 update takes one
# product for bf16 inputs (A = k_e is exact); pass 2's dz2 update has
# A = dden·q_e, which is not.
BWD_TF32_PRODUCTS = {
    "bfloat16": {"s2_read": 2, "z2_read": 2, "s2_update": 2, "z2_update": 1,
                 "carry_read": 2, "dz2_read": 2, "ds2_update": 2, "dz2_update": 2},
    "float32": dict.fromkeys(("s2_read", "z2_read", "s2_update", "z2_update", "carry_read",
                              "dz2_read", "ds2_update", "dz2_update"), 3),
}


def taylor_fwd_cost(bk, g, n, d, dv, chunk, itemsize, order=2):
    """(operations, {contraction: operations}, bytes) of one forward:
    intra-chunk tiles (the causal triangle only: (chunk + 1) / 2 keys per
    row, for n a multiple of chunk), state reads and state updates; each
    input read once and the output written once.  The contractions are those
    that csrc/taylor_fwd.cu runs on the tensor cores (keys of
    FWD_TF32_PRODUCTS), counted once each, and are part of the operations."""
    sq, cube = (2 * d * d, 2 * d * d * dv) if order >= 2 else (0, 0)
    lin = 2 * d * dv + 2 * d
    tri = (chunk + 1) / 2                        # keys j <= i per row of a chunk
    tensor = {"s2_read": bk * g * n * cube, "z2_read": bk * g * n * sq,
              "s2_update": bk * n * cube, "z2_update": bk * n * sq}
    ops = bk * (g * n * tri * 2 * (d + dv) + (g + 1) * n * lin) + sum(tensor.values())
    nbytes = itemsize * (bk * g * n * d + bk * n * d + bk * n * dv + bk * g * n * dv)
    return ops, tensor, nbytes


def taylor_bwd_cost(bk, g, n, d, dv, chunk, itemsize, order=2):
    """{kernel: (operations, {contraction: operations}, bytes)} of the
    backward pair, from the loops of csrc/taylor_bwd.cu (chunk = its C),
    counting every term once (not once per value tile): the causal triangle
    of the C×C intra tiles ((C + 1) / 2 pairs per row, for n a multiple of
    C), the den/dden rows, the first moments and the folds of the
    contractions.  The contractions are those that csrc/taylor_bwd.cu runs
    on the tensor cores (keys of BWD_TF32_PRODUCTS), counted once each (one
    z2 product serves den and dq, one carry product dk and dv), and are part
    of the operations.  Bytes: each input read once, each output written
    once; den/dden are pass 1's outputs and pass 2's inputs, and not the
    pair's."""
    sq = 2 * d * d if order >= 2 else 0           # one d×d contraction
    cube = 2 * d * d * dv if order >= 2 else 0    # one d×d×dv contraction
    fold = 2 * d * dv if order >= 2 else 0        # one fold of a d×dv product
    lin = 2 * d * dv
    rows = g * n
    tri = (chunk + 1) / 2                         # pairs j <= i per row of a chunk
    dq_tensor = {"s2_read": bk * rows * cube, "z2_read": bk * rows * sq,
                 "s2_update": bk * n * cube, "z2_update": bk * n * sq}
    dq_ops = bk * (
        rows * tri * (2 * d + 2 * dv + 2 * d)      # scores, dp, ds·K
        + rows * (2 * d + 2 * dv)                  # den's q·z1, Σ dout·out
        + rows * (lin + 2 * d)                     # dq: S1, z1 terms
        + rows * (fold + (4 * d if order >= 2 else 0))  # folds: S2 read; z2 read (den, dq)
        + n * (lin + d)                            # S1, z1 update
    ) + sum(dq_tensor.values())
    dkv_tensor = {"carry_read": bk * n * cube, "dz2_read": bk * n * sq,
                  "ds2_update": bk * rows * cube, "dz2_update": bk * rows * sq}
    dkv_ops = bk * (
        n * (2 * lin + 2 * fold)                   # dS1 terms of dk, dv; the carry read's folds
        + rows * tri * (2 * d + 2 * dv + 2 * dv + 2 * d)  # scores, Pᵀdnum, dp, dsᵀQ
        + rows * (lin + 2 * d + dv)                # dS1, dz1, dS0 update
    ) + sum(dkv_tensor.values())
    f32 = 4
    inputs = itemsize * bk * (g * n * d + n * d + n * dv + g * n * dv)  # q, k, v, dout
    out_b = itemsize * bk * g * n * dv
    rows_b = 2 * f32 * bk * g * n                                       # den, dden
    dq_b = f32 * bk * g * n * d
    dkdv_b = f32 * bk * n * (d + dv)
    return {
        "taylor_bwd_dq": (dq_ops, dq_tensor, inputs + out_b + dq_b + rows_b),
        "taylor_bwd_dkv": (dkv_ops, dkv_tensor, inputs + rows_b + dkdv_b),
        "pair": (dq_ops + dkv_ops, {**dq_tensor, **dkv_tensor},
                 inputs + out_b + dq_b + dkdv_b),
    }
