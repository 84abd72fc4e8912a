"""The split-precision TF32 scheme of the Taylor kernels' tensor-core
contractions (``csrc/taylor_fwd.cu``, ``csrc/taylor_bwd.cu``, with the
helpers of ``csrc/tf32_mma.cuh``), emulated in numpy against float64.

The kernel evaluates the order-2 state read ``(q⊗q)·S2`` with the ``q·z2·q``
denominator term, and the state update ``S2 += (K⊗K)ᵀV`` with ``z2 += KᵀK``,
as TF32 ``mma.sync`` products (8-deep k-steps, f32 accumulation).  An f32
operand is split as hi = TF32 round-to-nearest of x, lo = x − hi, of which
the tensor core reads the top 19 bits; products a_lo·b_hi, a_hi·b_lo and
a_hi·b_hi are summed (2 of them where one operand is exact in TF32, as bf16
q and k are).  These tests hold that scheme to 1e-5 of float64 at the main
path's widths, and show that one TF32 product per element misses the 1e-4
that ``chip_smoke.py`` allows the kernel against its plain version.

The backward kernels take the same scheme, the f32 operand always as A:
pass 1's S2 read with its fold over v into dq, pass 2's carry read with its
two folds (dv over t, dk over v), and pass 2's carry update, whose A operands
q_e·dnum and dden·q_e are f32 for either input type.  The tests below hold
each to 1e-5 of float64 at d = dv = 64, G = 3 and the backward's chunk of
64, and show that one TF32 product per element misses 1e-4 in every output.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` phases 3
and 3b).
"""

from __future__ import annotations

import numpy as np
import pytest

D = DV = 64
G, N, CHUNK = 3, 256, 128
SPLIT_TOL, SINGLE_TOL = 1e-5, 1e-4
MASK = np.uint32(0xFFFFE000)


def tf32_round(x: np.ndarray) -> np.ndarray:
    """f32 -> TF32, round to nearest (ties away from zero) on the 13 low
    mantissa bits, as the kernel rounds (finite values)."""
    b = np.asarray(x, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & MASK).view(np.float32)


def tf32_read(x: np.ndarray) -> np.ndarray:
    """What the tensor core reads of an f32 register: its top 19 bits."""
    return (np.asarray(x, np.float32).view(np.uint32) & MASK).view(np.float32)


def bf16_round(x: np.ndarray) -> np.ndarray:
    b = np.asarray(x, np.float32).view(np.uint32)
    b = (b + np.uint32(0x7FFF) + ((b >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def split(x: np.ndarray):
    hi = tf32_round(x)
    return hi, tf32_read(x - hi)


def tf32_matmul(a, b, split_a, split_b, acc=None, single=False):
    """acc + a @ b (a [..., M, K], b [K, N]) as the kernel's mma.sync loop:
    k-steps of 8, f32 accumulation, small products first.  ``single``: one
    TF32 product per element (both operands rounded), the scheme's foil."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    out = np.zeros(a.shape[:-1] + b.shape[1:], np.float32) if acc is None else acc.copy()
    if single:
        ah, al, bh, bl = tf32_round(a), None, tf32_round(b), None
    else:
        ah, al = split(a) if split_a else (tf32_read(a), None)
        bh, bl = split(b) if split_b else (tf32_read(b), None)
    for k0 in range(0, a.shape[-1], 8):
        s = slice(k0, k0 + 8)
        if al is not None:
            out += al[..., s] @ bh[s]
        if bl is not None:
            out += ah[..., s] @ bl[s]
        out += ah[..., s] @ bh[s]
    return out


def _inputs(dtype: str):
    rng = np.random.default_rng(0)

    def ln(x):
        x = x - x.mean(-1, keepdims=True)
        return (x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)).astype(np.float32)

    q = ln(rng.standard_normal((G, N, D)))
    k = ln(rng.standard_normal((N, D)))
    v = rng.standard_normal((N, DV)).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = bf16_round(q), bf16_round(k), bf16_round(v)
    return q, k, v


def _state(k, v):
    """Chunk 0's moments in float64: the kernel's slab holds them in f32."""
    k0, v0 = k[:CHUNK].astype(np.float64), v[:CHUNK].astype(np.float64)
    return np.einsum("je,jf,jv->efv", k0, k0, v0), np.einsum("je,jf->ef", k0, k0)


def _rel(out, ref) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def state_read(q, s2, z2, exact_q, single=False):
    """rn[i,v] = Σ_e q_ie Σ_f q_if S2[e,f,v] and rd[i] = Σ_e q_ie Σ_f q_if
    z2[e,f] for chunk 1's queries of every head, as the kernel: A = S2 rows
    (e,v) (split), B = the queries; then the f32 fold over e."""
    qc = q[:, CHUNK:].reshape(-1, D)
    t = tf32_matmul(s2.transpose(0, 2, 1).reshape(D * DV, D), qc.T, True, not exact_q,
                    single=single).reshape(D, DV, -1)
    u = tf32_matmul(z2.T, qc.T, True, not exact_q, single=single)  # [e, i]
    rn = np.zeros((qc.shape[0], DV), np.float32)
    rd = np.zeros(qc.shape[0], np.float32)
    for e in range(D):
        rn += qc[:, e, None] * t[e].T
        rd += qc[:, e] * u[e]
    return rn, rd


def state_update(k, v, s2, z2, exact_k, single=False):
    """Chunk 1 absorbed: S2[e,f,v] += Σ_j (k_je·v_jv)·K[j,f] with A = the f32
    products k_e·v (split), B = K; z2[e,f] += Σ_j k_je·K[j,f] with A = k_e."""
    kc, vc = k[CHUNK:], v[CHUNK:]
    a = (kc.T[:, None, :] * vc.T[None]).astype(np.float32)  # [e, v, j]
    acc = s2.transpose(0, 2, 1).astype(np.float32)          # [e, v, f]
    s2_new = tf32_matmul(a, kc, True, not exact_k, acc=acc, single=single).transpose(0, 2, 1)
    z2_new = tf32_matmul(kc.T, kc, not exact_k, not exact_k, acc=z2, single=single)
    return s2_new, z2_new


def _errors(dtype: str, contraction: str, single: bool):
    q, k, v = _inputs(dtype)
    s2_64, z2_64 = _state(k, v)
    s2, z2 = s2_64.astype(np.float32), z2_64.astype(np.float32)
    exact = dtype == "bfloat16"
    if contraction == "read":
        q64 = q[:, CHUNK:].reshape(-1, D).astype(np.float64)
        ref_n = np.einsum("ie,if,efv->iv", q64, q64, s2.astype(np.float64))
        ref_d = np.einsum("ie,if,ef->i", q64, q64, z2.astype(np.float64))
        rn, rd = state_read(q, s2, z2, exact, single)
        return _rel(rn, ref_n), _rel(rd, ref_d)
    k1, v1 = k[CHUNK:].astype(np.float64), v[CHUNK:].astype(np.float64)
    ref_s = s2.astype(np.float64) + np.einsum("je,jf,jv->efv", k1, k1, v1)
    ref_z = z2.astype(np.float64) + np.einsum("je,jf->ef", k1, k1)
    s2_new, z2_new = state_update(k, v, s2, z2, exact, single)
    return _rel(s2_new, ref_s), _rel(z2_new, ref_z)


@pytest.mark.parametrize("contraction", ["read", "update"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_products_keep_f32_accuracy(dtype, contraction):
    """2 products (bf16 inputs) or 3 (f32) stay within 1e-5 of float64 for
    both the S2 term and the z2 term."""
    errs = _errors(dtype, contraction, single=False)
    assert max(errs) < SPLIT_TOL, errs


@pytest.mark.parametrize("contraction", ["read", "update"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_one_tf32_product_misses_the_kernel_tolerance(dtype, contraction):
    """Why the split exists: one TF32 product per element errs by more than
    the 1e-4 the kernel is held to against its plain version."""
    s2_err, _ = _errors(dtype, contraction, single=True)
    assert s2_err > SINGLE_TOL, s2_err


def test_split_is_exact_and_hi_is_tf32():
    """x = hi + lo exactly; hi has 10 mantissa bits; the part of lo that the
    tensor core reads leaves at most 2^-21 relative of x behind."""
    x = np.random.default_rng(1).standard_normal(10_000).astype(np.float32)
    hi = tf32_round(x)
    lo = (x - hi).astype(np.float32)
    assert np.array_equal(hi.astype(np.float64) + lo.astype(np.float64), x.astype(np.float64))
    assert not np.any(hi.view(np.uint32) & ~MASK)
    hi2, lo2 = split(x)
    assert np.all(np.abs(x.astype(np.float64) - hi2 - lo2) <= 2.0**-21 * np.abs(x))


# ---- the backward pair (csrc/taylor_bwd.cu) ----

BWD_CHUNK = 64
A = 1.0 / (3.0 * D**0.5)  # a = 1/(α√D) at α = 3
HALF_A2 = A * A / 2


def _bwd_inputs(dtype: str):
    """The forward's inputs plus pass 1's rows: dnum = dout/den, dden."""
    q, k, v = _inputs(dtype)
    rng = np.random.default_rng(2)
    dout = rng.standard_normal((G, N, DV)).astype(np.float32)
    if dtype == "bfloat16":
        dout = bf16_round(dout)
    den = rng.uniform(50.0, 150.0, (G, N)).astype(np.float32)
    dnum = (dout / den[..., None]).astype(np.float32)
    dden = (8.0 * rng.standard_normal((G, N)) / den).astype(np.float32)
    return q, k, v, dnum, dden


def _rows(x: np.ndarray, c: int) -> np.ndarray:
    """Chunk c's rows of every head, stacked: [G·C, ...]."""
    return x[:, c * BWD_CHUNK:(c + 1) * BWD_CHUNK].reshape((-1,) + x.shape[2:])


def _carry(q, dnum, dden):
    """dS2 and dz2 after chunk 0's queries of every head, in float64, held
    in f32 as the kernel's slab holds them."""
    q0, d0, w0 = (_rows(x, 0).astype(np.float64) for x in (q, dnum, dden))
    return ((HALF_A2 * np.einsum("ie,if,iv->efv", q0, q0, d0)).astype(np.float32),
            (HALF_A2 * np.einsum("i,ie,if->ef", w0, q0, q0)).astype(np.float32))


def dq_read(q, dnum, s2, exact_q, single=False):
    """dq[i,d] = Σ_v dnum_iv Σ_e S2[d,e,v] q_ie for chunk 1's rows of every
    head, as pass 1: A = S2 rows (d,v) (split), B = the queries, then the f32
    fold over v."""
    qc, dn = _rows(q, 1), _rows(dnum, 1)
    t = tf32_matmul(s2.transpose(0, 2, 1).reshape(D * DV, D), qc.T, True, not exact_q,
                    single=single).reshape(D, DV, -1)  # [d, v, i]
    out = np.zeros((qc.shape[0], D), np.float32)
    for v in range(DV):
        out += dn[:, v, None] * t[:, v].T
    return out


def carry_read(k, v, ds2, exact_k, single=False):
    """One product U[(t,v), j] = Σ_e dS2[t,e,v] k_je for chunk 1's keys (A =
    dS2 rows (t,v), split; B = K) and its two f32 folds, as pass 2:
    dv[j,v] = Σ_t k_jt U[(t,v), j] and dk[j,t] = 2 Σ_v v_jv U[(t,v), j]."""
    kc, vc = k[BWD_CHUNK:2 * BWD_CHUNK], v[BWD_CHUNK:2 * BWD_CHUNK]
    u = tf32_matmul(ds2.transpose(0, 2, 1).reshape(D * DV, D), kc.T, True, not exact_k,
                    single=single).reshape(D, DV, -1)  # [t, v, j]
    dv = np.zeros((BWD_CHUNK, DV), np.float32)
    dk = np.zeros((BWD_CHUNK, D), np.float32)
    for t in range(D):
        dv += kc[:, t, None] * u[t].T
    for x in range(DV):
        dk += 2.0 * vc[:, x, None] * u[:, x].T
    return dv, dk


def carry_update(q, dnum, dden, ds2, dz2, exact_q, single=False):
    """Chunk 1's queries into the carry, head by head, as pass 2:
    dS2[e,f,v] += Σ_i (q_ie·(a²/2)dnum_iv)·Q[i,f] and dz2[e,f] += Σ_i
    ((a²/2)dden_i·q_ie)·Q[i,f], A = those f32 products (split for either
    input type), B = Q; each head's sum over the chunk is taken from zero
    and added to the f32 carry once."""
    for g in range(G):
        rows = slice(g * BWD_CHUNK, (g + 1) * BWD_CHUNK)
        qc, dn, w = _rows(q, 1)[rows], _rows(dnum, 1)[rows], _rows(dden, 1)[rows]
        a = (qc.T[:, None, :] * (HALF_A2 * dn).T[None]).astype(np.float32)  # [e, v, i]
        ds2 = ds2 + tf32_matmul(a, qc, True, not exact_q,
                                single=single).transpose(0, 2, 1)
        az = (qc * (HALF_A2 * w)[:, None]).T.astype(np.float32)  # [e, i]
        dz2 = dz2 + tf32_matmul(az, qc, True, not exact_q, single=single)
    return ds2, dz2


def _bwd_errors(dtype: str, contraction: str, single: bool):
    q, k, v, dnum, dden = _bwd_inputs(dtype)
    exact = dtype == "bfloat16"
    f64 = lambda x: x.astype(np.float64)
    if contraction == "dq_read":
        k0, v0 = f64(k[:BWD_CHUNK]), f64(v[:BWD_CHUNK])
        s2 = np.einsum("je,jf,jv->efv", k0, k0, v0).astype(np.float32)
        ref = np.einsum("iv,dev,ie->id", f64(_rows(dnum, 1)), f64(s2), f64(_rows(q, 1)))
        return (_rel(dq_read(q, dnum, s2, exact, single), ref),)
    ds2, dz2 = _carry(q, dnum, dden)
    if contraction == "carry_read":
        kc, vc = f64(k[BWD_CHUNK:2 * BWD_CHUNK]), f64(v[BWD_CHUNK:2 * BWD_CHUNK])
        dv, dk = carry_read(k, v, ds2, exact, single)
        return (_rel(dv, np.einsum("jt,je,tev->jv", kc, kc, f64(ds2))),
                _rel(dk, 2.0 * np.einsum("jv,je,tev->jt", vc, kc, f64(ds2))))
    qc, dn, w = (f64(_rows(x, 1)) for x in (q, dnum, dden))
    ds2_new, dz2_new = carry_update(q, dnum, dden, ds2, dz2, exact, single)
    return (_rel(ds2_new, f64(ds2) + HALF_A2 * np.einsum("ie,if,iv->efv", qc, qc, dn)),
            _rel(dz2_new, f64(dz2) + HALF_A2 * np.einsum("i,ie,if->ef", w, qc, qc)))


@pytest.mark.parametrize("contraction", ["dq_read", "carry_read", "carry_update"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_split_products_keep_f32_accuracy(dtype, contraction):
    """The backward's products with their folds, 2 products for bf16 inputs
    and 3 for f32, stay within 1e-5 of float64 in every output."""
    errs = _bwd_errors(dtype, contraction, single=False)
    assert max(errs) < SPLIT_TOL, errs


@pytest.mark.parametrize("contraction", ["dq_read", "carry_read", "carry_update"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_one_tf32_product_misses_the_kernel_tolerance(dtype, contraction):
    """One TF32 product per element errs by more than 1e-4 in every output
    of each backward contraction."""
    errs = _bwd_errors(dtype, contraction, single=True)
    assert min(errs) > SINGLE_TOL, errs
