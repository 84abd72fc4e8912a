"""The forward kernel's row pass at head dim 128 (``csrc/taylor_fwd.cu``:
``intra_tile`` and ``finish_rows``), emulated in numpy.

Where a forward block holds one value column (``kernel.TENSOR_ROWS``: head
dim 128, chunk 64), the causal C×C tile of every (chunk, head) runs on the
tensor cores: S = Q·Kᵀ as 8-deep TF32 ``mma.sync`` products (bf16 q and k
are exact in TF32 and take one product, f32 ones are split and take three),
over the 16×8 tiles on or below the diagonal only; p = 1 + s (+ s²/2) on the
f32 accumulators, j > i masked on the diagonal tiles, and the row sums
Σ_j p_ij·v_j and Σ_j p_ij.  Warp w takes the row strip w % 4 and every other
key n-tile from w // 4; a lane sums its two columns over its tiles, the four
lanes of a row are added by a butterfly, and the two halves of a row are
added in a fixed order.  Four threads a row then add the first moments,
split over the head dim, and the state read's terms.

These tests hold the tile's sums to float64 at 1e-5 relative, and the whole
output to ``ref.py``'s plain version, in both dtypes and orders; a mask one
column off or a dropped s²/2 fails.  ``Tiles<D>`` in the source holds
``kernel.TILES`` and ``kernel.TENSOR_ROWS``.  The CUDA kernel itself runs
only on the card (``chip_smoke.py`` phases 3 and 12 (b)).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.taylor_attention import kernel as K
from repro_torch.kernels.taylor_attention.ref import taylor_attention_ref
from test_torch_kernels_split import bf16_round, tf32_matmul

D, C = 128, K.TILES[128][1]
G, N, DV = 2, 2 * C, 4  # two chunks; DV value columns, one block each
ALPHA = 3.0
TOL = 1e-5       # the tile's sums against float64
OUT_TOL = 2e-5   # the output against the plain version (tests/test_torch_kernels.py)
F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module (the suite runs several
    workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dtype: str):
    rng = np.random.default_rng(32)

    def ln(x):
        x = x - x.mean(-1, keepdims=True)
        return (x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)).astype(F32)

    q = ln(rng.standard_normal((G, N, D)))
    k = ln(rng.standard_normal((N, D)))
    v = rng.standard_normal((N, DV)).astype(F32)
    if dtype == "bfloat16":
        q, k, v = bf16_round(q), bf16_round(k), bf16_round(v)
    return q, k, v


def tile_sums(q, k, v, order, exact, mask_shift=0, square=True):
    """(num [C, DV], den [C]) of one chunk and head, as ``intra_tile`` and
    ``finish_rows`` add them, in f32.  ``q``, ``k`` [C, D], ``v`` [C, DV];
    ``exact``: q and k are exact in TF32 (bf16 inputs, one product).  Foils:
    ``mask_shift`` moves the diagonal mask by that many columns, ``square``
    False drops s²/2."""
    a = F32(1.0 / (ALPHA * D**0.5))
    halves_num = np.zeros((2, C, DV), F32)
    halves_den = np.zeros((2, C), F32)
    covered = np.zeros((C, C), bool)
    for m in range(C // 16):                      # warp w % 4: the row strip
        rows = np.arange(16 * m, 16 * m + 16)
        for part in (0, 1):                       # warp w // 4: every other n-tile
            lane_num = np.zeros((16, 4, DV), F32)  # [row, lane t, value column]
            lane_den = np.zeros((16, 4), F32)
            for u in range(m + 1):
                j0 = (part + 2 * u) * 8
                cols = np.arange(j0, j0 + 8)
                covered[np.ix_(rows, cols)] = True
                acc = tf32_matmul(q[rows], k[cols].T, not exact, not exact)
                s = a * acc
                p = F32(1) + s
                if order >= 2 and square:
                    p = p + F32(0.5) * s * s
                future = cols[None] > rows[:, None] + mask_shift
                if u == m:                        # the warp's diagonal tile
                    p = np.where(future, F32(0), p)
                else:
                    assert not (cols[None] > rows[:, None]).any()
                pl = p.reshape(16, 4, 2)          # lane t holds columns 2t, 2t + 1
                vl = v[cols].reshape(4, 2, DV)
                for x in (0, 1):
                    lane_num += pl[:, :, x, None] * vl[None, :, x]
                    lane_den += pl[:, :, x]
            # the butterfly over t (xor 1, then xor 2)
            halves_num[part, rows] = (lane_num[:, 0] + lane_num[:, 1]) + (
                lane_num[:, 2] + lane_num[:, 3])
            halves_den[part, rows] = (lane_den[:, 0] + lane_den[:, 1]) + (
                lane_den[:, 2] + lane_den[:, 3])
    # the n-tiles on or below the diagonal of each strip, and no others
    strip_last = 2 * (np.arange(C) // 16) + 1
    assert (covered[:, ::8] == (np.arange(C // 8)[None] <= strip_last[:, None])).all()
    return halves_num[0] + halves_num[1], halves_den[0] + halves_den[1]


def tile_ref(q, k, v, order):
    """The same sums in float64."""
    q64, k64, v64 = (x.astype(np.float64) for x in (q, k, v))
    s = q64 @ k64.T / (ALPHA * D**0.5)
    p = 1 + s + (0.5 * s * s if order >= 2 else 0)
    p = np.tril(p)
    return p @ v64, p.sum(-1)


def _rel(out, ref) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def _tile_errors(dtype, order, **foil):
    q, k, v = _inputs(dtype)
    worst = [0.0, 0.0]
    for c in range(N // C):
        r = slice(c * C, (c + 1) * C)
        for g in range(G):
            num, den = tile_sums(q[g, r], k[r], v[r], order, dtype == "bfloat16", **foil)
            ref_n, ref_d = tile_ref(q[g, r], k[r], v[r], order)
            worst = [max(worst[0], _rel(num, ref_n)), max(worst[1], _rel(den, ref_d))]
    return worst


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tile_sums_match_float64(dtype, order):
    num_err, den_err = _tile_errors(dtype, order)
    assert num_err < TOL and den_err < TOL, (num_err, den_err)


@pytest.mark.parametrize("foil", [dict(mask_shift=-1), dict(mask_shift=1), dict(square=False)],
                         ids=["mask j >= i", "mask j > i + 1", "no s^2/2"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_faulty_tile_fails_the_check(dtype, foil):
    num_err, den_err = _tile_errors(dtype, 2, **foil)
    assert num_err > 10 * TOL and den_err > 10 * TOL, (num_err, den_err)


def forward(q, k, v, order, exact):
    """The kernel's output in f32: the tile's sums, the constant and first
    moments (four lanes a row over e = 4u + 16x, then the butterfly) and the
    state read (float64 here; tests/test_torch_kernels_split.py holds the
    kernel's to it), added in ``finish_rows``' order."""
    a = F32(1.0 / (ALPHA * D**0.5))
    out = np.zeros((G, N, DV), F32)
    for c in range(N // C):
        r = slice(c * C, (c + 1) * C)
        k0, v0 = k[: c * C].astype(np.float64), v[: c * C].astype(np.float64)
        z1, s1, s0 = (x.astype(F32) for x in (k0.sum(0), k0.T @ v0, v0.sum(0)))
        s2 = np.einsum("je,jf,jv->efv", k0, k0, v0)
        z2 = k0.T @ k0
        for g in range(G):
            qc = q[g, r]
            num, den = tile_sums(qc, k[r], v[r], order, exact)
            idx = (4 * np.arange(4)[:, None] + 16 * np.arange(D // 16)[None])  # [u, x]
            quads = qc[:, idx[..., None] + np.arange(4)]  # [i, u, x, 4]
            zl = (quads * z1[idx[..., None] + np.arange(4)]).sum(-1, dtype=F32).sum(
                -1, dtype=F32)
            lin = np.einsum("iuxw,uxwv->iuv", quads, s1[idx[..., None] + np.arange(4)]
                            ).astype(F32)
            zl = (zl[:, 0] + zl[:, 1]) + (zl[:, 2] + zl[:, 3])
            lin = (lin[:, 0] + lin[:, 1]) + (lin[:, 2] + lin[:, 3])
            den = den + F32(c * C) + a * zl
            num = num + s0 + a * lin
            if order >= 2:
                q64 = qc.astype(np.float64)
                rd = np.einsum("ie,if,ef->i", q64, q64, z2).astype(F32)
                rn = np.einsum("ie,if,efv->iv", q64, q64, s2).astype(F32)
                half_a2 = F32(0.5) * a * a
                den = den + half_a2 * rd
                num = num + half_a2 * rn
            den = np.where(np.abs(den) < 1e-6, F32(1e-6), den)
            out[g, r] = num * (F32(1) / den)[:, None]
    return out


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_output_matches_the_plain_version(dtype, order):
    q, k, v = _inputs(dtype)
    out = forward(q, k, v, order, dtype == "bfloat16")
    ref = taylor_attention_ref(torch.from_numpy(q)[None, None], torch.from_numpy(k)[None, None],
                               torch.from_numpy(v)[None, None], alpha=ALPHA, order=order)
    assert _rel(out, ref[0, 0].numpy()) < OUT_TOL


def test_tensor_row_dims_mirror_the_source():
    src = (K.CSRC / "taylor_fwd.cu").read_text()
    tiles = {int(d): (int(dvt), int(c)) for d, dvt, c in re.findall(
        r"struct Tiles<(\d+)> \{ static constexpr int DVT = (\d+), C = (\d+); \};", src)}
    assert tiles == K.TILES
    assert "static constexpr bool tensor_rows = DVT == 1;" in src
    assert K.TENSOR_ROWS == {d for d, (dvt, _) in tiles.items() if dvt == 1} == {128}


def test_a_cpu_call_counts_no_launch():
    q = torch.randn(1, G, C, D)
    k = torch.randn(1, C, D)
    before = (K.taylor_fwd.launches, K.taylor_fwd.tensor_row_launches)
    out = K.taylor_fwd(q, k, k[..., :DV], alpha=ALPHA)
    assert out.shape == (1, G, C, DV)
    assert (K.taylor_fwd.launches, K.taylor_fwd.tensor_row_launches) == before
