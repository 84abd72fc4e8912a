"""The backward pair's causal tiles at head dim 128 (``csrc/taylor_bwd.cu``:
``score_mma``, ``intra_row_sums``, ``ds_tiles``, ``fold_dq``'s ds·K product
and ``dsT_q``), emulated in numpy.

Where a backward block holds one value column (``kernel.TENSOR_ROWS``: head
dim 128, chunk 64), both passes compute the causal C×C score tile of every
(chunk, head) on the tensor cores: S = Q·Kᵀ as 8-deep TF32 ``mma.sync``
products (bf16 q and k are exact in TF32 and take one product, f32 ones are
split and take three) over the 16×8 tiles on or below the diagonal only.
Warp w takes the row strip w % 4 and every other key n-tile from w // 4.
Pass 1 sums p = poly(a·s) over each row's columns (j > i masked: a lane's
two columns, then the row's four lanes by a butterfly, then the two halves
in a fixed order), turns the accumulators into ds = (dnum_i·v_j + dden_i on
the lead block)·poly'(a·s)·a, stores ds, and runs ds·K as Kᵀ·dsᵀ (A = Kᵀ,
split for f32; B = dsᵀ, split) over the k-steps j ≤ each query n-tile's last
row.  Pass 2 takes dv's Σ_{i ≥ j} p_ij·dnum_i as column sums (a lane's two
rows, the column's eight lanes by a butterfly, one shared atomic a row
strip), stores ds and runs dsᵀ·Q (A = dsᵀ, split; B = Q, split for f32)
over the k-steps i ≥ each key strip's first row.

These tests hold S, the row and column sums, ds and both products to float64
at 1e-5 relative, in both dtypes and orders; a mask one column off, poly'
without s, or ds taken in one TF32 product fails.  They also check that the
warps cover the causal triangle, that the products' fragment loads are free
of bank conflicts at the source's row strides, and that the source's
tensor-row head dims hold ``kernel.TENSOR_ROWS``.  The CUDA kernels
themselves run only on the card (``chip_smoke.py`` phases 3b and 12 (b)).
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.taylor_attention import kernel as K
from test_torch_kernels_split import bf16_round, tf32_matmul

D, C = 128, K.BWD_CHUNK
G, N, DV = 2, 2 * C, 2  # two chunks; two value columns, one block each (the lead first)
ALPHA = 3.0
A = np.float32(1.0 / (ALPHA * D**0.5))
TOL = 1e-5
F32 = np.float32
SRC = (K.CSRC / "taylor_bwd.cu").read_text()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Torch ops on one thread in this module (the suite runs several
    workers side by side)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(dtype: str):
    """q [G, N, D], k [N, D] (normalised), v [N, DV], and pass 1's rows:
    dnum = dout / den [G, N, DV], dden [G, N]."""
    rng = np.random.default_rng(34)

    def ln(x):
        x = x - x.mean(-1, keepdims=True)
        return (x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-6)).astype(F32)

    q = ln(rng.standard_normal((G, N, D)))
    k = ln(rng.standard_normal((N, D)))
    v = rng.standard_normal((N, DV)).astype(F32)
    dout = rng.standard_normal((G, N, DV)).astype(F32)
    if dtype == "bfloat16":
        q, k, v, dout = (bf16_round(x) for x in (q, k, v, dout))
    den = rng.uniform(50.0, 150.0, (G, N)).astype(F32)
    dnum = (dout / den[..., None]).astype(F32)
    dden = (8.0 * rng.standard_normal((G, N)) / den).astype(F32)
    return q, k, v, dnum, dden


def poly(s, order):
    return F32(1) + s + (F32(0.5) * s * s if order >= 2 else F32(0))


def dpoly(s, order, with_s=True):
    return F32(1) + s if order >= 2 and with_s else np.ones_like(s)


def score_tiles(q, k, exact):
    """score_mma's accumulators of one chunk and head: {(m, part, u): S/a
    [16, 8]} for the row strip m, the key n-tile part + 2u, u ≤ m."""
    tiles = {}
    for m in range(C // 16):
        rows = slice(16 * m, 16 * m + 16)
        for part in (0, 1):
            for u in range(m + 1):
                cols = slice((part + 2 * u) * 8, (part + 2 * u) * 8 + 8)
                tiles[m, part, u] = tf32_matmul(q[rows], k[cols].T, not exact, not exact)
    return tiles


def tile_index(m, part, u):
    """(rows i [16, 1], columns j [1, 8]) of a score tile."""
    j0 = (part + 2 * u) * 8
    return np.arange(16 * m, 16 * m + 16)[:, None], np.arange(j0, j0 + 8)[None]


def row_sums(tiles, order, mask_shift=0):
    """intra_row_sums' Σ_{j ≤ i} p_ij of each row [C], as the row threads add
    the two halves (td[0][i] + td[1][i])."""
    halves = np.zeros((2, C), F32)
    for m in range(C // 16):
        for part in (0, 1):
            lanes = np.zeros((16, 4), F32)  # [row, lane t]: columns 2t, 2t + 1
            for u in range(m + 1):
                i, j = tile_index(m, part, u)
                p = np.where(j <= i + mask_shift, poly(A * tiles[m, part, u], order), F32(0))
                p = p.reshape(16, 4, 2)
                for x in (0, 1):
                    lanes += p[:, :, x]
            halves[part, 16 * m:16 * m + 16] = (lanes[:, 0] + lanes[:, 1]) + (
                lanes[:, 2] + lanes[:, 3])
    return halves[0] + halves[1]


def ds_and_col_sums(tiles, v, dn, dd, order, mask_shift=0, with_s=True):
    """ds_tiles: buf [C, C] (ds where a tile covers it and j ≤ i, else 0)
    and pass 2's column sums Σ_{i ≥ j} p_ij·dnum_i [C]: a lane's rows g and
    g + 8, the column's eight lanes by the butterfly xor 4, 8, 16, then one
    atomic a strip (in strip order here).  v, dn, dd [C]: the block's value
    column, dnum and dden (0 off the lead block).  Foils: ``mask_shift``
    moves the mask, ``with_s`` False drops s from poly'."""
    buf = np.zeros((C, C), F32)
    cols = np.zeros(C, F32)
    for m in range(C // 16):
        for part in (0, 1):
            for u in range(m + 1):
                i, j = tile_index(m, part, u)
                s = A * tiles[m, part, u]
                causal = j <= i + mask_shift
                buf[i, j] = np.where(causal, (dn[i] * v[j] + dd[i]) * dpoly(s, order, with_s)
                                     * A, F32(0))
                lane = np.where(causal, poly(s, order) * dn[i], F32(0))
                g = lane[:8] + lane[8:]                    # [g, column]: rows g, g + 8
                g = g[0::2] + g[1::2]                      # xor 4
                g = g[0::2] + g[1::2]                      # xor 8
                cols[j[0]] += g[0] + g[1]                  # xor 16, then the atomic
    return buf, cols


def ds_k(buf, k, exact, single=False):
    """fold_dq's ds·K term [C, D]: (Kᵀ·dsᵀ)[d, i] over the query n-tiles of
    8 rows, k-steps j0 ≤ the n-tile's first row (A = Kᵀ, split for f32; B =
    dsᵀ, split; ``single``: one TF32 product, the foil)."""
    out = np.zeros((C, D), F32)
    for i0 in range(0, C, 8):
        depth = i0 + 8
        ck = tf32_matmul(k[:depth].T, buf[i0:i0 + 8, :depth].T, not exact, True, single=single)
        out[i0:i0 + 8] = ck.T
    return out


def dst_q(buf, q, exact, single=False):
    """dsT_q's dk term [C, D]: dsᵀ·Q over the key strips of 16 rows, k-steps
    i0 ≥ the strip's first row (A = dsᵀ, split; B = Q, split for f32)."""
    out = np.zeros((C, D), F32)
    for s in range(C // 16):
        j0 = 16 * s
        out[j0:j0 + 16] = tf32_matmul(buf[j0:, j0:j0 + 16].T, q[j0:], True, not exact,
                                      single=single)
    return out


def tiles_ref(q, k, v, dn, dd, order):
    """S/a, the row sums, the column sums, ds, ds·K and dsᵀ·Q in float64."""
    q64, k64 = q.astype(np.float64), k.astype(np.float64)
    a = 1.0 / (ALPHA * D**0.5)
    s0 = q64 @ k64.T
    s = a * s0
    mask = np.tril(np.ones((C, C), bool))
    p = np.where(mask, 1 + s + (0.5 * s * s if order >= 2 else 0), 0.0)
    dp = dn[:, None].astype(np.float64) * v[None].astype(np.float64) + dd[:, None]
    ds = np.where(mask, dp * ((1 + s) if order >= 2 else 1.0) * a, 0.0)
    return dict(s=np.where(mask, s0, 0.0), rows=p.sum(1), cols=p.T @ dn.astype(np.float64),
                ds=ds, ds_k=ds @ k64, dst_q=ds.T @ q64)


def _rel(out, ref) -> float:
    return float(np.abs(out - ref).max() / np.abs(ref).max())


def tile_errors(dtype, order, mask_shift=0, with_s=True, single=False):
    """The worst relative error of each emulated quantity against float64,
    over both chunks, both heads and both value columns (the lead first)."""
    q, k, v, dnum, dden = _inputs(dtype)
    exact = dtype == "bfloat16"
    worst = dict.fromkeys(("s", "rows", "cols", "ds", "ds_k", "dst_q"), 0.0)
    for c in range(N // C):
        r = slice(c * C, (c + 1) * C)
        for g in range(G):
            tiles = score_tiles(q[g, r], k[r], exact)
            s = np.zeros((C, C), F32)
            for (m, part, u), acc in tiles.items():
                i, j = tile_index(m, part, u)
                s[i, j] = np.where(j <= i, acc, F32(0))
            rows = row_sums(tiles, order, mask_shift)
            for col in range(DV):
                dn = dnum[g, r, col]
                dd = dden[g, r] if col == 0 else np.zeros(C, F32)
                buf, cols = ds_and_col_sums(tiles, v[r, col], dn, dd, order, mask_shift,
                                            with_s)
                got = dict(s=s, rows=rows, cols=cols, ds=buf,
                           ds_k=ds_k(buf, k[r], exact, single),
                           dst_q=dst_q(buf, q[g, r], exact, single))
                ref = tiles_ref(q[g, r], k[r], v[r, col], dn, dd, order)
                for name in worst:
                    worst[name] = max(worst[name], _rel(got[name], ref[name]))
    return worst


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_tiles_match_float64(dtype, order):
    errs = tile_errors(dtype, order)
    assert max(errs.values()) < TOL, errs


# Each foil and the quantities it must throw past 10·TOL.
FOILS = {
    "mask j >= i": (dict(mask_shift=-1), ("rows", "cols", "ds", "ds_k", "dst_q")),
    "mask j > i + 1": (dict(mask_shift=1), ("rows", "cols", "ds", "ds_k", "dst_q")),
    "poly' without s": (dict(with_s=False), ("ds", "ds_k", "dst_q")),
    "ds in one TF32 product": (dict(single=True), ("ds_k", "dst_q")),
}


@pytest.mark.parametrize("foil", list(FOILS))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_faulty_tile_fails_the_check(dtype, foil):
    kw, hit = FOILS[foil]
    errs = tile_errors(dtype, 2, **kw)
    assert min(errs[name] for name in hit) > 10 * TOL, errs


def _score_cover():
    """{(i, j)} that score_mma's warps write: strip m = w % 4, n-tiles
    w // 4 + 2u for u ≤ m."""
    out = set()
    for w in range(8):
        m, part = w % 4, w // 4
        for u in range(m + 1):
            i, j = tile_index(m, part, u)
            out |= {(a, b) for a in i[:, 0] for b in j[0]}
    return out


def test_the_warps_cover_the_causal_triangle():
    causal = {(i, j) for i in range(C) for j in range(i + 1)}
    written = _score_cover()
    assert causal <= written and all(j - i < 16 for i, j in written)
    # fold_dq: warp w's query n-tiles 8(w % 2) + 16nt, k-steps j0 ≤ the n-tile's first row
    fold, steps = set(), []
    for w in range(8):
        rg, n = w % 2, 0
        for nt in range(4):
            i0 = 8 * rg + 16 * nt
            for j0 in range(0, i0 + 1, 8):
                fold |= {(i, j) for i in range(i0, i0 + 8) for j in range(j0, j0 + 8)}
                n += 1
        steps.append(n)
    assert causal <= fold <= written and sorted(set(steps)) == [16, 20]
    # dsT_q: warp w's key strips w % 2 and 3 - w % 2, k-steps i0 ≥ the strip's first row
    dst, steps = set(), []
    for w in range(8):
        rg, n = w % 2, 0
        for strip in (rg, 3 - rg):
            for i0 in range(16 * strip, C, 8):
                j0 = 16 * strip
                dst |= {(i, j) for i in range(i0, i0 + 8) for j in range(j0, j0 + 16)}
                n += 1
        steps.append(n)
    assert causal <= dst <= written and set(steps) == {10}


def _strides():
    """The backward's row strides at head dim 128, read from Dims<D>."""
    m1 = re.search(r"static constexpr int QS1 = D \+ (\d+), KS1 = D \+ (\d+);", SRC)
    m2 = re.search(r"static constexpr int QS2 = D \+ (\d+), KS2 = D \+ (\d+);", SRC)
    b1 = re.search(r"static constexpr int BS1 = tensor_rows \? C \+ (\d+) : BS;", SRC)
    b2 = re.search(r"static constexpr int BS2 = tensor_rows \? C \+ (\d+) : BS;", SRC)
    qs1, ks1 = (D + int(x) for x in m1.groups())
    qs2, ks2 = (D + int(x) for x in m2.groups())
    return dict(QS1=qs1, KS1=ks1, QS2=qs2, KS2=ks2, BS1=C + int(b1.group(1)),
                BS2=C + int(b2.group(1)))


def _ways(offset) -> int:
    """The most lanes of a warp whose 4-byte loads at offset(g, t) (floats)
    fall in one bank at distinct addresses."""
    banks = {}
    for g in range(8):
        for t in range(4):
            x = offset(g, t)
            banks.setdefault(x % 32, set()).add(x)
    return max(len(a) for a in banks.values())


def test_fragment_loads_are_free_of_bank_conflicts():
    """Lane (g, t) of a fragment register reads row base + t (or g) at column
    base + g (or t), plus the register's offset; the bases and the offset
    move every lane alike, so the lane pattern and the stride decide."""
    st = _strides()
    down = lambda stride: lambda g, t: t * stride + g    # a fragment walking down rows
    across = lambda stride: lambda g, t: g * stride + t  # a fragment walking across rows
    free = {"ds·K A (Kᵀ)": down(st["KS1"]), "ds·K B (dsᵀ)": across(st["BS1"]),
            "S2 read B (Q)": across(st["QS1"]), "dsᵀ·Q A (dsᵀ)": down(st["BS2"]),
            "dsᵀ·Q B (Q)": down(st["QS2"])}
    for name, f in free.items():
        assert _ways(f) == 1, name
    # score_mma walks across both operands: the D + 8 one (K in pass 1, Q in pass 2) two-way
    assert [_ways(across(st[k])) for k in ("QS1", "KS2", "KS1", "QS2")] == [1, 1, 2, 2]


def test_tensor_row_dims_mirror_the_source():
    tiles = {int(d): int(dvt) for d, dvt in re.findall(
        r"template <> struct VTile<(\d+)> \{ static constexpr int DVT = (\d+); \};", SRC)}
    assert tiles == {d: dvt for d, (dvt, _) in K.TILES.items()}
    assert "static constexpr bool tensor_rows = DVT == 1;" in SRC
    assert K.TENSOR_ROWS == {d for d, dvt in tiles.items() if dvt == 1} == {128}
    assert re.search(r"constexpr int kChunk = (\d+);", SRC).group(1) == str(C)


def test_a_cpu_call_counts_no_launch():
    q = torch.randn(1, G, C, D)
    k = torch.randn(1, C, D)
    v, dout = torch.randn(1, C, DV), torch.randn(1, G, C, DV)
    out = K.taylor_fwd(q, k, v, alpha=ALPHA)
    counts = lambda: (K.taylor_bwd.dq_launches, K.taylor_bwd.dkv_launches,
                      K.taylor_bwd.dq_tensor_row_launches, K.taylor_bwd.dkv_tensor_row_launches)
    before = counts()
    dq, dk, dv = K.taylor_bwd(q, k, v, dout, out, alpha=ALPHA)
    assert dq.shape == q.shape and dk.shape == k.shape and dv.shape == v.shape
    assert counts() == before
