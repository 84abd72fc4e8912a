// Causal order-1/2 Taylor linear attention, backward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel pair in src/repro/kernels/taylor_attention/kernel_bwd.py
// (launched by taylor_bwd_pallas):
//
//   * taylor_bwd_dq_kernel   <- _taylor_bwd_dq_kernel  (pass 1, forward direction)
//   * taylor_bwd_dkv_kernel  <- _taylor_bwd_dkv_kernel (pass 2, reverse direction)
//
// Inputs are the forward's kernel layout: grouped, pre-normalised q [BK, G, N, D],
// keys k [BK, N, D], values v [BK, N, DV], the output cotangent dout [BK, G, N, DV]
// and the SAVED forward output out [BK, G, N, DV].  With s = a·q·kᵀ, a = 1/(α√D),
// den clamped as where(|den| < 1e-6, 1e-6, den) (the forward kernel's clamp),
// dnum = dout/den and dden = -Σ_v dout·out/den (from the saved out, so the numerator
// is never recomputed):
//
//   pass 1 (chunks in order, rebuilding S1, z1, z2, S2 of the earlier chunks):
//     dq = ds·K + a·dnum·S1ᵀ + a·dden·z1 + a²·Σ_{e,v} q_e·S2[·,e,v]·dnum_v + a²·dden·(z2 q)
//     with ds = causal(dp·(1 + s))·a, dp = dnum·Vᵀ + dden (order 1: dp·a);
//     it also writes the clamped den and dden rows for pass 2.
//   pass 2 (chunks in reverse, carrying the gradients dS0, dS1, dz1, dz2, dS2 of the
//     state that later chunks read):
//     dv = dS0 + K·dS1 + (K⊗K)·dS2 + Pᵀ·dnum
//     dk = dz1 + V·dS1ᵀ + 2K·dz2 + 2Σ_{e,v} k_e·dS2[·,e,v]·v_v + dsᵀ·Q
//     and only then adds this chunk's queries to the carry (the forward read the state
//     before absorbing the chunk): dS0 += Σdnum, dS1 += a·Qᵀdnum, dz1 += a·Σ dden·q,
//     dz2 += (a²/2)(dden·Q)ᵀQ, dS2 += (a²/2)(Q⊗Q)ᵀdnum.
//
// What bounds it on this card: arithmetic.  Per (batch·kv-head) pass 1 does about
// (G+1)·N·2D²·DV operations of second-moment work (G state reads for dq, one state
// update) and pass 2 about (G+1)·N·2D²·DV (one carry read, G carry updates), against
// O(N·G·(D+DV)) bytes.  Those D²·DV contractions, and the D² ones on z2/dz2, run on the
// tensor cores as split-precision TF32 mma.sync products (tf32_mma.cuh), in the scheme
// of taylor_fwd.cu, and so do the causal C×C intra-chunk tiles where D = 128 (below); the
// rest stays as f32 FMAs on the CUDA cores: the den/dden row pass, the first moments, the
// folds below, and where D ≤ 64 the intra-chunk tiles (scores, dp, ds·K, Pᵀ·dnum, dsᵀ·Q).
//
// The contractions.  In each, the f32 operand (the state, the carry, or a product made
// in registers) is the A operand (16 rows), split once per k-step into hi and lo and
// reused across all of the warp's n-tiles; the other operand, q or k, is B, exact in
// TF32 for bf16 inputs and split too for f32 inputs.  Products issued per element:
// bf16 inputs 2 (a_lo·b_hi + a_hi·b_hi), except pass 1's z2 update (A = k_e, exact: 1);
// f32 inputs 3 (+ a_hi·b_lo).  The folds, sums of 1/D or 1/DVT the size of a product that
// turn it into a gradient, run on the CUDA cores in f32.
//   pass 1, per head (warp w: rows (w % 2)·C/2 …, quarter w / 2 of the A tiles):
//   * z2 read, u[e][i] = Σ_f z2[f,e]·q_if (A = 16 values of e, read as z2[f][e]: z2 is
//     symmetric, and the transposed read puts a fragment row in 8 banks; B = Q).  One
//     product serves two terms: the denominator's q·z2·q = Σ_e q_ie·u[e][i] (folded,
//     summed over the 8 lanes g by shuffles, per warp quarter into rd), and on the lead
//     tile dq's a²·dden·(z2 q)_d, taken directly (kept in rq until dden is known).
//   * S2 read for dq, T[(d,v), i] = Σ_e S2[d,e,v]·q_ie (A = the slab's rows (d,v), two
//     values of d × 8 of v; B = Q), the forward's state read; its fold dq[i,d] +=
//     a²·Σ_v dnum_iv·T[(d,v), i] sums over v, the lane's g, so the 8 lanes are added by
//     shuffles (four exchanges for four sums, sum_over_g) into rq, which the dq rows add.
//   * state update, after every head (causality): S2[e,f,v] += Σ_j (k_je·v_jv)·K[j,f]
//     (A = k_e·v made in registers) and z2 += KᵀK (A = k_e), the forward's update.
//   pass 2, per chunk:
//   * carry read, U[(t,v), j] = Σ_e dS2[t,e,v]·k_je (A = the dS2 slab's rows (t,v);
//     B = K), one product for two folds: dv[j,v] += Σ_t k_jt·U[(t,v), j] (the lane's v:
//     registers, then shared atomics into dv) and dk[j,t] += 2·Σ_v v_jv·U[(t,v), j]
//     (over v: shuffles, into rk).  The lead tile's 2·(dz2 k)_t is the e-row product
//     on dz2, written to rk first.
//   * carry update, per head: dS2[e,f,v] += (a²/2)·Σ_i (q_ie·dnum_iv)·Q[i,f] (A = q_e·dnum,
//     f32) and on the lead tile dz2[e,f] += (a²/2)·Σ_i (dden_i·q_ie)·Q[i,f] (A = dden·q_e,
//     f32: split for either input type).
//   Where DVT = 1 (D = 128) the A tiles of the reads are 16 values of d (or t) read as
//   S2[e][d] (symmetric), the v-folds need no shuffles, and rq/rk, which do not fit
//   beside the slab there, give way to atomics straight into dq and dk; the lead tile
//   takes its z2 (dz2) product beside the S2 (dS2) one.  rd, rq and rk are [C]-row
//   buffers in shared memory; dS2 and dz2 are symmetric (built from (Q⊗Q)ᵀ) up to the
//   rounding of the split products, as S2 and z2 are.
//
// The intra-chunk tiles where D = 128 (Dims<D>::tensor_rows, DVT = 1).  With one value
// column a block, a thread a row of the C×C tile would walk 64 128-wide dot products, and
// the CUDA-core tile took about 40% of pass 1 and half of pass 2 at G = 48 (PERF.md).
// There both passes compute S = Q·Kᵀ on the tensor cores with all 8 warps over the 16×8
// tiles on or below the diagonal only (score_mma, as taylor_fwd.cu's intra_tile: A = Q,
// B = K, bf16 one product, f32 split), and work on the f32 accumulators:
//   * pass 1 takes the den pass's Σ_j p_ij from them (two halves, added by the row threads
//     in a fixed order), keeps them in registers until dnum and dden are known, turns them
//     into ds and stores ds to buf; then fold_dq runs ds·K as (Kᵀ·dsᵀ)[d, i] (A = Kᵀ, split
//     for f32; B = dsᵀ, split: 2 products for bf16, 3 for f32) in the S2 read's accumulator
//     layout, with the S2 and z2 reads and the first-moment terms, so that dq gets one
//     atomic an element from a block instead of two;
//   * pass 2 takes dv's Σ_{i ≥ j} p_ij·dnum_i from them as column sums, stores ds to buf,
//     and dsT_q runs dsᵀ·Q (A = dsᵀ, split; B = Q) from zero for each head and adds it to
//     dk's chunk accumulators, which hold the carry's first-moment terms from the start and
//     are added to dk once a chunk.
//   Every product keeps the split scheme's f32 accuracy; buf's row stride is C + 4 in pass
//   1 and C + 8 in pass 2, so that the ds fragments load without bank conflicts.  Where
//   D ≤ 64 (8 to 32 value columns a block) the tiles stay on the CUDA cores, as they were.
//
// What the design does about the TPU design's assumptions:
//   * Sequential chunk axis.  The TPU grid carries S2 (pass 1) and dS2 (pass 2) across an
//     "arbitrary" grid axis in VMEM, and pass 2 flips the chunk index in its index maps.
//     Here each block owns one (batch·kv-head, value tile of DVT columns) and runs the
//     chunk loop itself: forward in pass 1, from the last chunk to the first in pass 2.
//   * The moment state does not fit.  S2 and dS2 are D²·DV·4 bytes (1 MiB per head at
//     D = DV = 64); the TPU kernels hold them whole (no value tiling).  As in the forward
//     kernel, the value dimension is split across blocks so each block's S2/dS2 slab
//     (D²·DVT·4 = 128 KiB at D = 64, DVT = 8) stays in shared memory for the sequence.
//     S1/dS1, S0/dS0 and dv are per value column and split cleanly.
//   * Terms that sum over the value axis.  dq's intra term (through dp), its S1 and S2
//     terms, dk's intra term and its dS1 and dS2 terms are sums over v, so each value
//     tile produces a partial.  The partials of dq and dk are added with f32 atomicAdd
//     into buffers the wrapper zeroes: no [n_tiles, ...] partial buffer (8x dq's size at
//     D = 64) and no third launch to reduce it.  The cost is that the order of the adds
//     varies, so dq and dk repeat to f32 rounding, not bit for bit.  dv needs no atomics.
//   * Value-independent terms are added once, by value tile 0 ("lead"): dden's part of
//     dp, a·dden·z1 and a²·dden·(z2 q) in dq; dz1 and 2K·dz2 in dk.  Only the lead tile
//     keeps the dz1/dz2 carry, and only it writes pass 1's den and dden rows.
//   * dden needs the whole value row of dout·out: each pass-1 block reads the full row
//     of its chunk (G·C·DV values of each) rather than relying on a pre-pass.  Every
//     tile recomputes den (the forward kernel does the same per value tile).
//   * The backward uses its own chunk, C = 64: the C×C score/ds tile (16 KiB) has to fit
//     beside the state slab.  Any chunk gives the same function; the forward's chunks
//     (128 or 64) are multiples of it, so the wrapper's padding serves both.
//   * Padding: the wrapper pads the sequence only at its end with zero k/v/dout rows and
//     pads D and DV with zero columns.  Every gradient of a padded row or column is then
//     a sum of products with a zero factor, so it comes out exactly zero.
//
// Shared memory (one block per SM): 228,384 of 232,448 bytes at D = 64, 222,992 at
// D = 128.  The rows that a fragment walks across (B of a read: Q in pass 1, K in pass 2)
// sit at a row stride of D + 4 floats, the rows it walks down (B of an update: K in pass
// 1, Q in pass 2) at D + 8, so that every B load is free of bank conflicts; the score
// tile's threads walk the D + 4 operand.  At D = 128 ds·K's Kᵀ and dsᵀ·Q's Q walk down
// the D + 8 rows without conflicts; score_mma walks across both operands, and loads the
// D + 8 one (K in pass 1, Q in pass 2) with two-way conflicts, as the forward's tile does
// its keys.
//
// Left for later: the intra-chunk tiles on the tensor cores at D ≤ 64; at D = 128 the 128
// value-column blocks that each redo the score tile, the full dout·out rows and the query
// loads; 96 blocks on 132 SMs at the main path's shape, tile 0's value-independent tail,
// wgmma with TMA loads for bf16.
//
// Interface: plain C functions, loaded with ctypes.  They launch on the caller's stream,
// allocate nothing (the caller owns all inputs, outputs and the den/dden scratch) and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;                  // the backward's sequence chunk
constexpr int kGroups = kThreads / kChunk;  // threads per row in row-parallel phases
// The tensor-core reads: warp w takes the chunk's rows (w % kRowGroups)·C/kRowGroups …
// and part w / kRowGroups of the A tiles.
constexpr int kRowGroups = 2;
constexpr int kParts = kWarps / kRowGroups;
constexpr float kDenEps = 1e-6f;            // the forward kernel's clamp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

template <int W>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int x = 0; x < W; x += 4) {
      const float4 t = *reinterpret_cast<const float4*>(src + x);
      dst[x] = t.x; dst[x + 1] = t.y; dst[x + 2] = t.z; dst[x + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int x = 0; x < W; ++x) dst[x] = src[x];
  }
}

// Σ a[x]·b[x] over W values, a in shared memory (16-byte aligned when W % 4 == 0,
// read as float4), b indexed per element (registers or shared memory).
template <int W>
__device__ __forceinline__ float dot(const float* a, const float* b) {
  float s = 0.f;
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int x = 0; x < W; x += 4) {
      const float4 u = *reinterpret_cast<const float4*>(a + x);
      s += u.x * b[x] + u.y * b[x + 1] + u.z * b[x + 2] + u.w * b[x + 3];
    }
  } else {
#pragma unroll
    for (int x = 0; x < W; ++x) s += a[x] * b[x];
  }
  return s;
}

// The same with both operands in shared memory, both read as float4.
template <int W>
__device__ __forceinline__ float dot_smem(const float* a, const float* b) {
  if constexpr (W % 4 == 0) {
    float s = 0.f;
#pragma unroll
    for (int x = 0; x < W; x += 4) {
      const float4 u = *reinterpret_cast<const float4*>(a + x);
      const float4 w = *reinterpret_cast<const float4*>(b + x);
      s += u.x * w.x + u.y * w.y + u.z * w.z + u.w * w.w;
    }
    return s;
  } else {
    return dot<W>(a, b);
  }
}

// Σ a[x]·b[x] with both operands in registers.
template <int W>
__device__ __forceinline__ float dot_reg(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int x = 0; x < W; ++x) s += a[x] * b[x];
  return s;
}

// Value tile per head dim: the forward kernel's (Tiles<D> in taylor_fwd.cu), so the
// wrapper's value padding serves both.  Mirrored in kernel.py (TILES).
template <int D> struct VTile;
template <> struct VTile<16> { static constexpr int DVT = 16; };
template <> struct VTile<32> { static constexpr int DVT = 32; };
template <> struct VTile<64> { static constexpr int DVT = 8; };
template <> struct VTile<128> { static constexpr int DVT = 1; };

template <int D>
struct Dims {
  static constexpr int DVT = VTile<D>::DVT;
  static constexpr int C = kChunk;
  // The causal C×C tiles on the tensor cores where a block holds one value column; mirrored
  // in kernel.py (TENSOR_ROWS), as taylor_fwd.cu's Layout<D>::tensor_rows.
  static constexpr bool tensor_rows = DVT == 1;
  static constexpr int QS1 = D + 4, KS1 = D + 8;  // pass 1 row strides: Q read, K absorbed
  static constexpr int QS2 = D + 8, KS2 = D + 4;  // pass 2: Q absorbed, K read
  static constexpr int XS = D + 8;                // the q and k slots
  static constexpr int BS = C + 1;                // padded score/ds row stride
  // The ds row strides of each pass: BS on the CUDA cores; on the tensor cores C + 4 in
  // pass 1 (B of ds·K, rows g apart) and C + 8 in pass 2 (A of dsᵀ·Q, rows t apart), so
  // that those fragment loads are free of bank conflicts.
  static constexpr int BS1 = tensor_rows ? C + 4 : BS;
  static constexpr int BS2 = tensor_rows ? C + 8 : BS;
  static constexpr int RS = D + 4;                // rq / rk row stride
  static constexpr int DG = D / kGroups;          // d columns per thread in (row, group) phases
  static constexpr int NVB = DVT >= 8 ? DVT / 8 : 1;  // 8-column value blocks
  static constexpr int NT = C / kRowGroups / 8;  // n-tiles of a warp's rows in the reads
  static constexpr bool kRows = !tensor_rows;     // rq / rk in shared memory (else atomics)
};

// Shared-memory layout (float offsets).  The state (or carry) comes first, so one loop
// zeroes it.
template <int D>
struct Layout {
  using M = Dims<D>;
  static constexpr int s2 = 0;                                 // S2 / dS2 [D][D][DVT]
  static constexpr int z2 = s2 + D * D * M::DVT;               // z2 / dz2 [D][D]
  static constexpr int s1 = z2 + D * D;                        // S1 / dS1 [D][DVT]
  static constexpr int z1 = s1 + round4(D * M::DVT);           // z1 / dz1 [D]
  static constexpr int s0 = z1 + D;                            // dS0 [DVT] (pass 2)
  static constexpr int state_end = s0 + round4(M::DVT);
  static constexpr int k = state_end;                          // [C][XS]
  static constexpr int v = k + M::C * M::XS;                   // [C][DVT]
  static constexpr int q = v + round4(M::C * M::DVT);          // [C][XS]
  static constexpr int dnum = q + M::C * M::XS;                // [C][DVT]
  static constexpr int den = dnum + round4(M::C * M::DVT);     // [C]
  static constexpr int dden = den + M::C;                      // [C]
  static constexpr int dv = dden + M::C;                       // [C][DVT] (pass 2)
  static constexpr int buf = dv + round4(M::C * M::DVT);       // [C][BS2] scores / ds
  static constexpr int r = buf + round4(M::C * M::BS2);        // rq / rk [C][RS]
  static constexpr int rd = r + (M::kRows ? M::C * M::RS : 0); // q·z2·q parts [kParts][C]
  static constexpr int td = rd + kParts * M::C;                // tile row sums [2][C] (pass 1)
  static constexpr int total = td + (M::tensor_rows ? 2 * M::C : 0);
  static constexpr int bytes = total * 4;
};

static_assert(Layout<16>::bytes <= 232448, "smem over budget at D=16");
static_assert(Layout<32>::bytes <= 232448, "smem over budget at D=32");
static_assert(Layout<64>::bytes <= 232448, "smem over budget at D=64");
static_assert(Layout<128>::bytes <= 232448, "smem over budget at D=128");
static_assert(kGroups * kChunk == kThreads, "row phases map kGroups threads per row");
static_assert(kChunk % (8 * kRowGroups) == 0 && kWarps % kRowGroups == 0,
              "the reads deal whole n-tiles of rows and whole parts to the warps");
static_assert(Dims<128>::BS2 >= Dims<128>::BS1, "buf holds either pass's rows");

template <int ORDER>
__device__ __forceinline__ float poly(float s) {
  return ORDER >= 2 ? 1.f + s + 0.5f * s * s : 1.f + s;
}

template <int ORDER>
__device__ __forceinline__ float dpoly(float s) {
  return ORDER >= 2 ? 1.f + s : 1.f;
}

// C rows x D values of T (row-contiguous) -> shared rows of stride XS, as float32.
template <typename T, int D, int XS>
__device__ void load_rows(float* dst, const T* src) {
  for (int i = threadIdx.x; i < kChunk * D; i += kThreads)
    dst[(i / D) * XS + i % D] = to_f32(src[i]);
}

// This block's value tile of C rows of a [*, DV] tensor starting at row0.
template <typename T, int DVT>
__device__ void load_vtile(float* dst, const T* src, long row0, int DV, int v_off) {
  for (int i = threadIdx.x; i < kChunk * DVT; i += kThreads)
    dst[i] = to_f32(src[(row0 + i / DVT) * DV + v_off + i % DVT]);
}

// buf[i][j] = a·q_i·k_j for j ≤ i, 0 above the diagonal.  Neighbouring threads take
// neighbouring rows of the operand at row stride D + 4 (float4 reads free of bank
// conflicts); the other operand's row is the same across a warp.
template <int D, int QS, int KS>
__device__ void score_tile(float* buf, const float* qs, const float* ks, float a) {
  using M = Dims<D>;
  constexpr bool by_q = QS == D + 4;
  for (int idx = threadIdx.x; idx < M::C * M::C; idx += kThreads) {
    const int i = by_q ? idx % M::C : idx / M::C;
    const int j = by_q ? idx / M::C : idx % M::C;
    buf[i * M::BS + j] = j <= i ? a * dot_smem<D>(qs + i * QS, ks + j * KS) : 0.f;
  }
}

// buf (scores) -> ds = causal(dp·poly'(s))·a, dp = dnum·V_tileᵀ (+ dden on the lead tile).
template <int D, int ORDER>
__device__ void scores_to_ds(float* buf, const float* dnum, const float* dden,
                             const float* vs, float a, bool lead) {
  using M = Dims<D>;
  for (int idx = threadIdx.x; idx < M::C * M::C; idx += kThreads) {
    const int i = idx / M::C, j = idx % M::C;
    if (j > i) continue;  // stays 0
    float dp = dot_smem<M::DVT>(dnum + i * M::DVT, vs + j * M::DVT);
    if (lead) dp += dden[i];
    buf[i * M::BS + j] = dp * dpoly<ORDER>(buf[i * M::BS + j]) * a;
  }
}

// ---- tensor-core routines ----

// One 16-row A tile against NT n-tiles of 8 rows of q or k, over KS k-steps of 8:
// c[nt][m, n] = Σ_k A[m][k]·X[n][k].  A holds f32 data (split): a0 of k-step s at
// ap[s·kstep], a1 (row + 8) at +row8, a2 (k + 4) at +k4.  bp points at this lane's b0
// (row g, column t) of X, rows of stride XS; n-tile nt is 8 rows further.
template <bool SPLIT_X, int KS, int NT, int XS>
__device__ __forceinline__ void tile_product(const float* ap, int row8, int k4, int kstep,
                                             const float* bp, float (&c)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) c[nt][x] = 0.f;
#pragma unroll 4
  for (int s = 0; s < KS; ++s) {
    const float* p = ap + s * kstep;
    Frag<4, true> a;
    a.set(0, p[0]);
    a.set(1, p[row8]);
    a.set(2, p[k4]);
    a.set(3, p[row8 + k4]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* b = bp + nt * 8 * XS + s * 8;
      Frag<2, SPLIT_X> f;
      f.set(0, b[0]);
      f.set(1, b[4]);
      mma_split(c[nt], a, f);
    }
  }
}

// One 16-row tile of a moment update against all D/8 n-tiles f, on the tensor cores:
// M[row][f] += Σ_j A[row][j]·X[j][f] over the chunk's rows j (X at row stride XS).
// aval(j) gives (A[g][j], A[g+8][j]) for this lane; the slab entries are at cp (c0), c1
// further (column + 1), c2 (row + 8) and 8·cn per n-tile.  The chunk's sum is taken from
// zero and added to the slab once: accumulating onto the slab would round each of the
// 3·C/8 split products at the slab's magnitude, and pass 2's carry absorbs G·N/C such
// sums: at G = 48, n = 1024 that put f32 dk past chip_smoke.py's BWD_TOL against a
// float64 reference, further off than the f32 plain version.
template <bool SPLIT_A, bool SPLIT_X, int D, int XS, typename AVal>
__device__ __forceinline__ void update_tile(float* cp, int c1, int c2, int cn,
                                            const float* xs, AVal aval) {
  constexpr int NT = D / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float c[NT][4] = {};
#pragma unroll 4
  for (int j0 = 0; j0 < kChunk; j0 += 8) {
    const float2 u = aval(j0 + t), w = aval(j0 + t + 4);
    Frag<4, SPLIT_A> a;
    a.set(0, u.x);
    a.set(1, u.y);
    a.set(2, w.x);
    a.set(3, w.y);
    const float* x0 = xs + (j0 + t) * XS + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      Frag<2, SPLIT_X> b;
      b.set(0, x0[nt * 8]);
      b.set(1, x0[4 * XS + nt * 8]);
      mma_split(c[nt], a, b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* p = cp + nt * 8 * cn;
    p[0] += c[nt][0];
    p[c1] += c[nt][1];
    p[c2] += c[nt][2];
    p[c2 + c1] += c[nt][3];
  }
}

// m2[e,f,v] += Σ_j (x_je·scale·y_jv)·X[j,f] and, when with_z, z2[e,f] += Σ_j
// (scale·w_j·x_je)·X[j,f] over the chunk's rows, on the tensor cores (A = the products
// made in registers, B = X).  Where W is false, w_j = 1 and the z2 A is x_e itself (scale
// must be 1), exact in TF32 for bf16 inputs: one product.  Pass 1 absorbs (K, V) into
// the state; pass 2 absorbs (Q, dnum, dden) into the carry with scale a²/2.  Units are the
// m2 tiles ((e, v) tiles as in the reads, or 16 values of e where DVT = 1) and then the z2
// tiles of 16 values of e, dealt to the warps in turn.
template <bool SPLIT_X, bool W, int D, int XS>
__device__ __forceinline__ void update_second_moments(float* m2, float* z2, const float* xs,
                                                      const float* ys, const float* w,
                                                      float scale, bool with_z) {
  using M = Dims<D>;
  constexpr int DVT = M::DVT, NVB = M::NVB;
  constexpr int NS = DVT >= 8 ? D / 2 * NVB : D / 16, NZ = D / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int units = NS + (with_z ? NZ : 0);
#pragma unroll 1
  for (int u = warp; u < units; u += kWarps) {
    if (u < NS) {
      if constexpr (DVT >= 8) {
        const int e = 2 * (u / NVB), vcol = (u % NVB) * 8 + g;
        update_tile<true, SPLIT_X, D, XS>(
            m2 + (e * D + 2 * t) * DVT + vcol, DVT, D * DVT, DVT, xs, [&](int j) {
              const float2 xx = *reinterpret_cast<const float2*>(xs + j * XS + e);
              const float yy = scale * ys[j * DVT + vcol];
              return make_float2(xx.x * yy, xx.y * yy);
            });
      } else {
        const int e = u * 16 + g;
        update_tile<true, SPLIT_X, D, XS>(m2 + e * D + 2 * t, 1, 8 * D, 1, xs, [&](int j) {
          const float yy = scale * ys[j];
          return make_float2(xs[j * XS + e] * yy, xs[j * XS + e + 8] * yy);
        });
      }
    } else {
      const int e = (u - NS) * 16 + g;
      update_tile<W || SPLIT_X, SPLIT_X, D, XS>(z2 + e * D + 2 * t, 1, 8 * D, 1, xs,
                                                 [&](int j) {
        const float ww = W ? scale * w[j] : 1.f;
        return make_float2(xs[j * XS + e] * ww, xs[j * XS + e + 8] * ww);
      });
    }
  }
}

// The first moments of the same chunk, on the CUDA cores: s1[e][v] += c1·Σ_j x_je·y_jv
// and, when with_z, z1[e] += c1·Σ_j w_j·x_je (w_j = 1 where w is null).
template <int D, int XS>
__device__ __forceinline__ void update_first_moments(float* s1, float* z1, const float* xs,
                                                     const float* ys, const float* w,
                                                     float c1, bool with_z) {
  constexpr int DVT = Dims<D>::DVT;
  const int tid = threadIdx.x;
  for (int idx = tid; idx < D * DVT; idx += kThreads) {
    const int e = idx / DVT, x = idx % DVT;
    float acc = 0.f;
    for (int j = 0; j < kChunk; ++j) acc += xs[j * XS + e] * ys[j * DVT + x];
    s1[idx] += c1 * acc;
  }
  if (with_z) {
    for (int e = tid; e < D; e += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < kChunk; ++j) acc += (w ? w[j] : 1.f) * xs[j * XS + e];
      z1[e] += c1 * acc;
    }
  }
}

// x summed over the 8 lanes g that share t.
__device__ __forceinline__ float sum_g(float x) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Four sums over the 8 lanes g that share t, of x[h][u] (h, u ∈ {0, 1}), in four
// exchanges instead of twelve: returns the sum of x[g & 1][(g >> 1) & 1], which lanes g
// and g ^ 4 both hold.
__device__ __forceinline__ float sum_over_g(const float (&x)[2][2], int g) {
  const bool b0 = g & 1, b1 = g & 2;
  float y[2];
#pragma unroll
  for (int u = 0; u < 2; ++u)
    y[u] = (b0 ? x[1][u] : x[0][u]) +
           __shfl_xor_sync(0xffffffffu, b0 ? x[0][u] : x[1][u], 4);
  const float z = (b1 ? y[1] : y[0]) + __shfl_xor_sync(0xffffffffu, b1 ? y[0] : y[1], 8);
  return z + __shfl_xor_sync(0xffffffffu, z, 16);
}

// Pass 1, one head's chunk: the z2 read.  u[e][i] = Σ_f z2[f,e]·q_if, A = 16 values of
// e read as z2[f][e], B = Q.  Its fold Σ_e q_ie·u[e][i] (the denominator's q·z2·q) is
// summed over the lanes g and written per part to rd[part][i]; where rq exists the
// lead tile also keeps u there (rq[i][e]) for dq's a²·dden·(z2 q) term.
template <bool SPLIT_Q, int D>
__device__ __forceinline__ void read_z2(const float* qs, const float* z2, float* rd,
                                        float* rq, bool lead) {
  using M = Dims<D>;
  constexpr int QS = M::QS1, RS = M::RS, NT = M::NT, C = M::C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / kRowGroups;
  const int r0 = (warp % kRowGroups) * (C / kRowGroups);
  const float* qb = qs + (r0 + g) * QS + t;
  float c[NT][4], pz[NT][2] = {};
#pragma unroll 1
  for (int et = part; et < D / 16; et += kParts) {
    const int e = et * 16 + g;
    tile_product<SPLIT_Q, D / 8, NT, QS>(z2 + t * D + e, 8, 4 * D, 8 * D, qb, c);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int i = r0 + 2 * t + 8 * nt;
      const float* q0 = qs + i * QS + e;
      pz[nt][0] += q0[0] * c[nt][0] + q0[8] * c[nt][2];
      pz[nt][1] += q0[QS] * c[nt][1] + q0[QS + 8] * c[nt][3];
      if (M::kRows && lead) {
        rq[i * RS + e] = c[nt][0];
        rq[(i + 1) * RS + e] = c[nt][1];
        rq[i * RS + e + 8] = c[nt][2];
        rq[(i + 1) * RS + e + 8] = c[nt][3];
      }
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float s = sum_g(pz[nt][h]);
      if (g == 0) rd[part * C + r0 + 2 * t + 8 * nt + h] = s;
    }
}

// Pass 1, one head's chunk, once dnum and dden are known, where DVT ≥ 8 (DVT = 1 takes
// fold_dq): dq's second-moment terms.  T[(d,v), i] = Σ_e S2[d,e,v]·q_ie (A = the slab's
// rows (d,v): two values of d × 8 of v, the lane's g is v; B = Q), folded as
// dq[i,d] = a²·(Σ_v dnum_iv·T[(d,v), i] + dden_i·u[d][i]), the last term on the lead tile
// only: the sum over v goes through sum_over_g, and the result to rq[i][d] (the lead's u
// is read there first).
template <bool SPLIT_Q, int D>
__device__ __forceinline__ void read_s2_dq(const float* qs, const float* s2,
                                           const float* dnum, const float* dden, float* rq,
                                           float a2, bool lead) {
  using M = Dims<D>;
  static_assert(M::kRows, "rq in shared memory");
  constexpr int DVT = M::DVT, QS = M::QS1, RS = M::RS, NT = M::NT, C = M::C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / kRowGroups;
  const int r0 = (warp % kRowGroups) * (C / kRowGroups);
  const float* qb = qs + (r0 + g) * QS + t;
  float c[NT][4];
#pragma unroll 1
  for (int ep = part; ep < D / 2; ep += kParts) {
    float x[NT][2][2] = {};
#pragma unroll
    for (int vb = 0; vb < M::NVB; ++vb) {
      const int vc = vb * 8 + g;
      tile_product<SPLIT_Q, D / 8, NT, QS>(s2 + (2 * ep * D + t) * DVT + vc, D * DVT,
                                            4 * DVT, 8 * DVT, qb, c);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int i = r0 + 2 * t + 8 * nt;
        const float dn0 = dnum[i * DVT + vc], dn1 = dnum[(i + 1) * DVT + vc];
        x[nt][0][0] += dn0 * c[nt][0];
        x[nt][0][1] += dn0 * c[nt][2];
        x[nt][1][0] += dn1 * c[nt][1];
        x[nt][1][1] += dn1 * c[nt][3];
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float s = sum_over_g(x[nt], g);
      if (g < 4) {
        const int i = r0 + 2 * t + 8 * nt + (g & 1), d = 2 * ep + (g >> 1);
        float& r = rq[i * RS + d];
        r = a2 * (s + (lead ? dden[i] * r : 0.f));
      }
    }
  }
}

// Pass 2, one chunk, before its queries join the carry: the carry read.
// U[(t,v), j] = Σ_e dS2[t,e,v]·k_je (A = the slab's rows (t,v), B = K), one product for
// two folds: dv[j,v] += Σ_t k_jt·U[(t,v), j] and dk[j,t] += 2·Σ_v v_jv·U[(t,v), j]; the
// lead tile adds dk's 2·(dz2 k)_t, the e-row product on dz2.  Where DVT ≥ 8 an A tile is
// two values of t × 8 of v: the dv fold keeps the lane's v (registers, then shared atomics
// into dv_s), the dk fold goes through sum_over_g into rk[j][t] (after the dz2 term,
// written there first).  Where DVT = 1 an A tile is 16 values of t read as dS2[e][t], the
// dv fold is summed over the lanes and the dk terms go by atomics into dkc (dk's rows of
// the chunk).  Ends with a block barrier.
template <bool SPLIT_K, int D>
__device__ __forceinline__ void read_carry(const float* ks, const float* vs, const float* ds2,
                                           const float* dz2, float* dv_s, float* rk,
                                           float* dkc, bool lead) {
  using M = Dims<D>;
  constexpr int DVT = M::DVT, XS = M::KS2, RS = M::RS, NT = M::NT, C = M::C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / kRowGroups;
  const int r0 = (warp % kRowGroups) * (C / kRowGroups);
  const float* kb = ks + (r0 + g) * XS + t;
  float c[NT][4];
  if constexpr (M::kRows) {
    if (lead) {
#pragma unroll 1
      for (int et = part; et < D / 16; et += kParts) {
        const int e = et * 16 + g;
        tile_product<SPLIT_K, D / 8, NT, XS>(dz2 + t * D + e, 8, 4 * D, 8 * D, kb, c);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = r0 + 2 * t + 8 * nt;
          rk[j * RS + e] = 2.f * c[nt][0];
          rk[(j + 1) * RS + e] = 2.f * c[nt][1];
          rk[j * RS + e + 8] = 2.f * c[nt][2];
          rk[(j + 1) * RS + e + 8] = 2.f * c[nt][3];
        }
      }
    }
    __syncthreads();  // rk holds the lead's dz2 term
    float dvp[M::NVB][NT][2] = {};
#pragma unroll 1
    for (int tp = part; tp < D / 2; tp += kParts) {
      float x[NT][2][2] = {};
#pragma unroll
      for (int vb = 0; vb < M::NVB; ++vb) {
        const int vc = vb * 8 + g;
        tile_product<SPLIT_K, D / 8, NT, XS>(ds2 + (2 * tp * D + t) * DVT + vc, D * DVT,
                                              4 * DVT, 8 * DVT, kb, c);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int j = r0 + 2 * t + 8 * nt;
          const float2 k0 = *reinterpret_cast<const float2*>(ks + j * XS + 2 * tp);
          const float2 k1 = *reinterpret_cast<const float2*>(ks + (j + 1) * XS + 2 * tp);
          dvp[vb][nt][0] += k0.x * c[nt][0] + k0.y * c[nt][2];
          dvp[vb][nt][1] += k1.x * c[nt][1] + k1.y * c[nt][3];
          const float v0 = vs[j * DVT + vc], v1 = vs[(j + 1) * DVT + vc];
          x[nt][0][0] += v0 * c[nt][0];
          x[nt][0][1] += v0 * c[nt][2];
          x[nt][1][0] += v1 * c[nt][1];
          x[nt][1][1] += v1 * c[nt][3];
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float s = sum_over_g(x[nt], g);
        if (g < 4) {
          const int j = r0 + 2 * t + 8 * nt + (g & 1), tt = 2 * tp + (g >> 1);
          float& r = rk[j * RS + tt];
          r = (lead ? r : 0.f) + 2.f * s;
        }
      }
    }
#pragma unroll
    for (int vb = 0; vb < M::NVB; ++vb)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          atomicAdd(dv_s + (r0 + 2 * t + 8 * nt + h) * DVT + vb * 8 + g, dvp[vb][nt][h]);
  } else {
    float cz[NT][4] = {}, dvp[NT][2] = {};
#pragma unroll 1
    for (int tt0 = part * 16; tt0 < D; tt0 += 16 * kParts) {
      const int tt = tt0 + g;
      tile_product<SPLIT_K, D / 8, NT, XS>(ds2 + t * D + tt, 8, 4 * D, 8 * D, kb, c);
      if (lead) tile_product<SPLIT_K, D / 8, NT, XS>(dz2 + t * D + tt, 8, 4 * D, 8 * D, kb, cz);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = r0 + 2 * t + 8 * nt + h;
          const float vj = vs[j];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            dvp[nt][h] += ks[j * XS + tt + 8 * u] * c[nt][2 * u + h];
            atomicAdd(dkc + j * D + tt + 8 * u, 2.f * (vj * c[nt][2 * u + h] + cz[nt][2 * u + h]));
          }
        }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = sum_g(dvp[nt][h]);
        if (g == 0) atomicAdd(dv_s + r0 + 2 * t + 8 * nt + h, s);
      }
  }
  __syncthreads();  // rk and dv_s hold the carry read
}

// ---- the causal C×C tiles on the tensor cores, where DVT = 1 ----
//
// S = Q·Kᵀ of one head's chunk as taylor_fwd.cu's intra_tile computes it: A = the queries
// (split for f32 inputs), B = the keys, over the 16×8 tiles on or below the diagonal only.
// Warp w takes the row strip m = w % 4 and every other key n-tile from w / 4: c[u] holds
// n-tile w / 4 + 2u for u ≤ m (the last on the diagonal), so that c[u][2h + x] is s_ij / a
// at i = 16m + g + 8h, j = 8(w / 4 + 2u) + 2t + x.  p, ds and the mask are applied to these
// accumulators; ds goes to the second product through buf, where the lanes' roles differ.
constexpr int kStrips = kChunk / 16;
static_assert(kWarps == 2 * kStrips, "two warps a row strip");

template <bool SPLIT, int D, int QS, int KS>
__device__ __forceinline__ void score_mma(const float* qs, const float* ks,
                                          float (&c)[kStrips][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / 4, m = warp % 4;
#pragma unroll
  for (int u = 0; u < kStrips; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) c[u][x] = 0.f;
  const float* qa = qs + (m * 16 + g) * QS + t;
  const float* kb = ks + (part * 8 + g) * KS + t;  // b0 of n-tile part + 2u at +16u·KS
#pragma unroll 4
  for (int s = 0; s < D / 8; ++s) {
    const float* p = qa + s * 8;
    Frag<4, SPLIT> af;
    af.set(0, p[0]);
    af.set(1, p[8 * QS]);
    af.set(2, p[4]);
    af.set(3, p[8 * QS + 4]);
#pragma unroll
    for (int u = 0; u < kStrips; ++u) {
      if (u <= m) {
        const float* bp = kb + u * 16 * KS + s * 8;
        Frag<2, SPLIT> bf;
        bf.set(0, bp[0]);
        bf.set(1, bp[4]);
        mma_split(c[u], af, bf);
      }
    }
  }
}

// Pass 1: the den pass's intra term Σ_{j ≤ i} p_ij, p = poly(a·s), from score_mma's tiles:
// the lane's columns, then the row's 4 lanes by shuffles, into td[w / 4][i], one half of
// the key n-tiles each, which the row threads add in a fixed order.
template <int ORDER>
__device__ __forceinline__ void intra_row_sums(const float (&c)[kStrips][4], float a,
                                               float* td) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / 4, m = warp % 4;
  float den[2] = {0.f, 0.f};  // rows 16m + g and 16m + g + 8
#pragma unroll
  for (int u = 0; u < kStrips; ++u) {
    if (u <= m) {
      const int j0 = (part + 2 * u) * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 2; ++x)  // j > i: on the diagonal tile u = m only
          if (j0 + x <= m * 16 + g + 8 * h) den[h] += poly<ORDER>(a * c[u][2 * h + x]);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 1);
    den[h] += __shfl_xor_sync(0xffffffffu, den[h], 2);
    if (t == 0) td[part * kChunk + m * 16 + g + 8 * h] = den[h];
  }
}

// ds = (dnum_i·v_j (+ dden_i on the lead tile))·poly'(a·s)·a on score_mma's tiles, 0 where
// j > i, stored to buf[i][j] (row stride BS) for the second product.  With DV (pass 2), also
// dv's intra term Σ_{i ≥ j} p_ij·dnum_i: the lane's two rows, then the 8 lanes g of each
// column by shuffles, added to dv_s[j] by shared atomics (one for each row strip).
template <int ORDER, int BS, bool DV>
__device__ __forceinline__ void ds_tiles(const float (&c)[kStrips][4], const float* dnum,
                                         const float* dden, const float* vs, float a,
                                         bool lead, float* buf, float* dv_s) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / 4, m = warp % 4;
  float dn[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = m * 16 + g + 8 * h;
    dn[h] = dnum[i];
    dd[h] = lead ? dden[i] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kStrips; ++u) {
    if (u <= m) {
      const int j0 = (part + 2 * u) * 8 + 2 * t;
      float col[2] = {0.f, 0.f};
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float vj = vs[j0 + x];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = m * 16 + g + 8 * h;
          const float s = a * c[u][2 * h + x];
          const bool causal = j0 + x <= i;
          if (DV && causal) col[x] += poly<ORDER>(s) * dn[h];
          buf[i * BS + j0 + x] = causal ? (dn[h] * vj + dd[h]) * dpoly<ORDER>(s) * a : 0.f;
        }
      }
      if constexpr (DV) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) col[x] += __shfl_xor_sync(0xffffffffu, col[x], o);
          if (g == 0) atomicAdd(dv_s + j0 + x, col[x]);
        }
      }
    }
  }
}

// Pass 1, one head's chunk, where DVT = 1, once ds is in buf: every term of dq in one
// accumulator layout, added to dqh (this head's dq rows of the chunk) by one atomic an
// element:
//   dq[i,d] = Σ_j ds_ij·k_jd + a·dnum_i·S1[d] + a²·dnum_i·T[d,i]
//             + (lead tile) a·dden_i·z1[d] + a²·dden_i·u[d,i],
// T[d,i] = Σ_e S2[d,e]·q_ie and u the same on z2 (A = 16 values of d read as S2[e][d],
// symmetric; B = Q; order 2 only), and ds·K as (Kᵀ·dsᵀ)[d,i] (A = 16 values of d of Kᵀ,
// split for f32 inputs; B = dsᵀ, f32 and split), over the k-steps j ≤ the n-tile's last
// row.  Warp w takes the query n-tiles w % 2, +2, +4, +6 (rows 16 apart: 16 and 20 k-steps
// of ds·K) and the d-tiles w / 2 and w / 2 + 4.
template <bool SPLIT, int D, int ORDER>
__device__ __forceinline__ void fold_dq(const float* qs, const float* ks, const float* buf,
                                        const float* s2, const float* z2, const float* s1,
                                        const float* z1, const float* dnum, const float* dden,
                                        float* dqh, float a, bool lead) {
  using M = Dims<D>;
  static_assert(M::tensor_rows && kRowGroups == 2, "one value column a block, two row sets");
  constexpr int QS = M::QS1, KS = M::KS1, BS = M::BS1, C = M::C, NT = C / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, rg = warp % kRowGroups, part = warp / kRowGroups;
  const float a2 = a * a;
  const float* qb = qs + (8 * rg + g) * QS + t;  // n-tile nt: rows 8·rg + 16·nt
  float c[NT][4] = {}, cz[NT][4] = {}, ck[NT][4];
#pragma unroll 1
  for (int dt = part; dt < D / 16; dt += kParts) {
    const int d = dt * 16 + g;
    if constexpr (ORDER >= 2) {
      tile_product<SPLIT, D / 8, NT, 2 * QS>(s2 + t * D + d, 8, 4 * D, 8 * D, qb, c);
      if (lead) tile_product<SPLIT, D / 8, NT, 2 * QS>(z2 + t * D + d, 8, 4 * D, 8 * D, qb, cz);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) ck[nt][x] = 0.f;
#pragma unroll
    for (int j0 = 0; j0 < C; j0 += 8) {
      if (j0 <= 8 * rg + 16 * (NT - 1)) {
        const float* kp = ks + (j0 + t) * KS + d;
        Frag<4, SPLIT> af;
        af.set(0, kp[0]);
        af.set(1, kp[8]);
        af.set(2, kp[4 * KS]);
        af.set(3, kp[4 * KS + 8]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int i0 = 8 * rg + 16 * nt;
          if (j0 <= i0) {
            const float* bp = buf + (i0 + g) * BS + j0 + t;
            Frag<2, true> bf;
            bf.set(0, bp[0]);
            bf.set(1, bp[4]);
            mma_split(ck[nt], af, bf);
          }
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 8 * rg + 16 * nt + 2 * t + h;
        const float dn = dnum[i], dd = lead ? dden[i] : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int dc = d + 8 * u;
          float x = ck[nt][2 * u + h] + a * (dn * s1[dc] + dd * z1[dc]);
          if constexpr (ORDER >= 2) x += a2 * (dn * c[nt][2 * u + h] + dd * cz[nt][2 * u + h]);
          atomicAdd(dqh + i * D + dc, x);
        }
      }
  }
}

// Pass 2, where DVT = 1: the chunk's dk in the accumulator layout of dsT_q.  Warp w holds
// the key strips w % 2 and 3 − w % 2 (16 rows each: 8 + 2 or 6 + 4 k-steps of i ≥ the
// strip's first row) and the 4 n-tiles of t from (w / 2)·32; for_dk calls f(si, nt, e, j, t)
// for each element acc[si][nt][e] of this lane, at key row j and column t.
template <typename F>
__device__ __forceinline__ void for_dk(F f) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, rg = warp % 2, n0 = (warp / 2) * 32;
#pragma unroll
  for (int si = 0; si < 2; ++si)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 2; ++x)
          f(si, nt, 2 * h + x, 16 * (si ? 3 - rg : rg) + g + 8 * h, n0 + 8 * nt + 2 * t + x);
}

// Pass 2, one head's chunk, where DVT = 1, once ds is in buf: dk[j,t] += Σ_{i ≥ j} ds_ij·q_it
// on the tensor cores, added to acc (for_dk's layout): A = dsᵀ (f32, split once per k-step
// and reused across the 4 n-tiles), B = Q (split for f32 inputs).  Each head's product is
// taken from zero and added to acc once, as update_tile does for the same reason: summed
// onto acc, every split product of all G heads would round at the chunk's whole dk, which
// at G = 48 put dk past chip_smoke.py's BWD_TOL (1.6e-5 bf16, 2.2e-5 f32).
template <bool SPLIT, int D>
__device__ __forceinline__ void dsT_q(const float* buf, const float* qs,
                                      float (&acc)[2][4][4]) {
  using M = Dims<D>;
  static_assert(M::tensor_rows, "one value column a block");
  constexpr int QS = M::QS2, BS = M::BS2, C = M::C;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, rg = warp % 2, n0 = (warp / 2) * 32;
#pragma unroll
  for (int si = 0; si < 2; ++si) {
    const int j0 = 16 * (si ? 3 - rg : rg);
    float c[4][4] = {};
#pragma unroll 2
    for (int i0 = j0; i0 < C; i0 += 8) {
      const float* ap = buf + (i0 + t) * BS + j0 + g;
      Frag<4, true> af;
      af.set(0, ap[0]);
      af.set(1, ap[8]);
      af.set(2, ap[4 * BS]);
      af.set(3, ap[4 * BS + 8]);
      const float* bp = qs + (i0 + t) * QS + n0 + g;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        Frag<2, SPLIT> bf;
        bf.set(0, bp[8 * nt]);
        bf.set(1, bp[4 * QS + 8 * nt]);
        mma_split(c[nt], af, bf);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[si][nt][x] += c[nt][x];
  }
}

// ---------------------------------------------------------------------------------
// Pass 1: dq, den, dden.
// ---------------------------------------------------------------------------------

template <typename T, int D, int ORDER>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM (shared memory)
taylor_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const T* __restrict__ out, float* __restrict__ dq,
                     float* __restrict__ den_out, float* __restrict__ dden_out, int G,
                     int N, int DV, float a) {
  using L = Layout<D>;
  using M = Dims<D>;
  constexpr int DVT = M::DVT, C = M::C, QS = M::QS1, KS = M::KS1, BS = M::BS1, DG = M::DG;
  constexpr bool kSplit = std::is_same<T, float>::value;  // bf16 q, k are TF32-exact

  extern __shared__ __align__(16) float smem[];
  float* s2 = smem + L::s2;
  float* z2 = smem + L::z2;
  float* s1 = smem + L::s1;
  float* z1 = smem + L::z1;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* qs = smem + L::q;
  float* dnum = smem + L::dnum;
  float* den_s = smem + L::den;
  float* dden_s = smem + L::dden;
  float* buf = smem + L::buf;
  float* rq = smem + L::r;
  float* rd = smem + L::rd;
  float* td = smem + L::td;

  const int tid = threadIdx.x;
  const long bk = blockIdx.x;
  const int v_off = blockIdx.y * DVT;
  const bool lead = blockIdx.y == 0;
  const T* qb = q + bk * G * (long)N * D;
  const T* kb = k + bk * (long)N * D;
  const T* vb = v + bk * (long)N * DV;
  const T* dob = dout + bk * G * (long)N * DV;
  const T* ob = out + bk * G * (long)N * DV;
  float* dqb = dq + bk * G * (long)N * D;
  float* denb = den_out + bk * G * (long)N;
  float* ddenb = dden_out + bk * G * (long)N;
  const float a2 = a * a, half_a2 = 0.5f * a2;

  for (int i = tid; i < L::state_end; i += kThreads) smem[i] = 0.f;

  const int nc = N / C;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk's state update is complete
    const long row0 = (long)c * C;
    load_rows<T, D, KS>(ks, kb + row0 * D);
    load_vtile<T, DVT>(vs, vb, row0, DV, v_off);
    const float count = (float)(c * C);  // ones of all earlier chunks

    for (int g = 0; g < G; ++g) {
      const long grow0 = (long)g * N + row0;  // this head's first row of the chunk
      load_rows<T, D, QS>(qs, qb + grow0 * D);
      __syncthreads();
      [[maybe_unused]] float sc[kStrips][4];  // where DVT = 1: the score tiles, to the ds step
      if constexpr (M::tensor_rows) {
        score_mma<kSplit, D, QS, KS>(qs, ks, sc);
        intra_row_sums<ORDER>(sc, a, td);
      } else {
        score_tile<D, QS, KS>(buf, qs, ks, a);
      }
      if constexpr (ORDER >= 2) read_z2<kSplit, D>(qs, z2, rd, rq, lead);
      __syncthreads();

      // ---- rows: den (recomputed as the forward does), dden, dnum ----
      {
        const int i = tid / kGroups, part = tid % kGroups;
        const float* qi = qs + i * QS;
        float intra = 0.f, lin = 0.f, rowdot = 0.f;
        if constexpr (M::tensor_rows) {
          if (part == 0) intra = td[i] + td[C + i];  // the tile's halves, in a fixed order
        } else {
          for (int j = part; j <= i; j += kGroups) intra += poly<ORDER>(buf[i * BS + j]);
        }
        for (int e = part; e < D; e += kGroups) lin += qi[e] * z1[e];
        const T* dor = dob + (grow0 + i) * DV;
        const T* orow = ob + (grow0 + i) * DV;
        for (int x = part; x < DV; x += kGroups) rowdot += to_f32(dor[x]) * to_f32(orow[x]);
#pragma unroll
        for (int off = 1; off < kGroups; off <<= 1) {
          intra += __shfl_xor_sync(0xffffffffu, intra, off);
          lin += __shfl_xor_sync(0xffffffffu, lin, off);
          rowdot += __shfl_xor_sync(0xffffffffu, rowdot, off);
        }
        float quad = 0.f;
        if constexpr (ORDER >= 2)
#pragma unroll
          for (int p = 0; p < kParts; ++p) quad += rd[p * C + i];
        float dn = intra + count + a * lin + half_a2 * quad;
        if (fabsf(dn) < kDenEps) dn = kDenEps;
        const float dd = -rowdot / dn;
        if (part == 0) {
          den_s[i] = dn;
          dden_s[i] = dd;
          if (lead) {
            denb[grow0 + i] = dn;
            ddenb[grow0 + i] = dd;
          }
        }
        for (int x = part; x < DVT; x += kGroups)
          dnum[i * DVT + x] = to_f32(dor[v_off + x]) / dn;
      }
      __syncthreads();
      if constexpr (M::tensor_rows) {
        ds_tiles<ORDER, BS, false>(sc, dnum, dden_s, vs, a, lead, buf, nullptr);
        __syncthreads();
        fold_dq<kSplit, D, ORDER>(qs, ks, buf, s2, z2, s1, z1, dnum, dden_s, dqb + grow0 * D,
                                  a, lead);
      } else {
        scores_to_ds<D, ORDER>(buf, dnum, dden_s, vs, a, lead);
        if constexpr (ORDER >= 2) read_s2_dq<kSplit, D>(qs, s2, dnum, dden_s, rq, a2, lead);
        __syncthreads();

        // ---- dq rows: thread (row i, DG columns from d0) ----
        {
          const int i = tid % C, d0 = (tid / C) * DG;
          float acc[DG];
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) acc[dd] = 0.f;
          // intra-chunk: Σ_j ds_ij k_j (ds is 0 above the diagonal)
          for (int j = 0; j < C; ++j) {
            const float w = buf[i * BS + j];
            float kv[DG];
            load_vec<DG>(kv, ks + j * KS + d0);
#pragma unroll
            for (int dd = 0; dd < DG; ++dd) acc[dd] += w * kv[dd];
          }
          // earlier chunks: a·Σ_v S1[d,v] dnum_v (the S2 and z2 terms are in rq)
          float dn[DVT];
          load_vec<DVT>(dn, dnum + i * DVT);
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) acc[dd] += a * dot<DVT>(s1 + (d0 + dd) * DVT, dn);
          if (lead) {  // value-independent, once
            const float ddi = dden_s[i];
#pragma unroll
            for (int dd = 0; dd < DG; ++dd) acc[dd] += a * ddi * z1[d0 + dd];
          }
          if constexpr (ORDER >= 2) {
            float r[DG];
            load_vec<DG>(r, rq + i * M::RS + d0);
#pragma unroll
            for (int dd = 0; dd < DG; ++dd) acc[dd] += r[dd];
          }
          float* dqr = dqb + (grow0 + i) * D + d0;
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) atomicAdd(dqr + dd, acc[dd]);
        }
      }
      __syncthreads();  // qs, buf, dnum, rq, rd and td are reused by the next head
    }

    // ---- absorb this chunk's keys/values into the state ----
    if constexpr (ORDER >= 2)
      update_second_moments<kSplit, false, D, KS>(s2, z2, ks, vs, nullptr, 1.f, true);
    update_first_moments<D, KS>(s1, z1, ks, vs, nullptr, 1.f, true);
  }
}

// ---------------------------------------------------------------------------------
// Pass 2: dk, dv.
// ---------------------------------------------------------------------------------

template <typename T, int D, int ORDER>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM (shared memory)
taylor_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ den_in, const float* __restrict__ dden_in,
                      float* __restrict__ dk, float* __restrict__ dv, int G, int N, int DV,
                      float a) {
  using L = Layout<D>;
  using M = Dims<D>;
  constexpr int DVT = M::DVT, C = M::C, QS = M::QS2, KS = M::KS2, BS = M::BS2, DG = M::DG;
  constexpr bool kSplit = std::is_same<T, float>::value;

  extern __shared__ __align__(16) float smem[];
  float* ds2 = smem + L::s2;
  float* dz2 = smem + L::z2;
  float* ds1 = smem + L::s1;
  float* dz1 = smem + L::z1;
  float* ds0 = smem + L::s0;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* qs = smem + L::q;
  float* dnum = smem + L::dnum;
  float* dden_s = smem + L::dden;
  float* dv_s = smem + L::dv;
  float* buf = smem + L::buf;
  float* rk = smem + L::r;

  const int tid = threadIdx.x;
  const long bk = blockIdx.x;
  const int v_off = blockIdx.y * DVT;
  const bool lead = blockIdx.y == 0;
  const T* qb = q + bk * G * (long)N * D;
  const T* kb = k + bk * (long)N * D;
  const T* vb = v + bk * (long)N * DV;
  const T* dob = dout + bk * G * (long)N * DV;
  const float* denb = den_in + bk * G * (long)N;
  const float* ddenb = dden_in + bk * G * (long)N;
  float* dkb = dk + bk * (long)N * D;
  float* dvb = dv + bk * (long)N * DV;
  const float half_a2 = 0.5f * a * a;

  for (int i = tid; i < L::state_end; i += kThreads) smem[i] = 0.f;

  // thread (row j, DG columns from t0) in the row phases
  const int j = tid % C, t0 = (tid / C) * DG;
  const int grp = tid / C;

  for (int c = N / C - 1; c >= 0; --c) {
    __syncthreads();  // the later chunk's carry update is complete
    const long row0 = (long)c * C;
    load_rows<T, D, KS>(ks, kb + row0 * D);
    load_vtile<T, DVT>(vs, vb, row0, DV, v_off);
    for (int i = tid; i < C * DVT; i += kThreads) dv_s[i] = 0.f;
    __syncthreads();

    // ---- later chunks read this chunk's k/v through the state: the carry, read
    // before this chunk's own queries are added to it ----
    if constexpr (ORDER >= 2)
      read_carry<kSplit, D>(ks, vs, ds2, dz2, dv_s, rk, dkb + row0 * D, lead);
    // ---- the carry's first-moment terms: dv, and dk's start (dk_acc; where DVT = 1, dka
    // in dsT_q's layout) ----
    [[maybe_unused]] float dk_acc[DG], dka[2][4][4];
    {
      const float* kj = ks + j * KS;
      float vj[DVT], dv_acc[DVT], carry[DG] = {};
      load_vec<DVT>(vj, vs + j * DVT);
      if constexpr (ORDER >= 2 && M::kRows) load_vec<DG>(carry, rk + j * M::RS + t0);
#pragma unroll
      for (int x = 0; x < DVT; ++x) dv_acc[x] = grp == 0 ? ds0[x] : 0.f;
#pragma unroll
      for (int tt = 0; tt < DG; ++tt) {
        const int t = t0 + tt;
        float row[DVT];
        load_vec<DVT>(row, ds1 + t * DVT);
#pragma unroll
        for (int x = 0; x < DVT; ++x) dv_acc[x] += kj[t] * row[x];
        if constexpr (!M::tensor_rows) {
          float dkt = carry[tt] + dot_reg<DVT>(row, vj);
          if (lead) dkt += dz1[t];  // value-independent, once
          dk_acc[tt] = dkt;
        }
      }
#pragma unroll
      for (int x = 0; x < DVT; ++x) atomicAdd(dv_s + j * DVT + x, dv_acc[x]);
    }
    if constexpr (M::tensor_rows)
      for_dk([&](int si, int nt, int e, int jj, int t) {
        dka[si][nt][e] = ds1[t] * vs[jj] + (lead ? dz1[t] : 0.f);
      });

    for (int g = 0; g < G; ++g) {
      const long grow0 = (long)g * N + row0;
      __syncthreads();  // the carry read / the previous head's buffers are done
      load_rows<T, D, QS>(qs, qb + grow0 * D);
      for (int i = tid; i < C * DVT; i += kThreads) {
        const long r = grow0 + i / DVT;
        dnum[i] = to_f32(dob[r * DV + v_off + i % DVT]) / denb[r];
      }
      for (int i = tid; i < C; i += kThreads) dden_s[i] = ddenb[grow0 + i];
      __syncthreads();
      if constexpr (M::tensor_rows) {
        float sc[kStrips][4];
        score_mma<kSplit, D, QS, KS>(qs, ks, sc);
        ds_tiles<ORDER, BS, true>(sc, dnum, dden_s, vs, a, lead, buf, dv_s);
        __syncthreads();
        dsT_q<kSplit, D>(buf, qs, dka);
      } else {
        score_tile<D, QS, KS>(buf, qs, ks, a);
        __syncthreads();

        // ---- intra-chunk dv: Σ_{i ≥ j} p_ij dnum_i (rows split over the groups) ----
        {
          float acc[DVT];
#pragma unroll
          for (int x = 0; x < DVT; ++x) acc[x] = 0.f;
          for (int i = grp; i < C; i += kGroups) {
            if (i < j) continue;
            const float p = poly<ORDER>(buf[i * BS + j]);
            float dn[DVT];
            load_vec<DVT>(dn, dnum + i * DVT);
#pragma unroll
            for (int x = 0; x < DVT; ++x) acc[x] += p * dn[x];
          }
#pragma unroll
          for (int x = 0; x < DVT; ++x) atomicAdd(dv_s + j * DVT + x, acc[x]);
        }
        __syncthreads();
        scores_to_ds<D, ORDER>(buf, dnum, dden_s, vs, a, lead);
        __syncthreads();

        // ---- intra-chunk dk: Σ_i ds_ij q_i (ds is 0 where i < j) ----
        for (int i = 0; i < C; ++i) {
          const float w = buf[i * BS + j];
          float qv[DG];
          load_vec<DG>(qv, qs + i * QS + t0);
#pragma unroll
          for (int tt = 0; tt < DG; ++tt) dk_acc[tt] += w * qv[tt];
        }
      }

      // ---- this head's queries into the carry (for earlier chunks) ----
      if constexpr (ORDER >= 2)
        update_second_moments<kSplit, true, D, QS>(ds2, dz2, qs, dnum, dden_s, half_a2, lead);
      update_first_moments<D, QS>(ds1, dz1, qs, dnum, dden_s, a, lead);
      for (int x = tid; x < DVT; x += kThreads) {
        float acc = 0.f;
        for (int i = 0; i < C; ++i) acc += dnum[i * DVT + x];
        ds0[x] += acc;
      }
    }
    __syncthreads();  // dv_s is complete

    for (int i = tid; i < C * DVT; i += kThreads)
      dvb[(row0 + i / DVT) * DV + v_off + i % DVT] = dv_s[i];
    if constexpr (M::tensor_rows) {
      for_dk([&](int si, int nt, int e, int jj, int t) {
        atomicAdd(dkb + (row0 + jj) * D + t, dka[si][nt][e]);
      });
    } else {
      float* dkr = dkb + (row0 + j) * D + t0;
#pragma unroll
      for (int tt = 0; tt < DG; ++tt) atomicAdd(dkr + tt, dk_acc[tt]);
    }
  }
}

// ---------------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v, *dout, *out;
  float *dq, *dk, *dv, *den, *dden;
  int bk, g, n, dv_cols;
  float a;
  cudaStream_t stream;
};

template <typename T, int D, int ORDER>
cudaError_t launch(const Args& x, bool pass1) {
  using L = Layout<D>;
  if (x.n % kChunk != 0 || x.dv_cols % Dims<D>::DVT != 0) return cudaErrorInvalidValue;
  dim3 grid(x.bk, x.dv_cols / Dims<D>::DVT);
  const T* q = static_cast<const T*>(x.q);
  const T* k = static_cast<const T*>(x.k);
  const T* v = static_cast<const T*>(x.v);
  const T* dout = static_cast<const T*>(x.dout);
  if (pass1) {
    auto kern = taylor_bwd_dq_kernel<T, D, ORDER>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, L::bytes, x.stream>>>(q, k, v, dout,
                                                 static_cast<const T*>(x.out), x.dq, x.den,
                                                 x.dden, x.g, x.n, x.dv_cols, x.a);
  } else {
    auto kern = taylor_bwd_dkv_kernel<T, D, ORDER>;
    cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
    if (err != cudaSuccess) return err;
    kern<<<grid, kThreads, L::bytes, x.stream>>>(q, k, v, dout, x.den, x.dden, x.dk, x.dv,
                                                 x.g, x.n, x.dv_cols, x.a);
  }
  return cudaGetLastError();
}

template <typename T, int ORDER>
cudaError_t dispatch_d(const Args& x, int d, bool pass1) {
  switch (d) {
    case 16: return launch<T, 16, ORDER>(x, pass1);
    case 32: return launch<T, 32, ORDER>(x, pass1);
    case 64: return launch<T, 64, ORDER>(x, pass1);
    case 128: return launch<T, 128, ORDER>(x, pass1);
    default: return cudaErrorInvalidValue;
  }
}

int dispatch(const Args& x, int d, int order, int is_bf16, bool pass1) {
  if (x.bk < 1 || x.g < 1 || x.n < 1) return cudaErrorInvalidValue;
  if (order == 2)
    return is_bf16 ? dispatch_d<__nv_bfloat16, 2>(x, d, pass1)
                   : dispatch_d<float, 2>(x, d, pass1);
  if (order == 1)
    return is_bf16 ? dispatch_d<__nv_bfloat16, 1>(x, d, pass1)
                   : dispatch_d<float, 1>(x, d, pass1);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Pass 1.  q [bk, g, n, d], k [bk, n, d], v [bk, n, dv], dout and out [bk, g, n, dv]: all
// contiguous, float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  dq [bk, g, n, d] float32
// must be zeroed by the caller (value tiles add into it); den and dden [bk, g, n] float32
// are written.  a = 1/(α·√d_true).  Returns a cudaError_t (0 on success).
int taylor_bwd_dq_launch(const void* q, const void* k, const void* v, const void* dout,
                         const void* out, float* dq, float* den, float* dden, int bk, int g,
                         int n, int d, int dv, float a, int order, int is_bf16,
                         void* stream) {
  Args x{q, k, v, dout, out, dq, nullptr, nullptr, den, dden, bk, g, n, dv, a,
         static_cast<cudaStream_t>(stream)};
  return dispatch(x, d, order, is_bf16, true);
}

// Pass 2.  Inputs as pass 1 plus its den and dden.  dk [bk, n, d] float32 must be zeroed
// by the caller; dv [bk, n, dv] float32 is written.
int taylor_bwd_dkv_launch(const void* q, const void* k, const void* v, const void* dout,
                          const float* den, const float* dden, float* dk, float* dv, int bk,
                          int g, int n, int d, int dv_cols, float a, int order, int is_bf16,
                          void* stream) {
  Args x{q, k, v, dout, nullptr, nullptr, dk, dv, const_cast<float*>(den),
         const_cast<float*>(dden), bk, g, n, dv_cols, a, static_cast<cudaStream_t>(stream)};
  return dispatch(x, d, order, is_bf16, false);
}

const char* taylor_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
