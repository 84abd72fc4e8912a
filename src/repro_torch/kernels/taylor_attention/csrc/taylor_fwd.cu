// Causal order-1/2 Taylor linear attention, forward, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/taylor_attention/kernel.py::_taylor_fwd_kernel
// (launched by taylor_fwd_pallas).  It computes the same function: for grouped,
// pre-normalised queries q [BK, G, N, D], keys k [BK, N, D] and values v [BK, N, DV],
// chunk by chunk (C rows), with s = a·q·kᵀ and a = 1/(α√D):
//
//   num = Σ_{j≤i in chunk} p_ij v_j + s0 + a·q·S1 + (a²/2)·(q⊗q)·S2
//   den = Σ_{j≤i in chunk} p_ij + c·C + a·q·z1 + (a²/2)·q·z2·q,  p = 1 + s (+ s²/2)
//   out = num / where(|den| < 1e-6, 1e-6, den)
//
// after which the chunk is absorbed into the moments (S1 += KᵀV, z1 += ΣK, s0 += ΣV,
// z2 += KᵀK, S2 += (K⊗K)ᵀV).  The G query heads of a group share one state (GQA/MQA).
// c·C counts the ones of all earlier chunks; it is exact because the wrapper pads the
// sequence only at its end (padded key/value rows are zero and later than every real
// query row).
//
// What bounds it on this card: arithmetic.  Per (batch·kv-head) at order 2 the state
// read costs G·N·2D²·DV and the state update N·2D²·DV operations, against O(N·(G·D+DV))
// bytes (~2000 operations per byte at the main path's D = DV = 64).  Those two D²·DV
// contractions (with the z2 read and update, 94% of the operations at the main path's
// shape) run on the tensor cores as split-precision TF32 mma.sync products.  The rest
// stays as f32 FMAs on the CUDA cores: the first moments, the S1/z1/s0 updates, and the
// causal C×C intra-chunk tile where D ≤ 64.  chip_smoke.py prints two bounds: its
// bound_ms takes the contractions at the TF32 tensor-core peak times the split products
// this kernel issues for each (below) plus the rest at the f32 CUDA-core peak; a second
// bound takes everything at the f32 CUDA-core peak.  The TF32 peak is wgmma's; the
// mma.sync products used here issue at a lower rate.
//
// The row pass: which head dims take which path.  Where D ≤ 64 (DVT ≥ 8, C = 128) all 256
// threads walk their causal rows on the CUDA cores, DVT/4 threads a row, and that walk is
// the largest part of the kernel at D = 64 (PERF.md).  Where D = 128 (DVT = 1, C = 64) a
// thread a row would leave 192 of the 256 idle, with one warp on its scheduler walking 64
// 128-wide dot products; there the tile runs on the tensor cores (intra_tile, all 8 warps,
// the lower-triangle 16×8 tiles only) and four threads a row finish it (finish_rows).  It
// is then bounded by the state read and update, which every value-column block repeats:
// ~4096 mma.sync a chunk and head against the tile's ~320 (bf16), and by the synchronous
// per-head query loads.
//
// The two contractions.  In both, the operand that holds f32 data and must be split is
// the A operand (16 rows), split once per k-step and reused across all of a warp's
// n-tiles; the other operand is exact in TF32 for bf16 inputs.
//   * State read, per chunk and head: T[(e,v), i] = Σ_f S2[e,f,v]·Q[i,f], A = the
//     resident S2 slab (rows (e,v), depth f), B = the chunk's queries.  Where DVT ≥ 8
//     an A tile is two values of e × 8 values of v, so the fold num[i,v] += q_ie·T[(e,v),i]
//     (1/D of the product, CUDA cores) keeps each lane on one v.  Where DVT = 1
//     (D = 128) an A tile is 16 values of e, read as S2[f,e] (S2 is symmetric in e, f;
//     the transposed read puts a fragment row in 8 banks instead of 1), and the fold
//     sums over e, so the 8 lanes that share a row are added by shuffles.  The
//     denominator's q·z2·q is the same e-row scheme on z2, once per row and head.  Warp
//     w takes a quarter of the rows and half of the A tiles; the halves are added in a
//     fixed order, so the output repeats bit for bit.
//   * State update, after every head has read the chunk (causality): S2[e,f,v] +=
//     Σ_j (k_je·v_jv)·K[j,f] with A = the products k_e·v made in registers, B = K from
//     shared memory, and z2[e,f] += Σ_j k_je·K[j,f] the same way (A = k_e; one product
//     for bf16 inputs, where it is exact).  The accumulators are loaded from the slab,
//     summed over the chunk's C rows and stored back.
//   * The read's results go through a small shared buffer (rn, rd) to the row threads,
//     which add the intra-chunk and first-moment terms and write the output.
//   * The intra-chunk tile at D = 128: S = Q·Kᵀ with A = the queries (split for f32
//     inputs), B = the keys (split for f32 inputs; bf16 takes one product), p, the mask
//     and v on the f32 accumulators; its two halves go through tn, td as the read's do.
//
// Why mma.sync and not wgmma: wgmma takes B only from shared memory (A from registers or
// shared memory), so every operand that needs a split must be A, split in registers, and
// a split B would be stored twice (hi and lo; S2 in B would be 256 KiB at DVT = 8, over
// the 227 KB a block can use).  With f32 inputs both operands of both contractions are
// f32.  mma.sync takes both operands from registers, so one code path splits either on
// the fly from the f32 slabs, for both input types.  A wgmma version for bf16 inputs
// (A = the split S2 or k_e·v in the warpgroup register layout, B = Q or K in shared
// memory) is left for later; it would lift the contractions to wgmma's issue rate.
//
// Split precision (error budget): one TF32 product keeps ~11 bits, ~2e-4 relative error
// on these contractions, over the 1e-4 the plain-version check allows.  An f32 operand
// x is split as hi = x rounded to TF32 (to nearest, on the bits: cvt.rna.tf32.f32
// compiles to a much longer sequence) and lo = x − hi (exact), of which the tensor core
// reads the top 19 bits, so x = hi + lo up to 2^-21·|x|; then a·b ≈ a_hi·b_hi +
// a_lo·b_hi + a_hi·b_lo (a_lo·b_lo, ~2^-22, is dropped): ~2e-7 relative, the f32
// accumulation's own order.  For bfloat16 inputs q and k are exact in TF32, so two
// products suffice (one for the z2 update); S2 (read) and k_e·v (update) are f32 and
// are always split.  tests/test_torch_kernels_split.py emulates the scheme in numpy
// against float64.
//
// Shared memory (one block per SM): the S2 slab (D²·DVT·4 = 128 KiB at D = 64) stays
// resident for the whole sequence.  Keys sit at a row stride of D+8 floats and queries
// at D+4, so that fragments that walk down rows hit distinct banks; at DVT = 8 (D = 64)
// every fragment load of the read and the update is free of bank conflicts.  Global
// loads are 16 bytes wide.
//
// The sequential chunk axis: the TPU kernel carries the moments across a sequential
// grid axis in VMEM.  Here each block owns one (batch·kv-head, DV tile) and loops over
// the chunks itself, so nothing has to survive between blocks; the value dimension is
// split across blocks (DVT columns each) so that each block's S2 slab fits.
//
// Left for later: the intra-chunk tile on the tensor cores at D ≤ 64, one z2 read per
// (chunk, head) shared by the value-column blocks at D = 128, 96 blocks on 132 SMs at the
// main path's shape, S2's symmetry (e ≤ f halves both contractions), wgmma with TMA
// loads.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the caller's stream,
// allocates nothing (the caller owns q, k, v and out) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "tf32_mma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Loads W consecutive floats from shared memory, float4-wide (W is a multiple of 4;
// callers keep the address 16-byte aligned).
template <int W>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  static_assert(W % 4 == 0, "whole float4s");
#pragma unroll
  for (int x = 0; x < W; x += 4) {
    const float4 t = *reinterpret_cast<const float4*>(src + x);
    dst[x] = t.x; dst[x + 1] = t.y; dst[x + 2] = t.z; dst[x + 3] = t.w;
  }
}

// 16 loaded bytes of T as f32 at d (16-byte aligned).
__device__ __forceinline__ void unpack(const uint4& r, float* d, float) {
  *reinterpret_cast<float4*>(d) = make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                                              __uint_as_float(r.z), __uint_as_float(r.w));
}
__device__ __forceinline__ void unpack(const uint4& r, float* d, __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int u = 0; u < 4; u += 2)
    *reinterpret_cast<float4*>(d + 2 * u) = make_float4(
        __uint_as_float(w[u] << 16), __uint_as_float(w[u] & 0xffff0000u),
        __uint_as_float(w[u + 1] << 16), __uint_as_float(w[u + 1] & 0xffff0000u));
}

// Copies rows × W elements (source row stride ld) into shared memory as f32 (row
// stride dst_ld, a multiple of 4), 16 bytes per global load where W allows it (the
// wrapper keeps q, k, v 16-byte aligned).
template <int W, typename T>
__device__ __forceinline__ void load_rows(float* dst, int dst_ld, const T* src, int ld,
                                          int rows) {
  constexpr int V = W * sizeof(T) >= 16 ? 16 / sizeof(T) : 1;
  for (int i = threadIdx.x; i < rows * (W / V); i += kThreads) {
    const int r = i / (W / V), col = (i % (W / V)) * V;
    const T* p = src + (long)r * ld + col;
    if constexpr (V == 1) dst[r * dst_ld + col] = to_f32(*p);
    else unpack(*reinterpret_cast<const uint4*>(p), dst + r * dst_ld + col, T());
  }
}

// Tile table: head dim D -> (value tile DVT, chunk C).  Mirrored in kernel.py (TILES).
template <int D> struct Tiles;
template <> struct Tiles<16> { static constexpr int DVT = 16, C = 128; };
template <> struct Tiles<32> { static constexpr int DVT = 32, C = 128; };
template <> struct Tiles<64> { static constexpr int DVT = 8, C = 128; };
template <> struct Tiles<128> { static constexpr int DVT = 1, C = 64; };

template <int D>
struct Layout {
  static constexpr int DVT = Tiles<D>::DVT;
  static constexpr int C = Tiles<D>::C;
  // The intra-chunk tile on the tensor cores where a block holds one value column;
  // mirrored in kernel.py (TENSOR_ROWS).
  static constexpr bool tensor_rows = DVT == 1;
  static constexpr int QS = D + 4;  // query row stride (floats)
  static constexpr int KST = D + 8; // key row stride (floats)
  static constexpr int s2 = 0;
  static constexpr int z2 = s2 + D * D * DVT;
  static constexpr int s1 = z2 + D * D;
  static constexpr int z1 = s1 + round4(D * DVT);
  static constexpr int s0 = z1 + D;
  static constexpr int k = s0 + round4(DVT);
  static constexpr int v = k + C * KST;
  static constexpr int q = v + round4(C * DVT);
  static constexpr int rn = q + C * QS;   // state read, numerator terms [C][DVT]
  static constexpr int rd = rn + C * DVT; // state read, denominator terms [C]
  static constexpr int tn = rd + C;       // tensor-core tile, numerator halves [2][C]
  static constexpr int td = tn + (tensor_rows ? 2 * C : 0);  // denominator halves [2][C]
  static constexpr int total = td + (tensor_rows ? 2 * C : 0);  // floats
  static constexpr int bytes = total * 4;
};

static_assert(Layout<16>::bytes <= 232448, "smem over budget at D=16");
static_assert(Layout<32>::bytes <= 232448, "smem over budget at D=32");
static_assert(Layout<64>::bytes <= 232448, "smem over budget at D=64");
static_assert(Layout<128>::bytes <= 232448, "smem over budget at D=128");

// One 16-row A tile of the state read against the NT query n-tiles of this warp's rows:
// c[nt][m, n] = Σ_f A[m][f]·Q[n][f], where a0 of k-step s is ap[s·kstep], a1 (row + 8)
// at +row8 and a2 (f + 4) at +k4; qb points at this lane's b0 (row g, f = t).
template <bool SPLIT_Q, int D, int NT>
__device__ __forceinline__ void read_tile(const float* ap, int row8, int k4, int kstep,
                                          const float* qb, float (&c)[NT][4]) {
  constexpr int QS = Layout<D>::QS;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int x = 0; x < 4; ++x) c[nt][x] = 0.f;
#pragma unroll 4
  for (int s = 0; s < D / 8; ++s) {
    const float* p = ap + s * kstep;
    Frag<4, true> a;
    a.set(0, p[0]);
    a.set(1, p[row8]);
    a.set(2, p[k4]);
    a.set(3, p[row8 + k4]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* bp = qb + nt * 8 * QS + s * 8;
      Frag<2, SPLIT_Q> b;
      b.set(0, bp[0]);
      b.set(1, bp[4]);
      mma_split(c[nt], a, b);
    }
  }
}

// The second-moment terms of one head's chunk, on the tensor cores:
//   rn[i][v] = Σ_e q_ie Σ_f q_if S2[e,f,v],   rd[i] = Σ_e q_ie Σ_f q_if z2[e,f].
// The f32 state is the A operand, split once per warp and reused across the warp's
// query n-tiles; the queries are B.  Warp w takes the rows (w % 4)·C/4 … and the half
// w / 4 of the state's tiles; the halves are added in a fixed order (part 0 writes,
// part 1 adds), so the result repeats bit for bit.  Ends with a block barrier.
template <bool SPLIT_Q, int D>
__device__ __forceinline__ void read_second_moments(const float* qs, const float* s2,
                                                    const float* z2, float* rn, float* rd) {
  using L = Layout<D>;
  constexpr int DVT = L::DVT, C = L::C, QS = L::QS;
  constexpr int NT = C / 32, NVB = DVT >= 8 ? DVT / 8 : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / 4;
  const int r0 = (warp % 4) * (C / 4);
  const float* qb = qs + (r0 + g) * QS + t;
  const float* qi = qs + (r0 + 2 * t) * QS;  // c0's query row in n-tile 0
  float c[NT][4];
  float pn[NVB][NT][2], pz[NT][2];  // partials: numerator (per value block), z2 term
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      pz[nt][h] = 0.f;
#pragma unroll
      for (int vb = 0; vb < NVB; ++vb) pn[vb][nt][h] = 0.f;
    }

  // An "e-row" tile: 16 values of e of a symmetric D×D matrix M, A[e][f] = M[f, e]
  // (8 banks per fragment row instead of 1).  Its fold sums over e, so each lane holds
  // part of a row's sum and the 8 lanes g are added below.
  auto e_rows = [&](const float* m, int e0, float (&p)[NT][2]) {
    read_tile<SPLIT_Q, D, NT>(m + t * D + e0 + g, 8, 4 * D, 8 * D, qb, c);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float* q0 = qi + nt * 8 * QS + e0 + g;
      p[nt][0] += q0[0] * c[nt][0] + q0[8] * c[nt][2];
      p[nt][1] += q0[QS] * c[nt][1] + q0[QS + 8] * c[nt][3];
    }
  };

  if constexpr (DVT >= 8) {
    // (e, v) tiles: rows g and g+8 are (2ep, v) and (2ep+1, v), v = vb·8 + g, so the
    // fold keeps the lane's value column and sums the tile's two values of e.
#pragma unroll 1
    for (int ep = part; ep < D / 2; ep += 2) {
#pragma unroll
      for (int vb = 0; vb < NVB; ++vb) {
        read_tile<SPLIT_Q, D, NT>(s2 + (2 * ep * D + t) * DVT + vb * 8 + g, D * DVT,
                                  4 * DVT, 8 * DVT, qb, c);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 qa = *reinterpret_cast<const float2*>(qi + nt * 8 * QS + 2 * ep);
          const float2 qc = *reinterpret_cast<const float2*>(qi + nt * 8 * QS + QS + 2 * ep);
          pn[vb][nt][0] += qa.x * c[nt][0] + qa.y * c[nt][2];
          pn[vb][nt][1] += qc.x * c[nt][1] + qc.y * c[nt][3];
        }
      }
    }
  } else {
#pragma unroll 1
    for (int et = part; et < D / 16; et += 2) e_rows(s2, et * 16, pn[0]);
  }
#pragma unroll 1
  for (int et = part; et < D / 16; et += 2) e_rows(z2, et * 16, pz);

#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int o = 4; o < 32; o <<= 1) {
        pz[nt][h] += __shfl_xor_sync(0xffffffffu, pz[nt][h], o);
        if constexpr (DVT == 1) pn[0][nt][h] += __shfl_xor_sync(0xffffffffu, pn[0][nt][h], o);
      }

#pragma unroll
  for (int p = 0; p < 2; ++p) {
    if (part == p) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = r0 + 2 * t + 8 * nt + h;
          if constexpr (DVT >= 8) {
#pragma unroll
            for (int vb = 0; vb < NVB; ++vb) {
              float& r = rn[i * DVT + vb * 8 + g];
              r = (p ? r : 0.f) + pn[vb][nt][h];
            }
          }
          if (g == 0) {
            rd[i] = (p ? rd[i] : 0.f) + pz[nt][h];
            if constexpr (DVT == 1) rn[i] = (p ? rn[i] : 0.f) + pn[0][nt][h];
          }
        }
    }
    __syncthreads();
  }
}

// One 16-row tile of the state update against all D/8 key n-tiles f, on the tensor
// cores: M[row][f] += Σ_j A[row][j]·K[j][f] over the chunk's rows j.  aval(j) gives
// (A[g][j], A[g+8][j]) for this lane; the accumulators are read from the slab at cp (c0),
// c1 further (column + 1), c2 (row + 8) and 8·cn per n-tile, and written back.
template <bool SPLIT_A, bool SPLIT_K, int D, typename AVal>
__device__ __forceinline__ void update_tile(float* cp, int c1, int c2, int cn,
                                            const float* ks, AVal aval) {
  using L = Layout<D>;
  constexpr int C = L::C, KST = L::KST, NT = D / 8;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  float c[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* p = cp + nt * 8 * cn;
    c[nt][0] = p[0];
    c[nt][1] = p[c1];
    c[nt][2] = p[c2];
    c[nt][3] = p[c2 + c1];
  }
#pragma unroll 4
  for (int j0 = 0; j0 < C; j0 += 8) {
    const float2 u = aval(j0 + t), w = aval(j0 + t + 4);
    Frag<4, SPLIT_A> a;
    a.set(0, u.x);
    a.set(1, u.y);
    a.set(2, w.x);
    a.set(3, w.y);
    const float* k0 = ks + (j0 + t) * KST + g;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      Frag<2, SPLIT_K> b;
      b.set(0, k0[nt * 8]);
      b.set(1, k0[4 * KST + nt * 8]);
      mma_split(c[nt], a, b);
    }
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    float* p = cp + nt * 8 * cn;
    p[0] = c[nt][0];
    p[c1] = c[nt][1];
    p[c2] = c[nt][2];
    p[c2 + c1] = c[nt][3];
  }
}

// S2[e,f,v] += Σ_j (k_je·v_jv)·K[j,f] and z2[e,f] += Σ_j k_je·K[j,f] over the chunk's
// rows, after every head has read the chunk.  A holds the f32 products k_e·v (split
// for either input type) or k_e (exact for bf16 inputs: z2 takes one product); B = K.
// Units are the S2 tiles ((e, v) tiles as in the read, or e-row tiles where DVT = 1)
// and then the z2 e-row tiles, dealt to the warps in turn.
template <bool SPLIT_K, int D>
__device__ __forceinline__ void update_second_moments(float* s2, float* z2, const float* ks,
                                                      const float* vs) {
  using L = Layout<D>;
  constexpr int DVT = L::DVT, KST = L::KST;
  constexpr int NVB = DVT >= 8 ? DVT / 8 : 1;
  constexpr int NS = DVT >= 8 ? D / 2 * NVB : D / 16, NZ = D / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll 1
  for (int u = warp; u < NS + NZ; u += kWarps) {
    if (u < NS) {
      if constexpr (DVT >= 8) {
        const int e = 2 * (u / NVB), vcol = (u % NVB) * 8 + g;
        update_tile<true, SPLIT_K, D>(
            s2 + (e * D + 2 * t) * DVT + vcol, DVT, D * DVT, DVT, ks, [&](int j) {
              const float2 kk = *reinterpret_cast<const float2*>(ks + j * KST + e);
              const float vv = vs[j * DVT + vcol];
              return make_float2(kk.x * vv, kk.y * vv);
            });
      } else {
        const int e = u * 16 + g;
        update_tile<true, SPLIT_K, D>(s2 + e * D + 2 * t, 1, 8 * D, 1, ks, [&](int j) {
          const float vv = vs[j];
          return make_float2(ks[j * KST + e] * vv, ks[j * KST + e + 8] * vv);
        });
      }
    } else {
      const int e = (u - NS) * 16 + g;
      update_tile<SPLIT_K, SPLIT_K, D>(z2 + e * D + 2 * t, 1, 8 * D, 1, ks, [&](int j) {
        return make_float2(ks[j * KST + e], ks[j * KST + e + 8]);
      });
    }
  }
}

// The causal C×C intra-chunk tile of one head on the tensor cores, where a block holds
// one value column (DVT = 1):
//   tn[part][i] = Σ_j p_ij·v_j,  td[part][i] = Σ_j p_ij,  p = 1 + s (+ s²/2), s = a·q_i·k_j,
// over the key n-tiles j0 … j0+7 of the half `part`, j ≤ i.  S = Q·Kᵀ runs as mma.sync
// products with A = the queries (split once per k-step for f32 inputs, reused across the
// warp's n-tiles) and B = the keys; p, the causal mask and v are applied to the f32
// accumulators.  Warp w takes the row strip (w % 4)·16 … and every other n-tile on or
// below the diagonal, starting at w / 4: m + 1 tiles for strip m, the last of them on the
// diagonal.  The 4 lanes of a row are added by shuffles; the two halves go to separate
// buffers, which the row threads add in a fixed order, so the output repeats bit for bit.
template <bool SPLIT, int D, int ORDER>
__device__ __forceinline__ void intra_tile(const float* qs, const float* ks, const float* vs,
                                           float a, float* tn, float* td) {
  using L = Layout<D>;
  constexpr int C = L::C, QS = L::QS, KST = L::KST, MT = C / 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, part = warp / 4, m = warp % 4;
  const int r0 = m * 16;
  float c[MT][4];
#pragma unroll
  for (int u = 0; u < MT; ++u)
#pragma unroll
    for (int x = 0; x < 4; ++x) c[u][x] = 0.f;
  const float* qa = qs + (r0 + g) * QS + t;
  const float* kb = ks + (part * 8 + g) * KST + t;  // b0 of n-tile part + 2u at +16u·KST
#pragma unroll 4
  for (int s = 0; s < D / 8; ++s) {
    const float* p = qa + s * 8;
    Frag<4, SPLIT> af;
    af.set(0, p[0]);
    af.set(1, p[8 * QS]);
    af.set(2, p[4]);
    af.set(3, p[8 * QS + 4]);
#pragma unroll
    for (int u = 0; u < MT; ++u) {
      if (u <= m) {
        const float* bp = kb + u * 16 * KST + s * 8;
        Frag<2, SPLIT> bf;
        bf.set(0, bp[0]);
        bf.set(1, bp[4]);
        mma_split(c[u], af, bf);
      }
    }
  }
  float num[2] = {0.f, 0.f}, den[2] = {0.f, 0.f};  // rows r0 + g and r0 + g + 8
#pragma unroll
  for (int u = 0; u < MT; ++u) {
    if (u <= m) {
      const int j0 = (part + 2 * u) * 8 + 2 * t;
      const float2 vv = *reinterpret_cast<const float2*>(vs + j0);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const float s = a * c[u][2 * h + x];
          float p = 1.f + s;
          if (ORDER >= 2) p += 0.5f * s * s;
          if (j0 + x > r0 + g + 8 * h) p = 0.f;  // j > i: on the diagonal tile u = m only
          num[h] += p * (x ? vv.y : vv.x);
          den[h] += p;
        }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      num[h] += __shfl_xor_sync(0xffffffffu, num[h], o);
      den[h] += __shfl_xor_sync(0xffffffffu, den[h], o);
    }
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tn[part * C + r0 + g + 8 * h] = num[h];
      td[part * C + r0 + g + 8 * h] = den[h];
    }
  }
}

// The first moments of a row where the tile ran on the tensor cores (DVT = 1): (q·z1, q·S1),
// four lanes a row, each over a quarter of e, added by shuffles.  Read before the state
// read, so that these loads overlap the other warps' products.
template <int D>
__device__ __forceinline__ float2 first_moments(const float* qs, const float* s1,
                                                const float* z1) {
  using L = Layout<D>;
  constexpr int C = L::C, QS = L::QS, LANES = kThreads / C;
  static_assert(L::DVT == 1 && LANES == 4, "one value column, four lanes a row");
  const int i = threadIdx.x / LANES, u = threadIdx.x % LANES;
  float zl = 0.f, lin = 0.f;
#pragma unroll
  for (int x = 0; x < D / (4 * LANES); ++x) {
    const int e = 4 * (u + LANES * x);
    const float4 qv = *reinterpret_cast<const float4*>(qs + i * QS + e);
    const float4 zv = *reinterpret_cast<const float4*>(z1 + e);
    const float4 sv = *reinterpret_cast<const float4*>(s1 + e);
    zl += qv.x * zv.x + qv.y * zv.y + qv.z * zv.z + qv.w * zv.w;
    lin += qv.x * sv.x + qv.y * sv.y + qv.z * sv.z + qv.w * sv.w;
  }
#pragma unroll
  for (int o = 1; o < LANES; o <<= 1) {
    zl += __shfl_xor_sync(0xffffffffu, zl, o);
    lin += __shfl_xor_sync(0xffffffffu, lin, o);
  }
  return make_float2(zl, lin);
}

// The row threads after the tensor-core tile (DVT = 1): the row's first lane adds the tile's
// halves in a fixed order, the constant terms, the first moments fm = (q·z1, q·S1) and the
// state read's terms, clamps, divides and stores the row's one value to out[i·DV].
template <typename T, int D, int ORDER>
__device__ __forceinline__ void finish_rows(const float* s0, const float* tn, const float* td,
                                            const float* rn, const float* rd, float2 fm,
                                            float count, float a, T* out, int DV) {
  constexpr int C = Layout<D>::C, LANES = kThreads / C;
  const int i = threadIdx.x / LANES;
  if (threadIdx.x % LANES == 0) {
    float den = td[i] + td[C + i] + count + a * fm.x;
    float num = tn[i] + tn[C + i] + s0[0] + a * fm.y;
    if constexpr (ORDER >= 2) {
      const float half_a2 = 0.5f * a * a;
      den += half_a2 * rd[i];
      num += half_a2 * rn[i];
    }
    if (fabsf(den) < 1e-6f) den = 1e-6f;  // the TPU kernel's clamp
    store(out + (long)i * DV, num * (1.f / den));
  }
}

// The row threads where the tile stays on the CUDA cores (DVT ≥ 8, D ≤ 64): NVG threads a
// row, VPT value columns each, walk the causal row j ≤ i against the chunk's keys, add the
// constant, first-moment and state-read terms, clamp, divide and store to out[i·DV + col].
template <typename T, int D, int ORDER>
__device__ __forceinline__ void core_rows(const float* qs, const float* ks, const float* vs,
                                          const float* s1, const float* z1, const float* s0,
                                          const float* rn, const float* rd, float count,
                                          float a, T* out, int DV) {
  using L = Layout<D>;
  constexpr int DVT = L::DVT, C = L::C, QS = L::QS, KST = L::KST;
  constexpr int VPT = 4;                // value columns per thread
  static_assert(DVT % VPT == 0, "whole value-column groups");
  constexpr int NVG = DVT / VPT;        // value-column groups
  constexpr int RPP = kThreads / NVG;   // query rows per pass
  const int tid = threadIdx.x;
  const float half_a2 = 0.5f * a * a;
  const int vg = tid % NVG;
  const int vcol = vg * VPT;
  for (int r0 = 0; r0 < C; r0 += RPP) {
    const int i = r0 + tid / NVG;
    if (i < C) {
      float qr[D];
#pragma unroll
      for (int f = 0; f < D; f += 4) {
        const float4 t = *reinterpret_cast<const float4*>(&qs[i * QS + f]);
        qr[f] = t.x; qr[f + 1] = t.y; qr[f + 2] = t.z; qr[f + 3] = t.w;
      }
      float num[VPT];
#pragma unroll
      for (int x = 0; x < VPT; ++x) num[x] = 0.f;
      float den = 0.f;

      // intra-chunk: causal polynomial scores against this chunk's keys
      for (int j = 0; j <= i; ++j) {
        float s = 0.f;
#pragma unroll
        for (int f = 0; f < D; f += 4) {
          const float4 t = *reinterpret_cast<const float4*>(&ks[j * KST + f]);
          s += qr[f] * t.x + qr[f + 1] * t.y + qr[f + 2] * t.z + qr[f + 3] * t.w;
        }
        s *= a;
        float p = 1.f + s;
        if (ORDER >= 2) p += 0.5f * s * s;
        den += p;
        float vv[VPT];
        load_vec<VPT>(vv, vs + j * DVT + vcol);
#pragma unroll
        for (int x = 0; x < VPT; ++x) num[x] += p * vv[x];
      }

      // inter-chunk: constant and first moments
      den += count;
      float lin[VPT], zl = 0.f;
#pragma unroll
      for (int x = 0; x < VPT; ++x) lin[x] = 0.f;
#pragma unroll
      for (int e = 0; e < D; ++e) {
        zl += qr[e] * z1[e];
#pragma unroll
        for (int x = 0; x < VPT; ++x) lin[x] += qr[e] * s1[e * DVT + vcol + x];
      }
      den += a * zl;
#pragma unroll
      for (int x = 0; x < VPT; ++x) num[x] += s0[vcol + x] + a * lin[x];

      // inter-chunk: second moments, from the tensor-core read
      if constexpr (ORDER >= 2) {
        den += half_a2 * rd[i];
#pragma unroll
        for (int x = 0; x < VPT; ++x) num[x] += half_a2 * rn[i * DVT + vcol + x];
      }

      if (fabsf(den) < 1e-6f) den = 1e-6f;  // the TPU kernel's clamp
      const float inv = 1.f / den;
      T* op = out + (long)i * DV + vcol;
#pragma unroll
      for (int x = 0; x < VPT; ++x) store(op + x, num[x] * inv);
    }
  }
}

template <typename T, int D, int ORDER>
__global__ void __launch_bounds__(kThreads, 1)  // one block per SM (shared memory)
taylor_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int G, int N,
                  int DV, float a) {
  using L = Layout<D>;
  constexpr int DVT = L::DVT, C = L::C, QS = L::QS, KST = L::KST;
  constexpr bool kSplit = std::is_same<T, float>::value;  // bf16 q, k are TF32-exact

  extern __shared__ __align__(16) float smem[];
  float* s2 = smem + L::s2;
  float* z2 = smem + L::z2;
  float* s1 = smem + L::s1;
  float* z1 = smem + L::z1;
  float* s0 = smem + L::s0;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* qs = smem + L::q;
  float* rn = smem + L::rn;
  float* rd = smem + L::rd;
  float* tn = smem + L::tn;
  float* td = smem + L::td;

  const int tid = threadIdx.x;
  const long bk = blockIdx.x;
  const int v_off = blockIdx.y * DVT;
  const T* qb = q + bk * G * (long)N * D;
  const T* kb = k + bk * (long)N * D;
  const T* vb = v + bk * (long)N * DV;
  T* ob = out + bk * G * (long)N * DV;

  for (int i = tid; i < L::k; i += kThreads) smem[i] = 0.f;  // all moments

  const int nc = N / C;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk's update is complete
    const long row0 = (long)c * C;
    load_rows<D>(ks, KST, kb + row0 * D, D, C);
    load_rows<DVT>(vs, DVT, vb + row0 * DV + v_off, DV, C);
    const float count = (float)(c * C);  // ones of all earlier chunks

    for (int g = 0; g < G; ++g) {
      load_rows<D>(qs, QS, qb + ((long)g * N + row0) * D, D, C);
      __syncthreads();
      T* og = ob + ((long)g * N + row0) * DV + v_off;  // this head's chunk, value tile
      if constexpr (L::tensor_rows) {
        intra_tile<kSplit, D, ORDER>(qs, ks, vs, a, tn, td);
        const float2 fm = first_moments<D>(qs, s1, z1);
        if constexpr (ORDER >= 2) read_second_moments<kSplit, D>(qs, s2, z2, rn, rd);
        else __syncthreads();  // tn and td are complete (at order 2 the read's barriers)
        finish_rows<T, D, ORDER>(s0, tn, td, rn, rd, fm, count, a, og, DV);
      } else {
        if constexpr (ORDER >= 2) read_second_moments<kSplit, D>(qs, s2, z2, rn, rd);
        core_rows<T, D, ORDER>(qs, ks, vs, s1, z1, s0, rn, rd, count, a, og, DV);
      }
      __syncthreads();  // qs, rn, rd (tn, td) are rewritten for the next head
    }

    // ---- absorb this chunk into the moments ----
    if constexpr (ORDER >= 2) update_second_moments<kSplit, D>(s2, z2, ks, vs);
    for (int idx = tid; idx < D * DVT; idx += kThreads) {
      const int e = idx / DVT, x = idx % DVT;
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc += ks[j * KST + e] * vs[j * DVT + x];
      s1[idx] += acc;
    }
    for (int e = tid; e < D; e += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc += ks[j * KST + e];
      z1[e] += acc;
    }
    for (int x = tid; x < DVT; x += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc += vs[j * DVT + x];
      s0[x] += acc;
    }
  }
}

template <typename T, int D, int ORDER>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int bk,
                   int g, int n, int dv, float a, cudaStream_t stream) {
  using L = Layout<D>;
  if (n % L::C != 0 || dv % L::DVT != 0) return cudaErrorInvalidValue;
  auto kern = taylor_fwd_kernel<T, D, ORDER>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(bk, dv / L::DVT);
  kern<<<grid, kThreads, L::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), g, n, dv, a);
  return cudaGetLastError();
}

template <typename T, int ORDER>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out, int bk,
                       int g, int n, int d, int dv, float a, cudaStream_t s) {
  switch (d) {
    case 16: return launch<T, 16, ORDER>(q, k, v, out, bk, g, n, dv, a, s);
    case 32: return launch<T, 32, ORDER>(q, k, v, out, bk, g, n, dv, a, s);
    case 64: return launch<T, 64, ORDER>(q, k, v, out, bk, g, n, dv, a, s);
    case 128: return launch<T, 128, ORDER>(q, k, v, out, bk, g, n, dv, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q [bk, g, n, d], k [bk, n, d], v [bk, n, dv], out [bk, g, n, dv]; all contiguous,
// float32 (is_bf16 = 0) or bfloat16 (is_bf16 = 1).  a = 1/(α·√d_true).  Returns a
// cudaError_t (0 on success).
int taylor_fwd_launch(const void* q, const void* k, const void* v, void* out, int bk,
                      int g, int n, int d, int dv, float a, int order, int is_bf16,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bk < 1 || g < 1 || n < 1) return cudaErrorInvalidValue;
  if (order == 2)
    return is_bf16 ? dispatch_d<__nv_bfloat16, 2>(q, k, v, out, bk, g, n, d, dv, a, s)
                   : dispatch_d<float, 2>(q, k, v, out, bk, g, n, d, dv, a, s);
  if (order == 1)
    return is_bf16 ? dispatch_d<__nv_bfloat16, 1>(q, k, v, out, bk, g, n, d, dv, a, s)
                   : dispatch_d<float, 1>(q, k, v, out, bk, g, n, d, dv, a, s);
  return cudaErrorInvalidValue;
}

const char* taylor_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
