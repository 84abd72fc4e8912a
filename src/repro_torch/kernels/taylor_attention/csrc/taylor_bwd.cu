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
// update) and pass 2 about (G+2)·N·2D²·DV (two carry reads, G carry updates), against
// O(N·G·(D+DV)) bytes: ~2.25x the forward's operations at G = 3, on the f32 CUDA cores.
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
// Interface: plain C functions, loaded with ctypes.  They launch on the caller's stream,
// allocate nothing (the caller owns all inputs, outputs and the den/dden scratch) and
// return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 64;                  // the backward's sequence chunk
constexpr int kGroups = kThreads / kChunk;  // threads per row in row-parallel phases
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
  static constexpr int XS = D + 4;        // padded q/k row stride (floats)
  static constexpr int BS = C + 1;        // padded score/ds row stride
  static constexpr int DG = D / kGroups;  // d columns per thread in (row, group) phases
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
  static constexpr int buf = dv + round4(M::C * M::DVT);       // [C][BS] scores / ds
  static constexpr int total = buf + round4(M::C * M::BS);
  static constexpr int bytes = total * 4;
};

static_assert(Layout<16>::bytes <= 232448, "smem over budget at D=16");
static_assert(Layout<32>::bytes <= 232448, "smem over budget at D=32");
static_assert(Layout<64>::bytes <= 232448, "smem over budget at D=64");
static_assert(Layout<128>::bytes <= 232448, "smem over budget at D=128");
static_assert(kGroups * kChunk == kThreads, "row phases map kGroups threads per row");

template <int ORDER>
__device__ __forceinline__ float poly(float s) {
  return ORDER >= 2 ? 1.f + s + 0.5f * s * s : 1.f + s;
}

template <int ORDER>
__device__ __forceinline__ float dpoly(float s) {
  return ORDER >= 2 ? 1.f + s : 1.f;
}

// rows x D values of T (row-contiguous) -> shared rows of stride XS, as float32.
template <typename T, int D>
__device__ void load_rows(float* dst, const T* src) {
  for (int i = threadIdx.x; i < kChunk * D; i += kThreads)
    dst[(i / D) * Dims<D>::XS + i % D] = to_f32(src[i]);
}

// This block's value tile of C rows of a [*, DV] tensor starting at row0.
template <typename T, int DVT>
__device__ void load_vtile(float* dst, const T* src, long row0, int DV, int v_off) {
  for (int i = threadIdx.x; i < kChunk * DVT; i += kThreads)
    dst[i] = to_f32(src[(row0 + i / DVT) * DV + v_off + i % DVT]);
}

// buf[i][j] = a·q_i·k_j for j ≤ i, 0 above the diagonal.
template <int D>
__device__ void score_tile(float* buf, const float* qs, const float* ks, float a) {
  using M = Dims<D>;
  for (int idx = threadIdx.x; idx < M::C * M::C; idx += kThreads) {
    const int i = idx / M::C, j = idx % M::C;
    buf[i * M::BS + j] = j <= i ? a * dot_smem<D>(qs + i * M::XS, ks + j * M::XS) : 0.f;
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

// Adds one chunk of rows x [C][XS] (weights w, or 1 where w is null) and y [C][DVT] to
// moments:  s2[e][f][v] += c2·Σ x_e x_f y_v,  s1[e][v] += c1·Σ x_e y_v  and, when with_z,
// z2[e][f] += c2·Σ w x_e x_f,  z1[e] += c1·Σ w x_e.  Pass 1 absorbs (K, V) into the
// state; pass 2 absorbs (Q, dnum, dden) into the carry.
template <int D, int ORDER>
__device__ void absorb(float* s2, float* z2, float* s1, float* z1, const float* xs,
                       const float* ys, const float* w, float c1, float c2, bool with_z) {
  using M = Dims<D>;
  constexpr int DVT = M::DVT, XS = M::XS, C = M::C;
  constexpr int FT = D >= 8 ? 8 : D;       // tile: f columns
  constexpr int VT = DVT >= 4 ? 4 : DVT;   // tile: value columns
  constexpr int FB = D / FT;
  const int tid = threadIdx.x;
  if constexpr (ORDER >= 2) {
    constexpr int VB = DVT / VT;
    for (int tile = tid; tile < D * FB * VB; tile += kThreads) {
      const int vb = tile % VB;
      const int fb = (tile / VB) % FB;
      const int e = tile / (VB * FB);
      const int f0 = fb * FT, v0 = vb * VT;
      float acc[FT][VT];
#pragma unroll
      for (int ff = 0; ff < FT; ++ff)
#pragma unroll
        for (int x = 0; x < VT; ++x) acc[ff][x] = 0.f;
      for (int j = 0; j < C; ++j) {
        const float xe = xs[j * XS + e];
        float xf[FT], yv[VT];
        load_vec<FT>(xf, xs + j * XS + f0);
        load_vec<VT>(yv, ys + j * DVT + v0);
#pragma unroll
        for (int ff = 0; ff < FT; ++ff) xf[ff] *= xe;
#pragma unroll
        for (int ff = 0; ff < FT; ++ff)
#pragma unroll
          for (int x = 0; x < VT; ++x) acc[ff][x] += xf[ff] * yv[x];
      }
#pragma unroll
      for (int ff = 0; ff < FT; ++ff)
#pragma unroll
        for (int x = 0; x < VT; ++x) s2[(e * D + f0 + ff) * DVT + v0 + x] += c2 * acc[ff][x];
    }
    if (with_z) {
      for (int tile = tid; tile < D * FB; tile += kThreads) {
        const int e = tile / FB, f0 = (tile % FB) * FT;
        float acc[FT];
#pragma unroll
        for (int ff = 0; ff < FT; ++ff) acc[ff] = 0.f;
        for (int j = 0; j < C; ++j) {
          const float xe = xs[j * XS + e] * (w ? w[j] : 1.f);
          float xf[FT];
          load_vec<FT>(xf, xs + j * XS + f0);
#pragma unroll
          for (int ff = 0; ff < FT; ++ff) acc[ff] += xe * xf[ff];
        }
#pragma unroll
        for (int ff = 0; ff < FT; ++ff) z2[e * D + f0 + ff] += c2 * acc[ff];
      }
    }
  }
  for (int idx = tid; idx < D * DVT; idx += kThreads) {
    const int e = idx / DVT, x = idx % DVT;
    float acc = 0.f;
    for (int j = 0; j < C; ++j) acc += xs[j * XS + e] * ys[j * DVT + x];
    s1[idx] += c1 * acc;
  }
  if (with_z) {
    for (int e = tid; e < D; e += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc += (w ? w[j] : 1.f) * xs[j * XS + e];
      z1[e] += c1 * acc;
    }
  }
}

// ---------------------------------------------------------------------------------
// Pass 1: dq, den, dden.
// ---------------------------------------------------------------------------------

template <typename T, int D, int ORDER>
__global__ void __launch_bounds__(kThreads)
taylor_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const T* __restrict__ out, float* __restrict__ dq,
                     float* __restrict__ den_out, float* __restrict__ dden_out, int G,
                     int N, int DV, float a) {
  using L = Layout<D>;
  using M = Dims<D>;
  constexpr int DVT = M::DVT, C = M::C, XS = M::XS, BS = M::BS, DG = M::DG;

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
    load_rows<T, D>(ks, kb + row0 * D);
    load_vtile<T, DVT>(vs, vb, row0, DV, v_off);
    const float count = (float)(c * C);  // ones of all earlier chunks

    for (int g = 0; g < G; ++g) {
      const long grow0 = (long)g * N + row0;  // this head's first row of the chunk
      load_rows<T, D>(qs, qb + grow0 * D);
      __syncthreads();
      score_tile<D>(buf, qs, ks, a);
      __syncthreads();

      // ---- rows: den (recomputed as the forward does), dden, dnum ----
      {
        const int i = tid / kGroups, part = tid % kGroups;
        const float* qi = qs + i * XS;
        float intra = 0.f, lin = 0.f, quad = 0.f, rowdot = 0.f;
        for (int j = part; j <= i; j += kGroups) intra += poly<ORDER>(buf[i * BS + j]);
        for (int e = part; e < D; e += kGroups) {
          lin += qi[e] * z1[e];
          if (ORDER >= 2) quad += qi[e] * dot_smem<D>(z2 + e * D, qi);
        }
        const T* dor = dob + (grow0 + i) * DV;
        const T* orow = ob + (grow0 + i) * DV;
        for (int x = part; x < DV; x += kGroups) rowdot += to_f32(dor[x]) * to_f32(orow[x]);
#pragma unroll
        for (int off = 1; off < kGroups; off <<= 1) {
          intra += __shfl_xor_sync(0xffffffffu, intra, off);
          lin += __shfl_xor_sync(0xffffffffu, lin, off);
          quad += __shfl_xor_sync(0xffffffffu, quad, off);
          rowdot += __shfl_xor_sync(0xffffffffu, rowdot, off);
        }
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
      scores_to_ds<D, ORDER>(buf, dnum, dden_s, vs, a, lead);
      __syncthreads();

      // ---- dq rows: thread (row i, DG columns from d0) ----
      {
        const int i = tid % C, d0 = (tid / C) * DG;
        const float* qi = qs + i * XS;
        float acc[DG];
#pragma unroll
        for (int dd = 0; dd < DG; ++dd) acc[dd] = 0.f;
        // intra-chunk: Σ_j ds_ij k_j (ds is 0 above the diagonal)
        for (int j = 0; j < C; ++j) {
          const float w = buf[i * BS + j];
          float kv[DG];
          load_vec<DG>(kv, ks + j * XS + d0);
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) acc[dd] += w * kv[dd];
        }
        // earlier chunks: a·Σ_v S1[d,v] dnum_v  and  a²·Σ_e q_e Σ_v S2[d,e,v] dnum_v
        float dn[DVT];
        load_vec<DVT>(dn, dnum + i * DVT);
#pragma unroll
        for (int dd = 0; dd < DG; ++dd) acc[dd] += a * dot<DVT>(s1 + (d0 + dd) * DVT, dn);
        if (ORDER >= 2) {
          float quad[DG];
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) quad[dd] = 0.f;
#pragma unroll 2
          for (int e = 0; e < D; ++e) {
            const float qe = qi[e];
#pragma unroll
            for (int dd = 0; dd < DG; ++dd)
              quad[dd] += qe * dot<DVT>(s2 + ((d0 + dd) * D + e) * DVT, dn);
          }
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) acc[dd] += a2 * quad[dd];
        }
        if (lead) {  // value-independent terms, once
          const float ddi = dden_s[i];
#pragma unroll
          for (int dd = 0; dd < DG; ++dd) acc[dd] += a * ddi * z1[d0 + dd];
          if (ORDER >= 2) {
            float u[DG];
#pragma unroll
            for (int dd = 0; dd < DG; ++dd) u[dd] = 0.f;
            for (int e = 0; e < D; ++e) {  // (z2 q)_d, with z2 symmetric
              const float qe = qi[e];
              float zr[DG];
              load_vec<DG>(zr, z2 + e * D + d0);
#pragma unroll
              for (int dd = 0; dd < DG; ++dd) u[dd] += zr[dd] * qe;
            }
#pragma unroll
            for (int dd = 0; dd < DG; ++dd) acc[dd] += a2 * ddi * u[dd];
          }
        }
        float* dqr = dqb + (grow0 + i) * D + d0;
#pragma unroll
        for (int dd = 0; dd < DG; ++dd) atomicAdd(dqr + dd, acc[dd]);
      }
      __syncthreads();  // qs, buf and dnum are reused by the next head
    }

    // ---- absorb this chunk's keys/values into the state ----
    absorb<D, ORDER>(s2, z2, s1, z1, ks, vs, nullptr, 1.f, 1.f, true);
  }
}

// ---------------------------------------------------------------------------------
// Pass 2: dk, dv.
// ---------------------------------------------------------------------------------

template <typename T, int D, int ORDER>
__global__ void __launch_bounds__(kThreads)
taylor_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ den_in, const float* __restrict__ dden_in,
                      float* __restrict__ dk, float* __restrict__ dv, int G, int N, int DV,
                      float a) {
  using L = Layout<D>;
  using M = Dims<D>;
  constexpr int DVT = M::DVT, C = M::C, XS = M::XS, BS = M::BS, DG = M::DG;

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
    load_rows<T, D>(ks, kb + row0 * D);
    load_vtile<T, DVT>(vs, vb, row0, DV, v_off);
    for (int i = tid; i < C * DVT; i += kThreads) dv_s[i] = 0.f;
    __syncthreads();

    // ---- later chunks read this chunk's k/v through the state: the carry, read
    // before this chunk's own queries are added to it ----
    float dk_acc[DG];
#pragma unroll
    for (int tt = 0; tt < DG; ++tt) dk_acc[tt] = 0.f;
    {
      const float* kj = ks + j * XS;
      float vj[DVT], dv_acc[DVT];
      load_vec<DVT>(vj, vs + j * DVT);
#pragma unroll
      for (int x = 0; x < DVT; ++x) dv_acc[x] = grp == 0 ? ds0[x] : 0.f;
      for (int tt = 0; tt < DG; ++tt) {
        const int t = t0 + tt;
        const float kt = kj[t];
        float row[DVT];
        load_vec<DVT>(row, ds1 + t * DVT);
        float dkt = dot_reg<DVT>(row, vj);
#pragma unroll
        for (int x = 0; x < DVT; ++x) dv_acc[x] += kt * row[x];
        if (ORDER >= 2) {
#pragma unroll 2
          for (int e = 0; e < D; ++e) {
            const float ke = kj[e];
            load_vec<DVT>(row, ds2 + (t * D + e) * DVT);
            dkt += 2.f * ke * dot_reg<DVT>(row, vj);
            const float kk = kt * ke;
#pragma unroll
            for (int x = 0; x < DVT; ++x) dv_acc[x] += kk * row[x];
          }
        }
        if (lead) {  // value-independent terms, once
          dkt += dz1[t];
          if (ORDER >= 2) dkt += 2.f * dot_smem<D>(dz2 + t * D, kj);
        }
        dk_acc[tt] = dkt;
      }
#pragma unroll
      for (int x = 0; x < DVT; ++x) atomicAdd(dv_s + j * DVT + x, dv_acc[x]);
    }

    for (int g = 0; g < G; ++g) {
      const long grow0 = (long)g * N + row0;
      __syncthreads();  // the carry read / the previous head's buffers are done
      load_rows<T, D>(qs, qb + grow0 * D);
      for (int i = tid; i < C * DVT; i += kThreads) {
        const long r = grow0 + i / DVT;
        dnum[i] = to_f32(dob[r * DV + v_off + i % DVT]) / denb[r];
      }
      for (int i = tid; i < C; i += kThreads) dden_s[i] = ddenb[grow0 + i];
      __syncthreads();
      score_tile<D>(buf, qs, ks, a);
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
        load_vec<DG>(qv, qs + i * XS + t0);
#pragma unroll
        for (int tt = 0; tt < DG; ++tt) dk_acc[tt] += w * qv[tt];
      }

      // ---- this head's queries into the carry (for earlier chunks) ----
      absorb<D, ORDER>(ds2, dz2, ds1, dz1, qs, dnum, dden_s, a, half_a2, lead);
      for (int x = tid; x < DVT; x += kThreads) {
        float acc = 0.f;
        for (int i = 0; i < C; ++i) acc += dnum[i * DVT + x];
        ds0[x] += acc;
      }
    }
    __syncthreads();  // dv_s is complete

    for (int i = tid; i < C * DVT; i += kThreads)
      dvb[(row0 + i / DVT) * DV + v_off + i % DVT] = dv_s[i];
    float* dkr = dkb + (row0 + j) * D + t0;
#pragma unroll
    for (int tt = 0; tt < DG; ++tt) atomicAdd(dkr + tt, dk_acc[tt]);
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
