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
// bytes, so at the main path's D = DV = 64 it does ~2000 operations per byte.  The
// second-moment contractions are triple products (q_e·q_f·S2[e,f,v]), which this
// kernel evaluates on the CUDA cores in float32; its roof is the f32 CUDA-core peak.
//
// What the design does about the TPU design's assumptions:
//   * The TPU kernel carries the moments across a sequential grid axis in VMEM.  Here
//     each block owns one (batch·kv-head, DV tile) and loops over the chunks itself, so
//     nothing has to survive between blocks.
//   * S2 is D²·DV·4 bytes (1 MiB per head at D = DV = 64) and cannot live in one
//     block's shared memory.  The value dimension is split across blocks (DVT columns
//     each) so that every block's S2 slab is D²·DVT·4 = 128 KiB, resident in shared
//     memory for the whole sequence.  Each block recomputes the denominator (z1, z2,
//     the intra-chunk row sums) for itself, as each TPU program does per DV tile.
//   * The triple-product read is a loop over e (q_e from shared memory) around an
//     unrolled loop over f (q_f in registers), with S2 and z2 read as broadcast float4
//     loads, so each shared-memory load feeds several FMAs.
//   * Queries sit in shared memory with a row stride of D+4 floats so that threads
//     reading different rows hit different banks.
//
// Interface: a plain C function, loaded with ctypes.  It launches on the caller's stream,
// allocates nothing (the caller owns q, k, v and out) and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

constexpr int round4(int x) { return (x + 3) / 4 * 4; }

// Loads W consecutive floats from shared memory; float4-wide when W is a multiple
// of 4 (callers keep such addresses 16-byte aligned).
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

// Tile table: head dim D -> (value tile DVT, chunk C).  Mirrored in kernel.py (_TILES).
template <int D> struct Tiles;
template <> struct Tiles<16> { static constexpr int DVT = 16, C = 128; };
template <> struct Tiles<32> { static constexpr int DVT = 32, C = 128; };
template <> struct Tiles<64> { static constexpr int DVT = 8, C = 128; };
template <> struct Tiles<128> { static constexpr int DVT = 1, C = 64; };

template <int D>
struct Layout {
  static constexpr int DVT = Tiles<D>::DVT;
  static constexpr int C = Tiles<D>::C;
  static constexpr int QS = D + 4;  // padded query row stride (floats)
  static constexpr int s2 = 0;
  static constexpr int z2 = s2 + D * D * DVT;
  static constexpr int s1 = z2 + D * D;
  static constexpr int z1 = s1 + round4(D * DVT);
  static constexpr int s0 = z1 + D;
  static constexpr int k = s0 + round4(DVT);
  static constexpr int v = k + C * D;
  static constexpr int q = v + round4(C * DVT);
  static constexpr int total = q + C * QS;  // floats
  static constexpr int bytes = total * 4;
};

static_assert(Layout<64>::bytes <= 232448, "smem over budget at D=64");
static_assert(Layout<128>::bytes <= 232448, "smem over budget at D=128");
static_assert(Layout<32>::bytes <= 232448, "smem over budget at D=32");

template <typename T, int D, int ORDER>
__global__ void __launch_bounds__(kThreads)
taylor_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int G, int N,
                  int DV, float a) {
  using L = Layout<D>;
  constexpr int DVT = L::DVT, C = L::C, QS = L::QS;
  constexpr int VPT = DVT >= 4 ? 4 : DVT;  // value columns per thread
  constexpr int NVG = DVT / VPT;           // value-column groups
  constexpr int RPP = kThreads / NVG;      // query rows per pass
  constexpr int FT = D >= 8 ? 8 : D;       // update tile: f columns
  constexpr int VT = VPT;                  // update tile: value columns

  extern __shared__ __align__(16) float smem[];
  float* s2 = smem + L::s2;
  float* z2 = smem + L::z2;
  float* s1 = smem + L::s1;
  float* z1 = smem + L::z1;
  float* s0 = smem + L::s0;
  float* ks = smem + L::k;
  float* vs = smem + L::v;
  float* qs = smem + L::q;

  const int tid = threadIdx.x;
  const long bk = blockIdx.x;
  const int v_off = blockIdx.y * DVT;
  const T* qb = q + bk * G * (long)N * D;
  const T* kb = k + bk * (long)N * D;
  const T* vb = v + bk * (long)N * DV;
  T* ob = out + bk * G * (long)N * DV;
  const float half_a2 = 0.5f * a * a;

  for (int i = tid; i < L::k; i += kThreads) smem[i] = 0.f;  // all moments

  const int nc = N / C;
  for (int c = 0; c < nc; ++c) {
    __syncthreads();  // the previous chunk's update is complete
    const long row0 = (long)c * C;
    for (int i = tid; i < C * D; i += kThreads) ks[i] = to_f32(kb[row0 * D + i]);
    for (int i = tid; i < C * DVT; i += kThreads) {
      const int r = i / DVT, col = i % DVT;
      vs[i] = to_f32(vb[(row0 + r) * DV + v_off + col]);
    }
    const float count = (float)(c * C);  // ones of all earlier chunks

    for (int g = 0; g < G; ++g) {
      const T* qg = qb + ((long)g * N + row0) * D;
      for (int i = tid; i < C * D; i += kThreads)
        qs[(i / D) * QS + i % D] = to_f32(qg[i]);
      __syncthreads();

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
              const float4 t = *reinterpret_cast<const float4*>(&ks[j * D + f]);
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

          // inter-chunk: second moments, Σ_e q_e Σ_f q_f (S2[e,f,:], z2[e,f])
          if (ORDER >= 2) {
            float quad[VPT], zq = 0.f;
#pragma unroll
            for (int x = 0; x < VPT; ++x) quad[x] = 0.f;
#pragma unroll 1
            for (int e = 0; e < D; ++e) {
              const float qe = qs[i * QS + e];
              const float* s2e = s2 + e * D * DVT;
              const float* z2e = z2 + e * D;
#pragma unroll
              for (int f = 0; f < D; f += 4) {
                const float4 zz = *reinterpret_cast<const float4*>(&z2e[f]);
                const float zf[4] = {zz.x, zz.y, zz.z, zz.w};
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const float qq = qe * qr[f + u];
                  zq += qq * zf[u];
                  float sv[VPT];
                  load_vec<VPT>(sv, s2e + (f + u) * DVT + vcol);
#pragma unroll
                  for (int x = 0; x < VPT; ++x) quad[x] += qq * sv[x];
                }
              }
            }
            den += half_a2 * zq;
#pragma unroll
            for (int x = 0; x < VPT; ++x) num[x] += half_a2 * quad[x];
          }

          if (fabsf(den) < 1e-6f) den = 1e-6f;  // the TPU kernel's clamp
          const float inv = 1.f / den;
          T* op = ob + ((long)g * N + row0 + i) * DV + v_off + vcol;
#pragma unroll
          for (int x = 0; x < VPT; ++x) store(op + x, num[x] * inv);
        }
      }
      __syncthreads();  // qs is reloaded for the next head
    }

    // ---- absorb this chunk into the moments ----
    if (ORDER >= 2) {
      constexpr int FB = D / FT, VB = DVT / VT;
      for (int tile = tid; tile < D * FB * VB; tile += kThreads) {
        const int vb_ = tile % VB;
        const int fb = (tile / VB) % FB;
        const int e = tile / (VB * FB);
        const int f0 = fb * FT, v0 = vb_ * VT;
        float acc[FT][VT];
#pragma unroll
        for (int ff = 0; ff < FT; ++ff)
#pragma unroll
          for (int x = 0; x < VT; ++x) acc[ff][x] = 0.f;
        for (int j = 0; j < C; ++j) {
          const float ke = ks[j * D + e];
          float kf[FT], vv[VT];
          load_vec<FT>(kf, ks + j * D + f0);
          load_vec<VT>(vv, vs + j * DVT + v0);
#pragma unroll
          for (int ff = 0; ff < FT; ++ff) kf[ff] *= ke;
#pragma unroll
          for (int ff = 0; ff < FT; ++ff)
#pragma unroll
            for (int x = 0; x < VT; ++x) acc[ff][x] += kf[ff] * vv[x];
        }
#pragma unroll
        for (int ff = 0; ff < FT; ++ff)
#pragma unroll
          for (int x = 0; x < VT; ++x) s2[(e * D + f0 + ff) * DVT + v0 + x] += acc[ff][x];
      }
      for (int tile = tid; tile < D * FB; tile += kThreads) {
        const int e = tile / FB, f0 = (tile % FB) * FT;
        float acc[FT];
#pragma unroll
        for (int ff = 0; ff < FT; ++ff) acc[ff] = 0.f;
        for (int j = 0; j < C; ++j) {
          const float ke = ks[j * D + e];
          float kf[FT];
          load_vec<FT>(kf, ks + j * D + f0);
#pragma unroll
          for (int ff = 0; ff < FT; ++ff) acc[ff] += ke * kf[ff];
        }
#pragma unroll
        for (int ff = 0; ff < FT; ++ff) z2[e * D + f0 + ff] += acc[ff];
      }
    }
    for (int idx = tid; idx < D * DVT; idx += kThreads) {
      const int e = idx / DVT, x = idx % DVT;
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc += ks[j * D + e] * vs[j * DVT + x];
      s1[idx] += acc;
    }
    for (int e = tid; e < D; e += kThreads) {
      float acc = 0.f;
      for (int j = 0; j < C; ++j) acc += ks[j * D + e];
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
