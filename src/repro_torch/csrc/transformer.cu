// The transformer's hot spots for Hopper (sm_90a): K16 rmsnorm, K15
// flash_attention (forward), and the two recurrences of the ssm and hybrid
// families, K17 wkv6 (RWKV-6) and K18 ssd (Mamba-2, in chunks).
//
// Each kernel replaces one of the reference's Pallas kernels
// (src/repro/kernels/rmsnorm.py, attention.py, rwkv6.py, mamba2.py) and
// computes the same function on the layouts the reference's ops hand it:
// (R, D) rows for the norm, (BH, T, D) heads flattened and GQA repeated
// for attention, (BH, T, K) for wkv6, (B, T, H, P) for ssd.  Inputs are
// float32 or bfloat16 (the dtype code is an argument: 0, 1; ssd's decay
// exponents are float32 always); all arithmetic is float32 and every
// output is rounded once to the input's dtype; bfloat16 K15 alone runs
// its products on the tensor cores (bf16 operands, float32 sums) and
// rounds its softmax weights to bf16 for P V.  The reference tiles rows
// and time into blocks and pads; here each kernel computes its own
// offsets (64-bit) and masks the ragged edges itself, so nothing is
// padded and nothing past the end of an input is read.  K18 works in a
// float32 scratch that its wrapper allocates.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through ctypes (kernels/common.py).
// Every C entry launches on the caller's stream and returns
// cudaGetLastError().  No --use_fast_math: expf and rsqrtf are the
// library's accurate versions.

#include <cuda.h>           // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int DT_F32 = 0, DT_BF16 = 1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K16 rmsnorm — replaces src/repro/kernels/rmsnorm.py rmsnorm
// (_rmsnorm_kernel, pl.pallas_call at rmsnorm.py:24).
//   y[r, :] = dt(x[r, :] * rsqrt(mean(x[r, :]^2) + eps)) * w, the product
//   with w rounded once more to dt (the input's dtype).
// The reference rounds x*r to dt and then multiplies by w in dt.  A
// product of two bf16 values is exact in float32, so one
// float32 multiply and one rounding to dt give the reference's bits.
// Bound: 2*R*D*sizeof(dt) bytes (x read, y written) plus w; ~4 flops an
// element is far below any rate.  Design: a warp a row, RMS_WARPS rows a
// CTA, and no barrier: the float32 sum of squares is taken by xor
// shuffles alone, so every lane adds the same values in the same order
// and holds the same r.
//  - rmsnorm_vec<T, VPL> takes rows of whole 16-byte vectors (D *
//    sizeof(dt) a multiple of 16; x, w and y 16-byte aligned, so every
//    row is): lane l holds vectors l, l + 32, ... (VPL of them, 8 bf16 or
//    4 float32 each) in registers from the sum of squares to the scale,
//    so x is read once, by 16-byte loads, and w by 16-byte loads.  VPL is
//    the smallest instance that holds the row (6, 10, 14 at d_model 1536,
//    2560, 3584 in bf16); the vectors past the row's end are masked.
//  - rmsnorm_loop<T, VEC> takes what the registers do not hold (VEC: rows
//    past RMS_MAX_VPL vectors a lane, 16-byte accesses) and every other
//    width or alignment (scalar accesses, masked by the loop bound): two
//    passes over the row, the second reading x again (from L1).
// ---------------------------------------------------------------------------
constexpr int RMS_WARPS = 8;             // rows a CTA
constexpr int RMS_THREADS = 32 * RMS_WARPS;
constexpr int RMS_MAX_VPL = 32;          // vectors a lane on the register path

// 16 bytes of T unpacked to floats, and floats packed back (rounded to T)
template <typename T> struct Pack16;
template <> struct Pack16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void get(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x); f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z); f[3] = __uint_as_float(v.w);
  }
  static __device__ __forceinline__ uint4 put(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <> struct Pack16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void get(const uint4& v, float* f) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {          // element 2i in the low half
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ uint32_t two(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  static __device__ __forceinline__ uint4 put(const float* f) {
    return make_uint4(two(f[0], f[1]), two(f[2], f[3]), two(f[4], f[5]),
                      two(f[6], f[7]));
  }
};

// dt(x * r) * w on the E floats of one access (rounded to T by the store)
template <typename T, int E>
__device__ __forceinline__ void rms_scale(float* f, const float* g, float r) {
#pragma unroll
  for (int e = 0; e < E; ++e) f[e] = to_f(from_f<T>(f[e] * r)) * g[e];
}

template <typename T, int VPL>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_vec(int R, int V, int D, float eps, const uint4* __restrict__ x,
            const uint4* __restrict__ w, uint4* __restrict__ y) {
  using Pk = Pack16<T>;
  const int row = blockIdx.x * RMS_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;                  // a whole warp: no barrier follows
  const int lane = threadIdx.x & 31;
  const uint4* xr = x + (size_t)row * V;
  uint4 v[VPL];
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < V ? xr[c] : make_uint4(0u, 0u, 0u, 0u);
  }
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    float f[Pk::N];
    Pk::get(v[i], f);
#pragma unroll
    for (int e = 0; e < Pk::N; ++e) ss += f[e] * f[e];
  }
  const float r = rsqrtf(warp_sum(ss) / (float)D + eps);
  uint4* yr = y + (size_t)row * V;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    const int c = lane + 32 * i;
    if (c < V) {
      float f[Pk::N], g[Pk::N];
      Pk::get(v[i], f);
      Pk::get(__ldg(w + c), g);
      rms_scale<T, Pk::N>(f, g, r);
      yr[c] = Pk::put(f);
    }
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(RMS_THREADS)
rmsnorm_loop(int R, int D, float eps, const T* __restrict__ x,
             const T* __restrict__ w, T* __restrict__ y) {
  using Pk = Pack16<T>;
  constexpr int E = VEC ? Pk::N : 1;     // elements an access
  const int row = blockIdx.x * RMS_WARPS + (threadIdx.x >> 5);
  if (row >= R) return;
  const int lane = threadIdx.x & 31;
  const int n = D / E;
  const T* xr = x + (size_t)row * D;
  T* yr = y + (size_t)row * D;
  auto get = [](const T* p, int c, float* f) {
    if constexpr (VEC) Pk::get(reinterpret_cast<const uint4*>(p)[c], f);
    else f[0] = to_f(p[c]);
  };
  float ss = 0.f;
  for (int c = lane; c < n; c += 32) {
    float f[E];
    get(xr, c, f);
#pragma unroll
    for (int e = 0; e < E; ++e) ss += f[e] * f[e];
  }
  const float r = rsqrtf(warp_sum(ss) / (float)D + eps);
  for (int c = lane; c < n; c += 32) {
    float f[E], g[E];
    get(xr, c, f);
    get(w, c, g);
    rms_scale<T, E>(f, g, r);
    if constexpr (VEC) reinterpret_cast<uint4*>(yr)[c] = Pk::put(f);
    else yr[c] = from_f<T>(f[0]);
  }
}

__host__ __device__ inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T>
int launch_rmsnorm(int R, int D, float eps, const void* x, const void* w,
                   void* y, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((R + RMS_WARPS - 1) / RMS_WARPS);
  const bool vec = (size_t)D * sizeof(T) % 16 == 0 && aligned(x, 16) &&
                   aligned(w, 16) && aligned(y, 16);
  if (!vec) {
    rmsnorm_loop<T, false><<<blocks, RMS_THREADS, 0, stream>>>(
        R, D, eps, (const T*)x, (const T*)w, (T*)y);
    return (int)cudaGetLastError();
  }
  const int V = (int)((size_t)D * sizeof(T) / 16);   // vectors a row
  const int need = (V + 31) / 32;                      // vectors a lane
  const uint4 *xv = (const uint4*)x, *wv = (const uint4*)w;
  uint4* yv = (uint4*)y;
  // the smallest register instance that holds the row, else the loop
#define RMS_VEC(n)                                                       \
  if (need <= n)                                                         \
    rmsnorm_vec<T, n><<<blocks, RMS_THREADS, 0, stream>>>(R, V, D, eps,  \
                                                          xv, wv, yv);   \
  else
  RMS_VEC(1) RMS_VEC(2) RMS_VEC(3) RMS_VEC(4) RMS_VEC(6) RMS_VEC(8)
  RMS_VEC(10) RMS_VEC(12) RMS_VEC(14) RMS_VEC(16) RMS_VEC(20) RMS_VEC(24)
  RMS_VEC(28) RMS_VEC(RMS_MAX_VPL)
    rmsnorm_loop<T, true><<<blocks, RMS_THREADS, 0, stream>>>(
        R, D, eps, (const T*)x, (const T*)w, (T*)y);
#undef RMS_VEC
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K15 flash_attention — replaces src/repro/kernels/attention.py
// flash_attention (_attn_kernel, pl.pallas_call at attention.py:92).
//   o[b, i, :] = softmax_j(scale * q[b, i, :] . k[b, j, :]) v[b, j, :],
//   key j masked when j >= Tk, or (causal) when j > i + q_offset.
// The online softmax of the reference: per key block, m_new = max(m,
// rowmax s), p = exp(s - m_new), alpha = exp(m - m_new), l = alpha*l +
// sum p, acc = alpha*acc + p v; finally acc / l (l == 0 -> 1).  Masked
// scores are -1e30, the reference kernel's value.  Unlike the reference
// (whose last key block reads past Tk and carries the padding into p v,
// NaN in interpret mode), keys at index >= Tk are never read: their K and
// V rows are zero in shared memory and their scores masked.
// Bound: at the model's prefill shape (BH = 48, T = 2048, D = 128, causal)
// 51.6 GFLOP against 100.7 MB: operations; at paligemma-3b's text call
// (BH = 16, Tq = 1792 after a 256-position prefix, Tk = 2048, D = 256,
// causal) 33.8 GFLOP against 58.7 MB; at phi3-mini-3.8b's (BH = 128, T =
// 2048, D = 96, causal) 103.1 GFLOP against 201.3 MB.  Head dims 32, 64,
// 96, 112, 128 and 256.
// Two kernels, by dtype:
// bfloat16 runs flash_attention_wgmma on the tensor cores (below);
// float32 runs flash_attention_kernel on the CUDA cores (67 TFLOP/s),
// since TF32 tensor cores keep about three digits and the float32
// tolerance is 1e-5.  Both visit key blocks up to the last one the CTA's
// rows can see (fully masked causal blocks are never loaded) and launch
// the heavy causal blocks (the last query blocks) first.
//
// flash_attention_kernel (float32): one CTA of 16 x 16 threads a
// (head-batch, block of FA_BQ query rows); it loops over blocks of FA_BK
// keys.  Q, the K and V block and P live in shared memory as float32; a
// thread owns FA_BQ/16 rows x (FA_BK/16 score, D/16 output) columns, so
// its rows' running max, normaliser and accumulator stay in registers.
// Pitches: Q's D+4 keeps the two row groups of a warp in different banks,
// K's odd D+1 makes the 16 key rows of a column walk conflict-free.
// ---------------------------------------------------------------------------
constexpr int FA_THREADS = 256;          // 16 x 16
constexpr int FA_BQ = 64;                // query rows a CTA
constexpr int FA_BK = 32;                // keys a step
constexpr int FA_RPT = FA_BQ / 16;       // rows a thread
constexpr int FA_SCT = FA_BK / 16;       // score columns a thread
constexpr float FA_NEG = -1e30f;

template <int D>
constexpr size_t fa_smem_bytes() {
  return sizeof(float) * ((size_t)FA_BQ * (D + 4) + (size_t)FA_BK * (D + 1) +
                          (size_t)FA_BK * D + (size_t)FA_BQ * (FA_BK + 1));
}

template <int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(int BH, int Tq, int Tk, int nqb, int causal,
                       int q_offset, float scale, const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o) {
  constexpr int QP = D + 4, KP = D + 1, VP = D, PP = FA_BK + 1;
  constexpr int OCT = D / 16;            // output columns a thread
  extern __shared__ float smem[];
  float* sq = smem;                      // [FA_BQ][QP]
  float* sk = sq + FA_BQ * QP;           // [FA_BK][KP]
  float* sv = sk + FA_BK * KP;           // [FA_BK][VP]
  float* sp = sv + FA_BK * VP;           // [FA_BQ][PP]

  // query-block-major and last block first: causal blocks near the end of
  // the sequence do the most work, so they start before the light ones
  const int qb = nqb - 1 - (int)(blockIdx.x / BH);
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qb * FA_BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t qbase = (size_t)bh * Tq * D, kbase = (size_t)bh * Tk * D;

  for (int e = tid; e < FA_BQ * D; e += FA_THREADS) {
    const int r = e / D, c = e % D;
    sq[r * QP + c] = (q0 + r < Tq) ? q[qbase + (size_t)(q0 + r) * D + c] : 0.f;
  }

  float m[FA_RPT], l[FA_RPT], acc[FA_RPT][OCT];
#pragma unroll
  for (int i = 0; i < FA_RPT; ++i) {
    m[i] = FA_NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OCT; ++c) acc[i][c] = 0.f;
  }

  // keys the block's rows can see: all, or (causal) up to the last row's
  long long kend = Tk;
  if (causal) {
    const long long last = (long long)q0 + q_offset + FA_BQ;
    if (last < kend) kend = last;
  }
  for (int k0 = 0; k0 < kend; k0 += FA_BK) {
    __syncthreads();                     // the last step's reads are done
    for (int e = tid; e < FA_BK * D; e += FA_THREADS) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < Tk;
      const size_t g = kbase + (size_t)(k0 + r) * D + c;
      sk[r * KP + c] = in ? k[g] : 0.f;
      sv[r * VP + c] = in ? v[g] : 0.f;
    }
    __syncthreads();

    float s[FA_RPT][FA_SCT];
#pragma unroll
    for (int i = 0; i < FA_RPT; ++i)
#pragma unroll
      for (int j = 0; j < FA_SCT; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[FA_RPT], kb[FA_SCT];
#pragma unroll
      for (int i = 0; i < FA_RPT; ++i) qa[i] = sq[(ty * FA_RPT + i) * QP + d];
#pragma unroll
      for (int j = 0; j < FA_SCT; ++j) kb[j] = sk[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < FA_RPT; ++i)
#pragma unroll
        for (int j = 0; j < FA_SCT; ++j) s[i][j] += qa[i] * kb[j];
    }

#pragma unroll
    for (int i = 0; i < FA_RPT; ++i) {
      const long long row = (long long)q0 + ty * FA_RPT + i + q_offset;
      float mx = FA_NEG;
#pragma unroll
      for (int j = 0; j < FA_SCT; ++j) {
        const int col = k0 + tx + 16 * j;
        float val = s[i][j] * scale;
        if (col >= Tk || (causal && col > row)) val = FA_NEG;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      // the row's 16 threads are 16 neighbouring lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < FA_SCT; ++j) {
        const float p = expf(s[i][j] - m_new);
        sp[(ty * FA_RPT + i) * PP + tx + 16 * j] = p;
        ps += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OCT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < FA_BK; ++c) {
      float pa[FA_RPT], vb[OCT];
#pragma unroll
      for (int i = 0; i < FA_RPT; ++i) pa[i] = sp[(ty * FA_RPT + i) * PP + c];
#pragma unroll
      for (int j = 0; j < OCT; ++j) vb[j] = sv[c * VP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < FA_RPT; ++i)
#pragma unroll
        for (int j = 0; j < OCT; ++j) acc[i][j] += pa[i] * vb[j];
    }
  }

#pragma unroll
  for (int i = 0; i < FA_RPT; ++i) {
    const int row = q0 + ty * FA_RPT + i;
    if (row >= Tq) continue;
    const float inv = l[i] == 0.f ? 1.f : l[i];
    float* orow = o + qbase + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < OCT; ++j) orow[tx + 16 * j] = acc[i][j] / inv;
  }
}

template <int D>
int launch_attention(int BH, int Tq, int Tk, int causal, int q_offset,
                     float scale, const void* q, const void* k, const void* v,
                     void* o, cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nqb = (Tq + FA_BQ - 1) / FA_BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<D><<<(unsigned)blocks, FA_THREADS, smem, stream>>>(
      BH, Tq, Tk, nqb, causal, q_offset, scale, (const float*)q,
      (const float*)k, (const float*)v, (float*)o);
  return (int)cudaGetLastError();
}

int attention_f32(int BH, int Tq, int Tk, int D, int causal, int q_offset,
                  float scale, const void* q, const void* k, const void* v,
                  void* o, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_attention<32>(BH, Tq, Tk, causal, q_offset, scale, q, k,
                                  v, o, stream);
    case 64:
      return launch_attention<64>(BH, Tq, Tk, causal, q_offset, scale, q, k,
                                  v, o, stream);
    case 96:    // phi3-mini-3.8b: 58752 bytes of shared memory
      return launch_attention<96>(BH, Tq, Tk, causal, q_offset, scale, q, k,
                                  v, o, stream);
    case 112:   // zamba2-7b: d_model 3584 over 32 heads
      return launch_attention<112>(BH, Tq, Tk, causal, q_offset, scale, q, k,
                                   v, o, stream);
    case 128:
      return launch_attention<128>(BH, Tq, Tk, causal, q_offset, scale, q, k,
                                   v, o, stream);
    case 256:   // paligemma-3b: 140672 bytes of shared memory, a CTA an SM
      return launch_attention<256>(BH, Tq, Tk, causal, q_offset, scale, q, k,
                                   v, o, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// flash_attention_wgmma (bfloat16): the same online softmax on Hopper's
// tensor cores.  One CTA a (head-batch, block of BQ query rows): NWG
// consumer warpgroups of 64 rows each and a producer (FwShape<DP, NWG>, DP
// the padded head dim; the instances below).
//  - The producer's lane 0 issues TMA loads (tensor maps over (D, T, BH),
//    so rows past T and columns past D arrive as zeros and nothing past an
//    input is read) of Q once and of K and V blocks of BK keys into a
//    STAGES-deep ring, each stage with a full and a free mbarrier for K
//    and for V.  Tiles are stored as sub-tiles of SUBC columns in the
//    swizzle that wgmma reads (64 columns in 128-byte rows; 32 columns in
//    64-byte rows at DP 96); head dims 32 and 112 are zero-padded to DP =
//    64 and 128 by the TMA box.
//  - S = Q K^T: wgmma m64n{BK}k16 with both operands in shared memory
//    (K-major), float32 accumulators (BK / 2 a thread).
//  - The softmax runs on those registers in the log2 domain (scale folded
//    with log2 e, ex2.approx); p is rounded once to bfloat16 and packed in
//    place: the accumulator layout of S is the register A-fragment layout
//    of the next wgmma, so P never touches shared memory.  The
//    normaliser sums the float32 p (as FlashAttention and SDPA do).
//  - O += P V: wgmma m64n{DP}k16 (at DP 256 two m64n128k16 halves), A
//    from registers, V read MN-major from its [key][d] tile (no transpose
//    pass).
// Rounding P to bfloat16 moves each weight by at most 2^-9 relative, so
// the output by at most 2^-9 max |v| (PERF.md, the tier-1 test of it).
//
// The instances (DP, NWG):
//  - (64, 2) and (128, 2), head dims 32, 64 and 112, 128: BQ = 128, K/V
//    stages of BK = 128 keys, three stages, a producer warp (288
//    threads).  The two warpgroups take turns issuing S = Q K^T (named
//    barriers 1 and 2), so one's softmax overlaps the other's products.
//  - (96, 2), head dim 96 (phi3-mini-3.8b): the same schedule on
//    32-column sub-tiles in the 64-byte swizzle (TMA boxes of 32
//    columns), so S takes six k16 steps and O += P V one m64n96k16, 3/4
//    of the products of head dim 96 zero-padded through (128, 2), which
//    it beats (PERF.md §6); 24 KB of Q, 144 KB of K and V.
//  - (256, 1), head dim 256 (paligemma-3b) on grids under one wave of
//    (256, 2)'s CTAs (its prefix call): the DP 128 shape does not fit the
//    SM at DP 256 (64 KB of Q, 448 KB of 128-key stages, 128 O registers
//    a thread against the 227 a thread of 288 may hold).  One consumer
//    warpgroup of 64 query rows (160 threads, so up to 255 registers a
//    thread: O's 128, S's 32, P's 16 packed), stages of BK = 64 keys (S
//    on m64n64k16, K's 256 columns as 16 k-steps over four sub-tiles),
//    three stages: 32 KB of Q and 192 KB of K and V, 225 KB with the
//    barriers and the alignment pad.  Its softmax does not overlap its
//    own products.
//  - (256, 2), head dim 256 on larger grids: two consumer warpgroups (BQ
//    = 128) and a producer warpgroup, 384 threads.  At that launch bound a
//    thread may hold 168 registers; the producer keeps 24 (setmaxnreg.dec)
//    and the consumers take 240 (setmaxnreg.inc): 128 * 24 + 256 * 240 =
//    64512 of the SM's 65536.  64 KB of Q and two stages of 64 keys (128
//    KB), 193 KB.  Ping-pong in FlashAttention-3's order (fw_section): in
//    its turn (named barriers 1 and 2) a warpgroup issues S = Q K^T of
//    block n and O += P V of block n - 1, then runs block n's softmax
//    while its P V and the other warpgroup's products hold the tensor
//    cores.  A K and V block serves 128 query rows, so a product reads
//    half the shared-memory and L2 bytes of the (256, 1) instance's.
//    Measured against the alternatives (PERF.md §6): a section that waits
//    for both products before the softmax, stages of 80 keys, and no
//    turns are each slower; so is this schedule at head dim 96, and two
//    warpgroups splitting the key blocks of 64 rows on small grids.
// ---------------------------------------------------------------------------
constexpr float LOG2E = 1.4426950408889634f;

template <int DP, int NWG>               // padded head dim, warpgroups
struct FwShape {
  static constexpr int SUBC = DP == 96 ? 32 : 64;  // columns a sub-tile
  static constexpr int ROW = 2 * SUBC;   // a sub-tile row's bytes (its swizzle)
  static constexpr int NSUB = DP / SUBC;
  static constexpr bool PINGPONG = DP == 256 && NWG == 2;
  static constexpr int BQ = 64 * NWG;              // query rows a CTA
  static constexpr int BK = DP <= 128 ? 128 : 64;  // keys a ring stage
  static constexpr int STAGES = PINGPONG ? 2 : 3;
  static constexpr int PRODUCER = PINGPONG ? 128 : 32;   // its threads
  static constexpr int THREADS = 128 * NWG + PRODUCER;
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;  // setmaxnreg
};
static_assert(128 * FwShape<256, 2>::PRODUCER_REGS +
                  256 * FwShape<256, 2>::CONSUMER_REGS <= 65536,
              "K15 (256, 2) past the SM's registers");

template <int DP, int NWG>
struct FwLayout {
  using S = FwShape<DP, NWG>;
  static constexpr uint32_t Q_BYTES = S::BQ * DP * 2;
  static constexpr uint32_t KV_BYTES = S::BK * DP * 2;
  static constexpr size_t K_OFF = Q_BYTES;
  static constexpr size_t V_OFF = K_OFF + (size_t)S::STAGES * KV_BYTES;
  static constexpr size_t BAR_OFF = V_OFF + (size_t)S::STAGES * KV_BYTES;
  // q_full, then k_full, v_full, k_free, v_free a stage; + 1024 to align
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 4 * S::STAGES) + 1024;
};
static_assert(FwLayout<128, 2>::BYTES <= 232448, "K15 (128, 2) past 227 KB");
static_assert(FwLayout<256, 1>::BYTES <= 232448, "K15 (256, 1) past 227 KB");
static_assert(FwLayout<256, 2>::BYTES <= 232448, "K15 (256, 2) past 227 KB");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
               ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int c0, int c1,
                                          int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// a wgmma shared-memory matrix descriptor for sub-tiles of ROW-byte rows
// in the ROW-byte swizzle (128 or 64); offsets in bytes (LBO: between
// swizzle atoms along M/N for MN-major operands, unused for K-major ones;
// SBO: between 8-row groups)
template <int ROW>
__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  static_assert(ROW == 128 || ROW == 64, "a 128- or 64-byte swizzle");
  constexpr uint64_t layout = ROW == 128 ? 1 : 2;
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (layout << 62);
}

// a warpgroup's registers a thread, set for the rest of the kernel (all
// four warps execute it; sm_90a)
template <int N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// until at most the last committed group is in flight
__device__ __forceinline__ void wg_wait_but_last() {
  asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
}
// keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous instruction and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// the same for a register A operand, which wgmma reads asynchronously: it
// keeps the registers from other use until the product is waited for
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x on the special-function unit (max relative error 2^-22, far below
// the bf16 rounding of p that follows); 2^-huge = 0
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the wgmma shapes K15 issues: S = Q K^T (both operands in shared memory,
// K-major; accumulate = 0 overwrites d; n128, or n64 at DP 256) and O +=
// P V (P from registers, V MN-major; n64, n96 or n128), float32
// accumulators in the fragment layout
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n96(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q K^T for one k-step over a K stage of BK keys
template <int BK>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t da, uint64_t db,
                                         int accumulate) {
  if constexpr (BK == 128) wgmma_ss_n128(d, da, db, accumulate);
  else wgmma_ss_n64(d, da, db, accumulate);
}

// O += P V for one k-step of 16 keys; v points at the step's first key
// row of sub-tile 0, the sub-tiles (64 columns, or 32 at DP 96) BK rows
// apart
template <int DP, int BK>
__device__ __forceinline__ void wgmma_pv(float* d, const uint32_t* a,
                                         const uint8_t* v) {
  constexpr uint32_t ROW = DP == 96 ? 64 : 128, LBO = BK * ROW, SBO = 8 * ROW;
  if constexpr (DP == 256) {
    wgmma_rs_n128(d, a, gmma_desc<ROW>(v, LBO, SBO));
    wgmma_rs_n128(d + 64, a, gmma_desc<ROW>(v + 2 * LBO, LBO, SBO));
  } else if constexpr (DP == 128) {
    wgmma_rs_n128(d, a, gmma_desc<ROW>(v, LBO, SBO));
  } else if constexpr (DP == 96) {
    wgmma_rs_n96(d, a, gmma_desc<ROW>(v, LBO, SBO));
  } else {
    wgmma_rs_n64(d, a, gmma_desc<ROW>(v, LBO, SBO));
  }
}

// what a consumer's softmax needs to know of its rows and the call
struct FwRows {
  int Tk, causal, q_offset;
  int first_row;                         // the warpgroup's lowest, + q_offset
  int row0, cq;                          // this thread's row and column pair
  float scale_log2;
};

// key block n's scores in sc: scale, mask, the running max (a row's BK / 4
// scores in a thread, its four threads neighbouring lanes), p = 2^(s - m)
// in place (float32), the normaliser, and alpha, the rows' rescale of O
template <int BK>
__device__ __forceinline__ void fw_scores(float* sc, float* alpha,
                                          float* m_run, float* l_run, int n,
                                          const FwRows& r) {
  const int key0 = n * BK;
  const bool edge = key0 + BK > r.Tk ||
                    (r.causal && (long long)key0 + BK - 1 > r.first_row);
  float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float val = sc[4 * j + e] * r.scale_log2;
      if (edge) {
        const int col = key0 + 8 * j + r.cq + (e & 1);
        const long long row = (long long)r.row0 + 8 * (e >> 1) + r.q_offset;
        if (col >= r.Tk || (r.causal && col > row)) val = FA_NEG;
      }
      sc[4 * j + e] = val;
      mx[e >> 1] = fmaxf(mx[e >> 1], val);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_run[i], mx[i]);
    alpha[i] = exp2_approx(m_run[i] - m_new);
    m_run[i] = m_new;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = exp2_approx(sc[4 * j + e] - m_run[e >> 1]);
      ps[e >> 1] += sc[4 * j + e];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + ps[i];
}

// p rounded to bf16 and packed as the A fragments of P V: k-step kk's
// registers are (row r, keys 16 kk + cq..), (r + 8, same), (r, keys 16 kk
// + 8 + cq..), (r + 8, same) = accumulators 8 kk .. 8 kk + 7
template <int BK>
__device__ __forceinline__ void fw_pack(const float* sc, uint32_t (*pa)[4]) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      pa[j >> 1][(j & 1) * 2 + i] =
          pack_bf16(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]);
}

// one ping-pong section of a consumer warpgroup (the (256, 2) instance),
// in FlashAttention-3's order: in its turn, S = Q K^T of block n (QK),
// then O rescaled by block n - 1's alpha and O += P V of block n - 1 (PV);
// the turn handed over; block n's softmax while P V runs; block n's P
// packed once P V is done
template <int DP, int NWG, bool PV, bool QK>
__device__ __forceinline__ void fw_section(
    int n, int wg, int lane, const uint8_t* sq, const uint8_t* sk,
    const uint8_t* sv, uint64_t* k_full, uint64_t* v_full, uint64_t* k_free,
    uint64_t* v_free, float* oacc, uint32_t (*pa)[4], float* alpha,
    float* m_run, float* l_run, const FwRows& rows) {
  using L = FwLayout<DP, NWG>;
  using S = FwShape<DP, NWG>;
  constexpr int BQ = S::BQ, BK = S::BK, STAGES = S::STAGES, ROW = S::ROW;
  constexpr int KPS = S::SUBC / 16;
  const int s = n % STAGES, sp = (n + STAGES - 1) % STAGES;
  float sc[BK / 2];
  if constexpr (QK) mbar_wait(k_full + s, (n / STAGES) & 1);
  if constexpr (PV) mbar_wait(v_full + sp, ((n - 1) / STAGES) & 1);
  bar_sync(1 + wg, 256);
  if constexpr (QK) {
    const uint8_t* ks = sk + s * L::KV_BYTES;
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int sub = kk / KPS, off = (kk % KPS) * 32;
      wgmma_qk<BK>(sc,
                   gmma_desc<ROW>(sq + sub * BQ * ROW + wg * 64 * ROW + off,
                                  16, 8 * ROW),
                   gmma_desc<ROW>(ks + sub * BK * ROW + off, 16, 8 * ROW),
                   kk > 0);
    }
    wg_commit();
  }
  if constexpr (PV) {
    const uint8_t* vs = sv + sp * L::KV_BYTES;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= alpha[e >> 1];
    fence_regs<DP / 2>(oacc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_pv<DP, BK>(oacc, pa[kk], vs + kk * 16 * ROW);
    wg_commit();
  }
  if (wg == 0 || QK) bar_arrive(2 - wg, 256);
  if constexpr (QK) {
    if constexpr (PV) wg_wait_but_last();
    else wg_wait_all();
    fence_regs<BK / 2>(sc);
    __syncwarp();
    if (lane == 0) mbar_arrive(k_free + s);
    fw_scores<BK>(sc, alpha, m_run, l_run, n, rows);
  }
  if constexpr (PV) {
    wg_wait_all();
    fence_regs<DP / 2>(oacc);
    fence_regs<BK / 4>(&pa[0][0]);
    __syncwarp();
    if (lane == 0) mbar_arrive(v_free + sp);
  }
  if constexpr (QK) fw_pack<BK>(sc, pa);
}

template <int DP, int NWG>
__global__ void __launch_bounds__(FwShape<DP, NWG>::THREADS, 1)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, int BH, int Tq,
                      int Tk, int D, int nqb, int causal, int q_offset,
                      float scale_log2, __nv_bfloat16* __restrict__ o) {
  using L = FwLayout<DP, NWG>;
  using S = FwShape<DP, NWG>;
  constexpr int BQ = S::BQ, BK = S::BK, STAGES = S::STAGES, ROW = S::ROW;
  constexpr int KPS = S::SUBC / 16;      // k16 steps a sub-tile
  extern __shared__ uint8_t fw_raw[];
  uint8_t* sm = fw_raw + ((1024u - (smem_u32(fw_raw) & 1023u)) & 1023u);
  uint8_t* sq = sm;
  uint8_t* sk = sm + L::K_OFF;
  uint8_t* sv = sm + L::V_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sm + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* k_free = v_full + STAGES;
  uint64_t* v_free = k_free + STAGES;

  const int qb = nqb - 1 - (int)(blockIdx.x / BH);   // heavy blocks first
  const int bh = (int)(blockIdx.x % BH);
  const int q0 = qb * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long kend = Tk;
  if (causal) {
    const long long last = (long long)q0 + q_offset + BQ;
    if (last < kend) kend = last;
  }
  const int nkb = (int)((kend + BK - 1) / BK);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(k_free + s, 4 * NWG);    // lane 0 of each consumer warp
      mbar_init(v_free + s, 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NWG) {                 // the producer (a warp or a group)
    if constexpr (S::PINGPONG) regs_dec<S::PRODUCER_REGS>();
    if (warp == 4 * NWG && lane == 0) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < S::NSUB; ++c)
        tma_load3(sq + c * BQ * ROW, &tmq, q_full, S::SUBC * c, q0, bh);
      for (int n = 0; n < nkb; ++n) {
        const int s = n % STAGES, par = ((n / STAGES) & 1) ^ 1;
        mbar_wait(k_free + s, par);
        mbar_expect_tx(k_full + s, L::KV_BYTES);
        for (int c = 0; c < S::NSUB; ++c)
          tma_load3(sk + s * L::KV_BYTES + c * BK * ROW, &tmk, k_full + s,
                    S::SUBC * c, n * BK, bh);
        mbar_wait(v_free + s, par);
        mbar_expect_tx(v_full + s, L::KV_BYTES);
        for (int c = 0; c < S::NSUB; ++c)
          tma_load3(sv + s * L::KV_BYTES + c * BK * ROW, &tmv, v_full + s,
                    S::SUBC * c, n * BK, bh);
      }
    }
    return;
  }
  if constexpr (S::PINGPONG) regs_inc<S::CONSUMER_REGS>();

  // a consumer: warpgroup wg's 64 rows; this thread holds rows r and r + 8
  // (accumulator layout: row 16 * warp + lane / 4, columns 8 j + 2 (lane
  // % 4) + {0, 1})
  const int wg = warp >> 2;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const int first_row = q0 + wg * 64 + q_offset;   // the group's lowest
  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  float m_run[2] = {FA_NEG, FA_NEG}, l_run[2] = {0.f, 0.f};
  if constexpr (!S::PINGPONG) {
    if constexpr (NWG == 2) {
      if (wg == 1) bar_arrive(1, 256);   // warpgroup 0 issues first
    }
    mbar_wait(q_full, 0);
    for (int n = 0; n < nkb; ++n) {
      const int s = n % STAGES, par = (n / STAGES) & 1;
      const uint8_t* ks = sk + s * L::KV_BYTES;
      const uint8_t* vs = sv + s * L::KV_BYTES;
      float sc[BK / 2];
      mbar_wait(k_full + s, par);
      if constexpr (NWG == 2) bar_sync(1 + wg, 256);   // this group's turn
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int sub = kk / KPS, off = (kk % KPS) * 32;
        wgmma_qk<BK>(sc,
                     gmma_desc<ROW>(sq + sub * BQ * ROW + wg * 64 * ROW + off,
                                    16, 8 * ROW),
                     gmma_desc<ROW>(ks + sub * BK * ROW + off, 16, 8 * ROW),
                     kk > 0);
      }
      wg_commit();
      if constexpr (NWG == 2) {          // the other group's turn
        if (wg == 0 || n + 1 < nkb) bar_arrive(2 - wg, 256);
      }
      wg_wait_all();
      fence_regs<BK / 2>(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(k_free + s);

      // scale, mask, running max (a row's BK / 4 scores in a thread, its
      // four threads neighbouring lanes)
      const int key0 = n * BK;
      const bool edge = key0 + BK > Tk ||
                        (causal && (long long)key0 + BK - 1 > first_row);
      float mx[2] = {FA_NEG, FA_NEG};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float val = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int col = key0 + 8 * j + cq + (e & 1);
            const long long row = (long long)row0 + 8 * (e >> 1) + q_offset;
            if (col >= Tk || (causal && col > row)) val = FA_NEG;
          }
          sc[4 * j + e] = val;
          mx[e >> 1] = fmaxf(mx[e >> 1], val);
        }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        const float m_new = fmaxf(m_run[i], mx[i]);
        alpha[i] = exp2_approx(m_run[i] - m_new);
        m_run[i] = m_new;
      }
      // p rounded to bf16, packed as the A fragments of P V: k-step kk's
      // registers are (row r, keys 16 kk + cq..), (r + 8, same), (r, keys
      // 16 kk + 8 + cq..), (r + 8, same) = accumulators 8 kk .. 8 kk + 7
      uint32_t pa[BK / 16][4];
      float ps[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float p0 = exp2_approx(sc[4 * j + 2 * i] - m_run[i]);
          const float p1 = exp2_approx(sc[4 * j + 2 * i + 1] - m_run[i]);
          ps[i] += p0 + p1;
          pa[j >> 1][(j & 1) * 2 + i] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int i = 0; i < 2; ++i) l_run[i] = alpha[i] * l_run[i] + ps[i];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[4 * j + e] *= alpha[e >> 1];

      mbar_wait(v_full + s, par);
      fence_regs<DP / 2>(oacc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<DP, BK>(oacc, pa[kk], vs + kk * 16 * ROW);
      wg_commit();
      wg_wait_all();
      fence_regs<DP / 2>(oacc);
      __syncwarp();
      if (lane == 0) mbar_arrive(v_free + s);
    }
  } else {
    // ping-pong: section n issues S of block n (up to nkb - 1) and P V of
    // block n - 1 (from n = 1) in this group's turn and hands the turn
    // over (warpgroup 1 not after its last section: warpgroup 0 has none
    // left)
    const FwRows rows{Tk, causal, q_offset, first_row, row0, cq, scale_log2};
    uint32_t pa[BK / 16][4];             // P, bf16: the A fragments of P V
    float alpha[2];                      // O's rescale by the last softmax
    if (wg == 1) bar_arrive(1, 256);     // warpgroup 0 issues first
    mbar_wait(q_full, 0);
    fw_section<DP, NWG, false, true>(0, wg, lane, sq, sk, sv, k_full,
                                     v_full, k_free, v_free, oacc, pa, alpha,
                                     m_run, l_run, rows);
    for (int n = 1; n < nkb; ++n)
      fw_section<DP, NWG, true, true>(n, wg, lane, sq, sk, sv, k_full,
                                      v_full, k_free, v_free, oacc, pa,
                                      alpha, m_run, l_run, rows);
    fw_section<DP, NWG, true, false>(nkb, wg, lane, sq, sk, sv, k_full,
                                     v_full, k_free, v_free, oacc, pa, alpha,
                                     m_run, l_run, rows);
  }

  // the row's normaliser: its four threads' partial sums
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l_run[i] = l == 0.f ? 1.f : l;
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= Tq) continue;
    __nv_bfloat16* orow = o + ((size_t)bh * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
            oacc[4 * j + 2 * i] / l_run[i], oacc[4 * j + 2 * i + 1] / l_run[i]);
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point
// query, so nothing links libcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a (D, T, BH) bfloat16 tensor, boxes of `cols` columns x `rows` rows in
// the swizzle of their row (128 bytes at 64 columns, 64 at 32)
int head_map(CUtensorMap* map, const void* base, int D, int T, int BH,
             int rows, int cols) {
  const EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                         const_cast<void*>(base), dims, strides, box, unit,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                    : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int DP, int NWG>
int launch_attention_wgmma(int BH, int Tq, int Tk, int D, int causal,
                           int q_offset, float scale, const void* q,
                           const void* k, const void* v, void* o,
                           cudaStream_t stream) {
  using S = FwShape<DP, NWG>;
  constexpr size_t smem = FwLayout<DP, NWG>::BYTES;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma<DP, NWG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap mq, mk, mv;
  int err = head_map(&mq, q, D, Tq, BH, S::BQ, S::SUBC);
  if (!err) err = head_map(&mk, k, D, Tk, BH, S::BK, S::SUBC);
  if (!err) err = head_map(&mv, v, D, Tk, BH, S::BK, S::SUBC);
  if (err) return err;
  const int nqb = (Tq + S::BQ - 1) / S::BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_attention_wgmma<DP, NWG><<<(unsigned)blocks, S::THREADS, smem,
                                   stream>>>(
      mq, mk, mv, BH, Tq, Tk, D, nqb, causal, q_offset, scale * LOG2E,
      (__nv_bfloat16*)o);
  return (int)cudaGetLastError();
}

// the bf16 instance a call names (kernels/attention.py INSTANCES): head
// dim 256 has two and takes no default; the others one
enum FwInstance {
  FW_DEFAULT = 0,   // the head dim's only instance
  FW_ONE_WG = 1,    // head dim 256 on (256, 1)
  FW_TWO_WG = 2,    // head dim 256 on (256, 2)
};

int attention_bf16(int BH, int Tq, int Tk, int D, int instance, int causal,
                   int q_offset, float scale, const void* q, const void* k,
                   const void* v, void* o, cudaStream_t stream) {
#define FW_LAUNCH(DP, NWG)                                                  \
  launch_attention_wgmma<DP, NWG>(BH, Tq, Tk, D, causal, q_offset, scale, q, \
                                  k, v, o, stream)
  switch (D) {
    case 32:
    case 64:
      if (instance == FW_DEFAULT) return FW_LAUNCH(64, 2);
      break;
    case 96:    // phi3-mini-3.8b: d_model 3072 over 32 heads
      if (instance == FW_DEFAULT) return FW_LAUNCH(96, 2);
      break;
    case 112:   // zamba2-7b: d_model 3584 over 32 heads
    case 128:
      if (instance == FW_DEFAULT) return FW_LAUNCH(128, 2);
      break;
    case 256:   // paligemma-3b
      if (instance == FW_ONE_WG) return FW_LAUNCH(256, 1);
      if (instance == FW_TWO_WG) return FW_LAUNCH(256, 2);
      break;
  }
#undef FW_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The recurrences K17 and K18.  The reference's Pallas grid is (rows,
// T/C) with the chunk axis sequential and the state carried across chunks
// in VMEM scratch.  Here both run chunked, so that the chunks of a row run
// on many SMs at once: each chunk's own state, then the states passed
// from chunk to chunk, then each chunk's outputs from the state entering
// it; three kernels behind one C entry (one counted launch a call), in a
// float32 scratch the wrapper allocates.  The state dimension is padded to
// KP in {16, 32, 64, 128} with zeros: a zero k, r, w and u keep the padded
// state zero and out of every sum.  Steps at t >= T are neither read nor
// written.
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;"
               ::: "memory");
}

// `kernel` (a function pointer: no template commas in the macro's
// arguments) on `grid` x `threads` with `smem` dynamic shared bytes.  A
// macro so that the K17 span below also builds with g++ against
// tests/cuda_emu.h, which runs a launch's blocks on the CPU.
#define KERNEL_LAUNCH(kernel, grid, threads, smem, stream, ...) \
  kernel<<<grid, threads, smem, stream>>>(__VA_ARGS__)

// ==== K17 span: tests/test_torch_transformer_kernels.py builds from here
__device__ __forceinline__ float4 ld4(const float* p, int i) {
  return *reinterpret_cast<const float4*>(p + i);
}

// the state dimension's register pad: 16, 32, 64 or 128 (0: too large)
inline int state_pad(int n) {
  return n <= 16 ? 16 : n <= 32 ? 32 : n <= 64 ? 64 : n <= 128 ? 128 : 0;
}

template <typename F>
int set_smem(F* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---------------------------------------------------------------------------
// K17 wkv6 — replaces src/repro/kernels/rwkv6.py wkv6 (_wkv6_kernel,
// pl.pallas_call at rwkv6.py:65).  Per row (b, h) of BH, state S (K, V)
// from zero:
//   o_t[v] = sum_k r_t[k] (S[k, v] + u[k] k_t[k] v_t[v])
//   S[k, v] <- w_t[k] S[k, v] + k_t[k] v_t[v]
// r, k, w: (BH, T, K); v, o: (BH, T, V); u: (BH, K).  Time in chunks of
// WKV_C steps, nc = ceil(T / WKV_C):
//  1. wkv6_chunk_state, grid (BH, nc - 1, V blocks): each chunk with a
//     successor (all of them full) runs the exact rank-1 update from zero,
//     giving its own end state L_c, and keeps its decay product D_c[k] =
//     prod_t w_t[k] as a running product: L to scratch slot c of (BH,
//     nc - 1, K, V), D after them in (BH, nc - 1, K).
//  2. wkv6_state_passing, grid (BH, tiles of K * V): in place, slot c <-
//     D_c * slot (c - 1) + slot c for c = 1 .. nc - 2, so that slot c is
//     the state entering chunk c + 1.
//  3. wkv6_chunk_scan, grid (BH, nc, V blocks): from the state entering
//     its chunk (zero for the first), the exact recurrence over the chunk,
//     writing o, rounded once to the input's dtype.
// No ratio of decay products and no log-space sum (the reference's
// "exact, no decay-ratio reformulation"): products are only multiplied
// forward, each shrinking toward its true value, so an underflow to 0 is
// the right answer and w = 0 or w = 1 needs no special case.
// Threads: WKV_VB state columns a CTA, four threads a column.  Quarter q
// holds rows 4q + 16m + e (m < KP / 16, e < 4) in registers, so that a
// quarter-warp's float4 reads of a step's r, k and w fall in distinct
// banks; the r-weighted sum is closed by two xor shuffles.  r, k, w and
// the block's v are staged WKV_SUB steps at a time by 16-byte cp.async
// where their rows are whole 16-byte vectors (else by plain loads),
// double-buffered: the next stage lands while this one is computed; a
// bf16 stage is widened once to float32 in a third buffer.
// The state stays float32 on the CUDA cores for both dtypes: a state
// rounded to bf16 fails chip_smoke 10b's float32 logits gate (its
// control), and TF32's 10-bit products would too, so no tensor cores.
// Bound: ~7 fp32 operations per state element per step against 2-byte
// inputs read once: operations (0.035 ms at rwkv6-3b's forward); the
// scratch (written, read and written, read) is the design's own traffic.
// ---------------------------------------------------------------------------
constexpr int WKV_C = 64;                // steps a chunk
constexpr int WKV_SUB = 16;              // steps a stage
constexpr int WKV_VB = 32;               // state columns a CTA
constexpr int WKV_THREADS = 4 * WKV_VB;  // four a column
constexpr int WKV_PASS_THREADS = 256;

// a stage in elements: r, k and w [WKV_SUB][KP] each, v [WKV_SUB][WKV_VB]
template <int KP>
__host__ __device__ constexpr int wkv_stage_elems() {
  return WKV_SUB * (3 * KP + WKV_VB);
}
// shared bytes: two stages as staged (T), and for bf16 one widened stage
template <typename T, int KP>
__host__ __device__ constexpr size_t wkv_smem() {
  return (size_t)wkv_stage_elems<KP>() *
         (2 * sizeof(T) + (sizeof(T) == 4 ? 0 : sizeof(float)));
}

// Steps t0 .. t0 + steps - 1 of row `row` into stage `dst`: r, k and w's
// rows of K at pitch KP, v's columns c0 .. c0 + WKV_VB - 1 before V.  By
// 16-byte cp.async where `kvec` (r, k, w) or `vvec` (v) holds (whole
// 16-byte rows, 16-byte aligned bases), else by plain loads.  What lies
// past K or V is never written (zero since the kernel's start).
template <typename T, int KP>
__device__ __forceinline__ void wkv_stage(
    T* dst, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ w, const T* __restrict__ v, int row, int Tn, int K,
    int V, int c0, int t0, int steps, bool kvec, bool vvec) {
  constexpr int E = 16 / sizeof(T);
  const size_t kb = ((size_t)row * Tn + t0) * K;
  const int per = kvec ? K / E : K, n = steps * per;
  for (int e = threadIdx.x; e < 3 * n; e += WKV_THREADS) {
    const int a = e / n, j = (e % n) / per, i = (e % per) * (kvec ? E : 1);
    const T* src = (a == 0 ? r : a == 1 ? k : w) + kb + (size_t)j * K + i;
    T* to = dst + (a * WKV_SUB + j) * KP + i;
    if (kvec) cp_async16(to, src);
    else *to = *src;
  }
  T* dv = dst + 3 * WKV_SUB * KP;
  const T* vs = v + ((size_t)row * Tn + t0) * V + c0;
  const int cols = min(WKV_VB, V - c0);
  const int vper = vvec ? cols / E : cols, vn = steps * vper;
  for (int e = threadIdx.x; e < vn; e += WKV_THREADS) {
    const int j = e / vper, i = (e % vper) * (vvec ? E : 1);
    if (vvec) cp_async16(dv + j * WKV_VB + i, vs + (size_t)j * V + i);
    else dv[j * WKV_VB + i] = vs[(size_t)j * V + i];
  }
}

// The exact recurrence over steps t_begin .. t_end - 1 of row `row` for
// the thread's column (c0 + tid / 4) and quarter (tid % 4), from the state
// rows S (4q + 16m + e at S[4m + e]) in its registers.  SCAN: with the
// bonus u (uu, in the same order), writing o.  Else the update alone, and
// thread tid < K keeps the decay product of row tid in `decay`.
template <typename T, int KP, bool SCAN>
__device__ __forceinline__ void wkv_sweep(
    unsigned char* smem, float (&S)[KP / 4], const float (&uu)[KP / 4],
    float& decay, const T* __restrict__ r, const T* __restrict__ k,
    const T* __restrict__ w, const T* __restrict__ v, T* __restrict__ o,
    int row, int Tn, int K, int V, int c0, int t_begin, int t_end, bool kvec,
    bool vvec) {
  constexpr int SE = wkv_stage_elems<KP>();
  T* raw0 = reinterpret_cast<T*>(smem);
  T* raw1 = raw0 + SE;
  float* wide = reinterpret_cast<float*>(raw1 + SE);  // bf16 only
  const int tid = threadIdx.x, q = tid & 3, cl = tid >> 2;
  const bool live = c0 + cl < V;
  for (int i = tid; i < (int)(wkv_smem<T, KP>() / 16); i += WKV_THREADS)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();                       // pads zero before any copy lands
  const int stages = (t_end - t_begin + WKV_SUB - 1) / WKV_SUB;
  wkv_stage<T, KP>(raw0, r, k, w, v, row, Tn, K, V, c0, t_begin,
                   min(WKV_SUB, t_end - t_begin), kvec, vvec);
  for (int g = 0; g < stages; ++g) {
    const int t0 = t_begin + g * WKV_SUB, steps = min(WKV_SUB, t_end - t0);
    T* raw = g & 1 ? raw1 : raw0;
    cp_async_wait_all();
    __syncthreads();                     // stage g landed, g - 1 consumed
    const float* cur;
    if constexpr (sizeof(T) == 4) {
      cur = reinterpret_cast<const float*>(raw);
    } else {
      for (int i = tid; i < SE; i += WKV_THREADS) wide[i] = to_f(raw[i]);
      cur = wide;
    }
    if (g + 1 < stages)                  // lands during this stage's steps
      wkv_stage<T, KP>(g & 1 ? raw0 : raw1, r, k, w, v, row, Tn, K, V, c0,
                       t0 + WKV_SUB, min(WKV_SUB, t_end - t0 - WKV_SUB),
                       kvec, vvec);
    if constexpr (sizeof(T) != 4) __syncthreads();  // widened
    const float* cr = cur;
    const float* ck = cr + WKV_SUB * KP;
    const float* cw = ck + WKV_SUB * KP;
    const float* cv = cw + WKV_SUB * KP;
    if (!SCAN && tid < K)
      for (int j = 0; j < steps; ++j) decay *= cw[j * KP + tid];
    for (int j = 0; j < steps; ++j) {
      const float vt = cv[j * WKV_VB + cl];
      const float* rj = cr + j * KP + 4 * q;
      const float* kj = ck + j * KP + 4 * q;
      const float* wj = cw + j * KP + 4 * q;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int m = 0; m < KP / 16; ++m) {
        const float4 k4 = ld4(kj, 16 * m), w4 = ld4(wj, 16 * m);
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        if constexpr (SCAN) {
          const float4 r4 = ld4(rj, 16 * m);
          const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float kv = kk[e] * vt;
            acc[e] += rr[e] * (S[4 * m + e] + uu[4 * m + e] * kv);
            S[4 * m + e] = ww[e] * S[4 * m + e] + kv;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            S[4 * m + e] = ww[e] * S[4 * m + e] + kk[e] * vt;
        }
      }
      if constexpr (SCAN) {
        float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if (q == 0 && live)
          o[((size_t)row * Tn + t0 + j) * V + c0 + cl] = from_f<T>(sum);
      }
    }
  }
}

// 1. L_c and D_c of chunk blockIdx.y (< nc - 1) of row blockIdx.x.
template <typename T, int KP>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_chunk_state(int Tn, int K, int V, int nc, bool kvec, bool vvec,
                 const T* __restrict__ r, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ w,
                 float* __restrict__ states, float* __restrict__ decays) {
  extern __shared__ __align__(16) unsigned char wkv_raw[];
  const int row = blockIdx.x, chunk = blockIdx.y;
  const int c0 = blockIdx.z * WKV_VB, tid = threadIdx.x, q = tid & 3;
  const int col = c0 + (tid >> 2);
  float S[KP / 4], none[KP / 4], decay = 1.f;
#pragma unroll
  for (int s = 0; s < KP / 4; ++s) S[s] = none[s] = 0.f;
  wkv_sweep<T, KP, false>(wkv_raw, S, none, decay, r, k, w, v, nullptr, row,
                          Tn, K, V, c0, chunk * WKV_C, (chunk + 1) * WKV_C,
                          kvec, vvec);
  const size_t slot = (size_t)row * (nc - 1) + chunk;
  if (col < V) {
    float* L = states + slot * K * V + col;
#pragma unroll
    for (int m = 0; m < KP / 16; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + 16 * m + e;
        if (i < K) L[(size_t)i * V] = S[4 * m + e];
      }
  }
  if (blockIdx.z == 0 && tid < K) decays[slot * K + tid] = decay;
}

// 2. In place over slots 1 .. nc - 2 of row blockIdx.x: slot c <- D_c *
// slot (c - 1) + slot c.  A thread walks VEC state elements of one row k;
// the next slot's load is issued before this one's update.
template <int VEC>
__global__ void __launch_bounds__(WKV_PASS_THREADS)
wkv6_state_passing(int K, int V, int nc, float* __restrict__ states,
                   const float* __restrict__ decays) {
  const int kv = K * V;
  const int e = (blockIdx.y * WKV_PASS_THREADS + threadIdx.x) * VEC;
  if (e >= kv) return;
  const int full = nc - 1;
  float* s = states + (size_t)blockIdx.x * full * kv + e;
  const float* d = decays + (size_t)blockIdx.x * full * K + e / V;
  float run[VEC], nxt[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) run[i] = s[i];
  if (full > 1)
#pragma unroll
    for (int i = 0; i < VEC; ++i) nxt[i] = s[kv + i];
  for (int c = 1; c < full; ++c) {
    float cur[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) cur[i] = nxt[i];
    if (c + 1 < full)
#pragma unroll
      for (int i = 0; i < VEC; ++i) nxt[i] = s[(size_t)(c + 1) * kv + i];
    const float dc = d[(size_t)c * K];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      run[i] = fmaf(dc, run[i], cur[i]);
      s[(size_t)c * kv + i] = run[i];
    }
  }
}

// 3. o over chunk blockIdx.y of row blockIdx.x, from the state entering it.
template <typename T, int KP>
__global__ void __launch_bounds__(WKV_THREADS)
wkv6_chunk_scan(int Tn, int K, int V, int nc, bool kvec, bool vvec,
                const T* __restrict__ r, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ w,
                const T* __restrict__ u, const float* __restrict__ states,
                T* __restrict__ o) {
  extern __shared__ __align__(16) unsigned char wkv_raw[];
  const int row = blockIdx.x, chunk = blockIdx.y;
  const int c0 = blockIdx.z * WKV_VB, tid = threadIdx.x, q = tid & 3;
  const int col = c0 + (tid >> 2);
  const float* H = chunk > 0 && col < V
                       ? states + ((size_t)row * (nc - 1) + chunk - 1) * K *
                                      V + col
                       : nullptr;
  float S[KP / 4], uu[KP / 4], unused = 1.f;
#pragma unroll
  for (int m = 0; m < KP / 16; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * q + 16 * m + e;
      uu[4 * m + e] = i < K ? to_f(u[(size_t)row * K + i]) : 0.f;
      S[4 * m + e] = H && i < K ? H[(size_t)i * V] : 0.f;
    }
  wkv_sweep<T, KP, true>(wkv_raw, S, uu, unused, r, k, w, v, o, row, Tn, K, V,
                         c0, chunk * WKV_C, min(Tn, (chunk + 1) * WKV_C),
                         kvec, vvec);
}

template <typename T, int KP>
int launch_wkv6(int BH, int Tn, int K, int V, const void* r, const void* k,
                const void* v, const void* w, const void* u, void* o,
                void* scratch, cudaStream_t stream) {
  const int nc = (Tn + WKV_C - 1) / WKV_C;
  if (nc > 65535 || (long long)K * V > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  const unsigned vblocks = (unsigned)((V + WKV_VB - 1) / WKV_VB);
  const bool kvec = (size_t)K * sizeof(T) % 16 == 0 && aligned(r, 16) &&
                    aligned(k, 16) && aligned(w, 16);
  const bool vvec = (size_t)V * sizeof(T) % 16 == 0 && aligned(v, 16);
  // scratch: L (BH, nc - 1, K, V), then D (BH, nc - 1, K)
  float* states = (float*)scratch;
  float* decays = states + (size_t)BH * (nc - 1) * K * V;
  constexpr size_t smem = wkv_smem<T, KP>();
  int err;
  if (nc > 1) {
    auto* state = &wkv6_chunk_state<T, KP>;
    if ((err = set_smem(state, smem))) return err;
    KERNEL_LAUNCH(state, dim3((unsigned)BH, (unsigned)(nc - 1), vblocks),
                  WKV_THREADS, smem, stream, Tn, K, V, nc, kvec, vvec,
                  (const T*)r, (const T*)k, (const T*)v, (const T*)w, states,
                  decays);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (nc > 2) {
    const int vec = V % 4 == 0 ? 4 : 1;
    const dim3 grid((unsigned)BH, (unsigned)((K * V / vec +
                                              WKV_PASS_THREADS - 1) /
                                             WKV_PASS_THREADS));
    auto* pass =
        vec == 4 ? &wkv6_state_passing<4> : &wkv6_state_passing<1>;
    KERNEL_LAUNCH(pass, grid, WKV_PASS_THREADS, 0, stream, K, V, nc, states,
                  decays);
    if ((err = (int)cudaGetLastError())) return err;
  }
  auto* scan = &wkv6_chunk_scan<T, KP>;
  if ((err = set_smem(scan, smem))) return err;
  KERNEL_LAUNCH(scan, dim3((unsigned)BH, (unsigned)nc, vblocks), WKV_THREADS,
                smem, stream, Tn, K, V, nc, kvec, vvec, (const T*)r,
                (const T*)k, (const T*)v, (const T*)w, (const T*)u, states,
                (T*)o);
  return (int)cudaGetLastError();
}

template <typename T>
int wkv6_for_dim(int BH, int Tn, int K, int V, const void* r, const void* k,
                 const void* v, const void* w, const void* u, void* o,
                 void* scratch, cudaStream_t s) {
  switch (state_pad(K)) {
    case 16:
      return launch_wkv6<T, 16>(BH, Tn, K, V, r, k, v, w, u, o, scratch, s);
    case 32:
      return launch_wkv6<T, 32>(BH, Tn, K, V, r, k, v, w, u, o, scratch, s);
    case 64:
      return launch_wkv6<T, 64>(BH, Tn, K, V, r, k, v, w, u, o, scratch, s);
    case 128:
      return launch_wkv6<T, 128>(BH, Tn, K, V, r, k, v, w, u, o, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
// ==== end of the K17 span

// ---------------------------------------------------------------------------
// K18 ssd — replaces src/repro/kernels/mamba2.py ssd (_ssd_kernel,
// pl.pallas_call at mamba2.py:61).  Per sequence b and head h, state
// (N, P) from zero:
//   h[n, p] <- exp(a_t) h[n, p] + b_t[n] x_t[p]
//   y_t[p]   = sum_n c_t[n] h[n, p]
// x, y: (B, T, H, P); a: (B, T, H) float32 whatever x's dtype; b, c: (B,
// T, N), shared by the heads.
// The chunked SSD of Mamba-2 (Dao and Gu, arXiv:2405.21060, section 6, the
// block decomposition): time in chunks of SSD_L steps; A_i is the
// chunk-local inclusive cumsum of a (chunk-local, so that it stays small;
// in float64, so that A_i - A_j is the segment sum, each exponent then
// rounded to float32), "last" the chunk's last valid step.  Entering a
// chunk in state H_c:
//   y_i     = sum_{j <= i} exp(A_i - A_j) (c_i . b_j) x_j + exp(A_i) c_i H_c
//   H_{c+1} = exp(A_last) H_c + S_c,  S_c = sum_j exp(A_last - A_j) b_j x_j
// Three kernels behind the one C entry (one counted launch a call):
//  1. ssd_chunk_state, grid (B * (nc - 1), head groups, P tiles): S_c of
//     every chunk that has a successor (all of them full), into the
//     float32 scratch the wrapper allocates (slot c: (b, c, h, N, P)), and
//     the chunk's A_last.
//  2. ssd_state_passing, grid (B * H, tiles of N * P): walks the chunks,
//     overwriting slot c in place with H_{c+1} (H_0 = 0 is not stored).
//  3. ssd_chunk_scan, grid (B * nc, head groups, P tiles): the chunk's c
//     and b loaded once for a group of heads and G = C B^T computed once
//     for it; then per head M = G * exp(A_i - A_j) for j <= i, masked
//     before the exp (a positive segment sum overflows, and inf * 0 is
//     NaN), and y = M x + exp(A) C H_c, rounded once to dt.
// Every product and sum but the cumsum is float32 on the CUDA cores, for
// both dtypes: the float32 tolerance (1e-5) rules out TF32, and one
// arithmetic keeps bf16 at one rounding of y.  Each product is a 64-wide
// register tile, 4 x 4 a thread over 16 x 16 threads, both operands read
// from shared memory as float4.
// b and c are staged by cp.async where their rows are whole 16-byte
// vectors.  The ragged last chunk: steps past T are never read (zeros in
// shared memory: they add nothing) nor written.  N is padded to NP in
// {16, 32, 64, 128} with zeros; P is cut in tiles of SSD_PT columns.
// Bound: ~4.7 GFLOP at zamba2-7b's (2, 1024, 112, 64, 64), operations;
// the scratch (55 MB there: written, read and written, read) is the
// design's own traffic.
// ---------------------------------------------------------------------------
constexpr int SSD_L = 64;                // steps a chunk
constexpr int SSD_PT = 64;               // state columns p a CTA
constexpr int SSD_THREADS = 256;         // 16 x 16 threads, 4 x 4 outputs each
constexpr int SSD_LP = SSD_L + 4;        // pitch of the 64-wide shared tiles
constexpr int SSD_HG_STATE = 4;          // heads a chunk_state CTA, at most
constexpr int SSD_HG_SCAN = 8;           // heads a chunk_scan CTA, at most
static_assert(SSD_L == 64 && SSD_PT == 64, "the tiles are 16 x 4 wide");
static_assert(SSD_HG_SCAN <= SSD_THREADS / 32, "a warp scans a head");
static_assert(SSD_HG_STATE * SSD_L <= SSD_THREADS, "a weight a thread");

// `count` elements of T from global `src` to shared `dst`: by 16-byte
// cp.async when `vec` (both 16-byte aligned, count * sizeof(T) a multiple
// of 16; cp_async_wait_all and a barrier before reading), else one by one.
template <typename T>
__device__ __forceinline__ void stage_span(T* dst, const T* src, int count,
                                           bool vec) {
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    for (int i = threadIdx.x; i < count / E; i += SSD_THREADS)
      cp_async16(dst + i * E, src + (size_t)i * E);
  } else {
    for (int i = threadIdx.x; i < count; i += SSD_THREADS) dst[i] = src[i];
  }
}

// how many of a thread's 4 columns lie before the edge, `left` away
__device__ __forceinline__ int cols4(int left) {
  return left >= 4 ? 4 : left > 0 ? left : 0;
}

// 4 consecutive elements of T at p as floats, n of them (0..4) in range
// and the rest 0; one 8- or 16-byte load when `vec` (p aligned to it)
template <typename T>
__device__ __forceinline__ float4 load4(const T* p, int n, bool vec) {
  if (vec && n == 4) {
    if constexpr (sizeof(T) == 4) {
      return *reinterpret_cast<const float4*>(p);
    } else {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      return make_float4(__uint_as_float(u.x << 16),
                         __uint_as_float(u.x & 0xffff0000u),
                         __uint_as_float(u.y << 16),
                         __uint_as_float(u.y & 0xffff0000u));
    }
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n > 0) v.x = to_f(p[0]);
  if (n > 1) v.y = to_f(p[1]);
  if (n > 2) v.z = to_f(p[2]);
  if (n > 3) v.w = to_f(p[3]);
  return v;
}

// the first n (0..4) of v to p, rounded to T; one store when `vec`
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 v, int n, bool vec) {
  if (vec && n == 4) {
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(p) = v;
    } else {
      using Pk = Pack16<__nv_bfloat16>;
      *reinterpret_cast<uint2*>(p) =
          make_uint2(Pk::two(v.x, v.y), Pk::two(v.z, v.w));
    }
    return;
  }
  if (n > 0) p[0] = from_f<T>(v.x);
  if (n > 1) p[1] = from_f<T>(v.y);
  if (n > 2) p[2] = from_f<T>(v.z);
  if (n > 3) p[3] = from_f<T>(v.w);
}

// rows ti + 16 k (k < NP / 16) of head h's state in `Hs` (H, N, P),
// columns p .. p + 3 (np of them before P); rows at or past N as zeros
template <int NP>
__device__ __forceinline__ void fetch_state(float4 (&hr)[NP / 16],
                                            const float* Hs, int h, int N,
                                            int P, int p, int np, bool vec) {
  const int ti = threadIdx.x >> 4;
#pragma unroll
  for (int k = 0; k < NP / 16; ++k) {
    const int n = ti + 16 * k;
    hr[k] = n < N && np > 0
                ? load4(Hs + ((size_t)h * N + n) * P + p, np, vec)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ float4 row4(const float (&acc)[4]) {
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// x rows ti + 16 k (k < 4) of head h in one chunk, columns p .. p + 3 (np
// of them before P), as floats; rows at or past `valid` read as zeros
template <typename T>
__device__ __forceinline__ void fetch_x(float4 (&xr)[4], const T* x,
                                        size_t row0, int H, int h, int P,
                                        int p, int np, bool vec, int valid) {
  const int ti = threadIdx.x >> 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = ti + 16 * k;
    xr[k] = j < valid && np > 0
                ? load4(x + ((row0 + j) * H + h) * P + p, np, vec)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc[r][q] += u[r] v[q]
__device__ __forceinline__ void outer(float (&acc)[4][4], float4 u,
                                      float4 v) {
  const float uu[4] = {u.x, u.y, u.z, u.w}, vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(uu[r], vv[q], acc[r][q]);
}

// sA[g][j] = the chunk-local inclusive cumsum of a over steps 0..j of head
// h0 + g (g < G <= warps), steps at or past `valid` adding 0, so that
// sA[g][SSD_L - 1] is A_last.  In float64: a sum of 64 float32 values is
// then exact or nearly, so a difference A_i - A_j is the segment sum to
// float64's precision, not to float32's ulp of |A| (the chunked form's
// largest error otherwise).  Warp g scans head g: two steps a lane, then a
// shuffle scan.  Ends with a barrier.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ a,
                                             size_t row0, int H, int h0,
                                             int G, int valid, double* sA) {
  for (int e = threadIdx.x; e < SSD_L * G; e += SSD_THREADS) {
    const int j = e / G, g = e % G;
    sA[g * SSD_L + j] = j < valid ? a[(row0 + j) * H + h0 + g] : 0.0;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp < G) {
    double* s = sA + warp * SSD_L;
    const double v0 = s[2 * lane], v1 = s[2 * lane + 1];
    double incl = v0 + v1;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    double excl = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane == 0) excl = 0.0;
    s[2 * lane] = excl + v0;
    s[2 * lane + 1] = excl + v0 + v1;
  }
  __syncthreads();
}

// shared memory, in floats: chunk_state's x tile (or b as staged, before
// it), chunk_scan's G, M and x tiles (or c and b as staged, before them)
template <typename T, int NP>
__host__ __device__ constexpr int ssd_state_mid() {
  return SSD_L * SSD_LP > SSD_L * NP * (int)sizeof(T) / 4
             ? SSD_L * SSD_LP : SSD_L * NP * (int)sizeof(T) / 4;
}
template <typename T, int NP>
__host__ __device__ constexpr size_t ssd_state_smem() {
  return sizeof(float) * (SSD_L * NP + ssd_state_mid<T, NP>() +
                          SSD_HG_STATE * SSD_L) +
         sizeof(double) * SSD_HG_STATE * SSD_L;
}
template <typename T, int NP>
__host__ __device__ constexpr int ssd_scan_mid() {
  return 3 * SSD_L * SSD_LP > 2 * SSD_L * NP * (int)sizeof(T) / 4
             ? 3 * SSD_L * SSD_LP : 2 * SSD_L * NP * (int)sizeof(T) / 4;
}
template <typename T, int NP>
__host__ __device__ constexpr size_t ssd_scan_smem() {
  return sizeof(float) * (2 * NP * SSD_LP + ssd_scan_mid<T, NP>()) +
         sizeof(double) * SSD_HG_SCAN * SSD_L;
}

// 1. S_c[n, p] = sum_j b_j[n] (exp(A_last - A_j) x_j[p]) of a full chunk c
// with a successor, for hg <= SSD_HG_STATE heads; thread (ti, tq) owns
// state rows ti*RN .. ti*RN + RN - 1 and columns 4 tq .. 4 tq + 3 of the P
// tile.
template <typename T, int NP>
__global__ void __launch_bounds__(SSD_THREADS, NP < 128 ? 3 : 2)
ssd_chunk_state(int Tn, int H, int P, int N, int nc, int hg,
                const T* __restrict__ x, const float* __restrict__ a,
                const T* __restrict__ b, float* __restrict__ states,
                float* __restrict__ lasts) {
  extern __shared__ __align__(16) float smem[];
  constexpr int RN = NP / 16;                      // state rows a thread
  float* sb = smem;                                // [L][NP] b
  float* sx = sb + SSD_L * NP;                     // [L][LP] weighted x
  double* sA = reinterpret_cast<double*>(sx + ssd_state_mid<T, NP>());
                                                   // [HG][L] A
  float* sw = reinterpret_cast<float*>(sA + SSD_HG_STATE * SSD_L);
                                                   // [HG][L] weights
  T* raw = reinterpret_cast<T*>(sx);               // b as staged
  const int tid = threadIdx.x, ti = tid >> 4, tq = tid & 15;
  const int full = nc - 1;
  const int seq = blockIdx.x / full, chunk = blockIdx.x % full;
  const int h0 = blockIdx.y * hg, G = min(hg, H - h0);
  const int p = (int)blockIdx.z * SSD_PT + 4 * tq, np = cols4(P - p);
  const size_t row0 = (size_t)seq * Tn + (size_t)chunk * SSD_L;
  stage_span(raw, b + row0 * N, SSD_L * N,
             (size_t)N * sizeof(T) % 16 == 0 && aligned(b, 16));
  chunk_cumsum(a, row0, H, h0, G, SSD_L, sA);     // while b lands
  if (tid < G * SSD_L)
    sw[tid] = expf((float)(sA[(tid / SSD_L + 1) * SSD_L - 1] - sA[tid]));
  if (blockIdx.z == 0 && tid < G)
    lasts[((size_t)seq * full + chunk) * H + h0 + tid] =
        (float)sA[(tid + 1) * SSD_L - 1];
  cp_async_wait_all();
  __syncthreads();                                 // weights set, b landed
  for (int e = tid; e < SSD_L * NP; e += SSD_THREADS) {
    const int j = e / NP, n = e % NP;
    sb[e] = n < N ? to_f(raw[j * N + n]) : 0.f;
  }
  __syncthreads();                                 // raw (under sx) is free
  const bool xv = P % 4 == 0 && aligned(x, 4 * sizeof(T));
  const bool sv = P % 4 == 0;                      // 16-byte state rows
  float4 xr[4];                                    // x rows ti + 16 k
  fetch_x(xr, x, row0, H, h0, P, p, np, xv, SSD_L);
  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    const float* w = sw + g * SSD_L;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float s = w[ti + 16 * k];
      float4 v = xr[k];
      v.x *= s; v.y *= s; v.z *= s; v.w *= s;
      st4(sx + (ti + 16 * k) * SSD_LP + 4 * tq, v);
    }
    __syncthreads();
    if (g + 1 < G)                                 // lands during the product
      fetch_x(xr, x, row0, H, h + 1, P, p, np, xv, SSD_L);
    float acc[RN][4];
#pragma unroll
    for (int r = 0; r < RN; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < SSD_L; ++j) {
      const float4 xq = ld4(sx + j * SSD_LP, 4 * tq);
      const float xx[4] = {xq.x, xq.y, xq.z, xq.w};
      const float* brow = sb + j * NP + ti * RN;
      float bn[RN];
      if constexpr (RN >= 4) {
#pragma unroll
        for (int r = 0; r < RN; r += 4) {
          const float4 u = ld4(brow, r);
          bn[r] = u.x; bn[r + 1] = u.y; bn[r + 2] = u.z; bn[r + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int r = 0; r < RN; ++r) bn[r] = brow[r];
      }
#pragma unroll
      for (int r = 0; r < RN; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(bn[r], xx[q], acc[r][q]);
    }
    float* S = states + (((size_t)seq * full + chunk) * H + h) *
                            ((size_t)N * P);
#pragma unroll
    for (int r = 0; r < RN; ++r) {
      const int n = ti * RN + r;
      if (n < N && np > 0)
        store4(S + (size_t)n * P + p, row4(acc[r]), np, sv);
    }
    __syncthreads();                               // sx read: the next head's
  }
}

// 2. In place over slots 0 .. nc - 2: slot c <- H_{c+1} = exp(A_last of c)
// H_c + S_c, H_1 = S_0.  A thread walks VEC state elements of one (b, h);
// the next slot's load is issued before this one's update.
template <int VEC>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_state_passing(int H, int nps, int nc, float* __restrict__ states,
                  const float* __restrict__ lasts) {
  const int e = (blockIdx.y * SSD_THREADS + threadIdx.x) * VEC;
  if (e >= nps) return;
  const int seq = blockIdx.x / H, h = blockIdx.x % H, full = nc - 1;
  const size_t stride = (size_t)H * nps;           // slot c to c + 1
  float* s = states + ((size_t)seq * full * H + h) * nps + e;
  const float* l = lasts + (size_t)seq * full * H + h;
  auto ld = [](const float* q, float* v) {
    if constexpr (VEC == 4) {
      const float4 u = *reinterpret_cast<const float4*>(q);
      v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
    } else {
      v[0] = *q;
    }
  };
  float run[VEC], nxt[VEC];
  ld(s, run);
  if (full > 1) ld(s + stride, nxt);
  for (int c = 1; c < full; ++c) {
    float cur[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) cur[v] = nxt[v];
    if (c + 1 < full) ld(s + (c + 1) * stride, nxt);
    const float d = expf(l[(size_t)c * H]);
#pragma unroll
    for (int v = 0; v < VEC; ++v) run[v] = fmaf(d, run[v], cur[v]);
    if constexpr (VEC == 4)
      st4(s + c * stride, make_float4(run[0], run[1], run[2], run[3]));
    else
      s[c * stride] = run[0];
  }
}

// 3. y of one chunk for hg <= SSD_HG_SCAN heads: thread (ti, tq) owns rows
// 4 ti .. 4 ti + 3 (steps i) and columns 4 tq .. 4 tq + 3 of every 64-wide
// tile (G's j, the P tile's p).
template <typename T, int NP>
__global__ void __launch_bounds__(SSD_THREADS, 2)
ssd_chunk_scan(int Tn, int H, int P, int N, int nc, int hg,
               const T* __restrict__ x, const float* __restrict__ a,
               const T* __restrict__ b, const T* __restrict__ c,
               const float* __restrict__ states, T* __restrict__ y) {
  extern __shared__ __align__(16) float smem[];
  float* cT = smem;                                // [NP][LP] c transposed
  float* bT = cT + NP * SSD_LP;                    // [NP][LP] b transposed,
                                                   // then H_c [NP][LP]
  float* Gt = bT + NP * SSD_LP;                    // [L][LP] Gt[j][i] = c_i.b_j
  float* Mt = Gt + SSD_L * SSD_LP;                 // [L][LP] Mt[j][i] = M_ij
  float* sx = Mt + SSD_L * SSD_LP;                 // [L][LP] x
  double* sA = reinterpret_cast<double*>(Gt + ssd_scan_mid<T, NP>());
                                                   // [HG][L] A
  T* rc = reinterpret_cast<T*>(Gt);                // c and b as staged
  T* rb = rc + SSD_L * N;
  const int tid = threadIdx.x, ti = tid >> 4, tq = tid & 15;
  const int seq = blockIdx.x / nc, chunk = blockIdx.x % nc;
  const int valid = min(SSD_L, Tn - chunk * SSD_L);
  const int h0 = blockIdx.y * hg, G = min(hg, H - h0);
  const int p = (int)blockIdx.z * SSD_PT + 4 * tq, np = cols4(P - p);
  const size_t row0 = (size_t)seq * Tn + (size_t)chunk * SSD_L;
  const bool bcv = (size_t)N * sizeof(T) % 16 == 0 && aligned(b, 16) &&
                   aligned(c, 16);
  stage_span(rc, c + row0 * N, valid * N, bcv);
  stage_span(rb, b + row0 * N, valid * N, bcv);
  chunk_cumsum(a, row0, H, h0, G, valid, sA);      // while c and b land
  cp_async_wait_all();
  __syncthreads();
  for (int e = tid; e < SSD_L * NP; e += SSD_THREADS) {
    const int j = e / NP, n = e % NP;
    const bool in = j < valid && n < N;
    cT[n * SSD_LP + j] = in ? to_f(rc[j * N + n]) : 0.f;
    bT[n * SSD_LP + j] = in ? to_f(rb[j * N + n]) : 0.f;
  }
  __syncthreads();                                 // rc, rb consumed
  {
    float g[4][4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n)
      outer(g, ld4(cT + n * SSD_LP, 4 * ti), ld4(bT + n * SSD_LP, 4 * tq));
#pragma unroll
    for (int q = 0; q < 4; ++q)
      st4(Gt + (4 * tq + q) * SSD_LP + 4 * ti,
          make_float4(g[0][q], g[1][q], g[2][q], g[3][q]));
  }
  __syncthreads();                                 // Gt whole, bT free
  const bool xv = P % 4 == 0 && aligned(x, 4 * sizeof(T));
  const bool yv = P % 4 == 0 && aligned(y, 4 * sizeof(T));
  const bool sv = P % 4 == 0;
  float4 xr[4], hr[NP / 16];                       // x rows ti + 16 k, H_c's
  // the states entering this chunk, (H, N, P)
  const float* Hs = states + ((size_t)seq * (nc - 1) + chunk - 1) * H *
                                 ((size_t)N * P);
  fetch_x(xr, x, row0, H, h0, P, p, np, xv, valid);
  if (chunk > 0) fetch_state<NP>(hr, Hs, h0, N, P, p, np, sv);
  for (int g = 0; g < G; ++g) {
    const int h = h0 + g;
    const double* A = sA + g * SSD_L;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      st4(sx + (ti + 16 * k) * SSD_LP + 4 * tq, xr[k]);
    if (chunk > 0) {
#pragma unroll
      for (int k = 0; k < NP / 16; ++k)
        st4(bT + (ti + 16 * k) * SSD_LP + 4 * tq, hr[k]);
    }
    for (int e = tid; e < SSD_L * SSD_L; e += SSD_THREADS) {
      const int j = e / SSD_L, i = e % SSD_L;
      Mt[j * SSD_LP + i] = j <= i && i < valid
                               ? Gt[j * SSD_LP + i] *
                                     expf((float)(A[i] - A[j]))
                               : 0.f;
    }
    __syncthreads();
    if (g + 1 < G) {                               // lands during the products
      fetch_x(xr, x, row0, H, h + 1, P, p, np, xv, valid);
      if (chunk > 0) fetch_state<NP>(hr, Hs, h + 1, N, P, p, np, sv);
    }
    float acc[4][4] = {};
    if (chunk > 0) {
#pragma unroll 4
      for (int n = 0; n < N; ++n)
        outer(acc, ld4(cT + n * SSD_LP, 4 * ti),
              ld4(bT + n * SSD_LP, 4 * tq));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float d = expf((float)A[4 * ti + r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= d;
      }
    }
    const int jn = min(4 * ti + 4, valid);        // M is zero past row i
#pragma unroll 4
    for (int j = 0; j < jn; ++j)
      outer(acc, ld4(Mt + j * SSD_LP, 4 * ti), ld4(sx + j * SSD_LP, 4 * tq));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * ti + r;
      if (i < valid && np > 0)
        store4(y + ((row0 + i) * H + h) * P + p, row4(acc[r]), np, yv);
    }
    __syncthreads();                               // sx, bT, Mt reused
  }
}

// CTAs of `kernel` resident on the card at once, with `smem` bytes each
template <typename K>
int resident_ctas(K* kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, SSD_THREADS,
                                                smem);
  return sms * per_sm > 0 ? sms * per_sm : 1;
}

// Heads a CTA (1 .. most) for a grid of `groups` CTAs a head group, with
// `slots` resident CTAs: the
// count that takes the fewest waves of resident CTAs times the work of a
// CTA (its heads, plus about one head's worth of set-up: staging, the
// cumsum, chunk_scan's G = C B^T).  A grid's last wave runs part-empty, so
// at zamba2-7b's 112 heads a scan CTA takes 7 (512 CTAs: two waves of 2 x
// 132) rather than 8 (448), and a state CTA 3 rather than 4.
inline int heads_per_cta(int slots, long long groups, int H, int most) {
  int best = most;
  long long best_cost = LLONG_MAX;
  for (int hg = most; hg >= 1; --hg) {
    const long long ctas = groups * ((H + hg - 1) / hg);
    const long long cost = (ctas + slots - 1) / slots * (hg + 1);
    if (cost < best_cost) best_cost = cost, best = hg;
  }
  return best;
}

template <typename T, int NP>
int launch_ssd(int B, int Tn, int H, int P, int N, const void* x,
               const void* a, const void* b, const void* c, void* y,
               void* scratch, cudaStream_t stream) {
  const int nc = (Tn + SSD_L - 1) / SSD_L;
  if ((long long)B * nc > INT_MAX || (long long)B * H > INT_MAX ||
      (long long)N * P > INT_MAX / 4)
    return (int)cudaErrorInvalidValue;
  const unsigned ptiles = (unsigned)((P + SSD_PT - 1) / SSD_PT);
  // scratch: the states (B, nc - 1, H, N, P), then A_last (B, nc - 1, H)
  float* states = (float*)scratch;
  float* lasts = states + (size_t)B * (nc - 1) * H * N * P;
  int err;
  if (nc > 1) {
    constexpr size_t smem = ssd_state_smem<T, NP>();
    if ((err = set_smem(ssd_chunk_state<T, NP>, smem))) return err;
    static const int slots = resident_ctas(ssd_chunk_state<T, NP>, smem);
    const int hg = heads_per_cta(slots, (long long)B * (nc - 1) * ptiles, H,
                                 SSD_HG_STATE);
    const dim3 grid((unsigned)(B * (nc - 1)), (unsigned)((H + hg - 1) / hg),
                    ptiles);
    ssd_chunk_state<T, NP><<<grid, SSD_THREADS, smem, stream>>>(
        Tn, H, P, N, nc, hg, (const T*)x, (const float*)a, (const T*)b,
        states, lasts);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (nc > 2) {
    const int nps = N * P, vec = nps % 4 == 0 ? 4 : 1;
    const dim3 grid((unsigned)(B * H),
                    (unsigned)((nps / vec + SSD_THREADS - 1) / SSD_THREADS));
    if (vec == 4)
      ssd_state_passing<4><<<grid, SSD_THREADS, 0, stream>>>(H, nps, nc,
                                                             states, lasts);
    else
      ssd_state_passing<1><<<grid, SSD_THREADS, 0, stream>>>(H, nps, nc,
                                                             states, lasts);
    if ((err = (int)cudaGetLastError())) return err;
  }
  constexpr size_t smem = ssd_scan_smem<T, NP>();
  if ((err = set_smem(ssd_chunk_scan<T, NP>, smem))) return err;
  static const int slots = resident_ctas(ssd_chunk_scan<T, NP>, smem);
  const int hg = heads_per_cta(slots, (long long)B * nc * ptiles, H,
                               SSD_HG_SCAN);
  const dim3 grid((unsigned)(B * nc), (unsigned)((H + hg - 1) / hg), ptiles);
  ssd_chunk_scan<T, NP><<<grid, SSD_THREADS, smem, stream>>>(
      Tn, H, P, N, nc, hg, (const T*)x, (const float*)a, (const T*)b,
      (const T*)c, states, (T*)y);
  return (int)cudaGetLastError();
}

template <typename T>
int ssd_for_dim(int B, int Tn, int H, int P, int N, const void* x,
                const void* a, const void* b, const void* c, void* y,
                void* scratch, cudaStream_t s) {
  switch (state_pad(N)) {
    case 16:
      return launch_ssd<T, 16>(B, Tn, H, P, N, x, a, b, c, y, scratch, s);
    case 32:
      return launch_ssd<T, 32>(B, Tn, H, P, N, x, a, b, c, y, scratch, s);
    case 64:
      return launch_ssd<T, 64>(B, Tn, H, P, N, x, a, b, c, y, scratch, s);
    case 128:
      return launch_ssd<T, 128>(B, Tn, H, P, N, x, a, b, c, y, scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int tf_rmsnorm(int R, int D, int dtype, float eps, void* x, void* w, void* y,
               void* stream) {
  if (R < 0 || D < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32: return launch_rmsnorm<float>(R, D, eps, x, w, y, s);
    case DT_BF16: return launch_rmsnorm<__nv_bfloat16>(R, D, eps, x, w, y, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// instance: FwInstance, for bfloat16; float32 has one kernel a head dim
// (FW_DEFAULT)
int tf_flash_attention(int BH, int Tq, int Tk, int D, int dtype, int instance,
                       int causal, int q_offset, float scale, void* q,
                       void* k, void* v, void* o, void* stream) {
  if (BH < 0 || Tq < 0 || Tk < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      if (instance != FW_DEFAULT) return (int)cudaErrorInvalidValue;
      return attention_f32(BH, Tq, Tk, D, causal, q_offset, scale, q, k, v,
                           o, s);
    case DT_BF16:   // q, k, v 16-byte aligned (TMA): the wrapper sees to it
      return attention_bf16(BH, Tq, Tk, D, instance, causal, q_offset, scale,
                            q, k, v, o, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// scratch: float32, BH * (ceil(Tn / 64) - 1) * K * (V + 1) words (the
// wrapper allocates it; nothing is allocated here)
int tf_wkv6(int BH, int Tn, int K, int V, int dtype, void* r, void* k,
            void* v, void* w, void* u, void* o, void* scratch, void* stream) {
  if (BH < 0 || Tn < 0 || K < 1 || V < 1)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tn == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return wkv6_for_dim<float>(BH, Tn, K, V, r, k, v, w, u, o, scratch, s);
    case DT_BF16:
      return wkv6_for_dim<__nv_bfloat16>(BH, Tn, K, V, r, k, v, w, u, o,
                                         scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// scratch: float32, B * (ceil(Tn / 64) - 1) * H * (N * P + 1) words (the
// wrapper allocates it; nothing is allocated here)
int tf_ssd(int B, int Tn, int H, int P, int N, int dtype, void* x, void* a,
           void* b, void* c, void* y, void* scratch, void* stream) {
  if (B < 0 || Tn < 0 || H < 1 || P < 1 || N < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Tn == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return ssd_for_dim<float>(B, Tn, H, P, N, x, a, b, c, y, scratch, s);
    case DT_BF16:
      return ssd_for_dim<__nv_bfloat16>(B, Tn, H, P, N, x, a, b, c, y,
                                        scratch, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
