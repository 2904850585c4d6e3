// The transformer's hot spots for Hopper (sm_90a): K16 rmsnorm and K15
// flash_attention (forward).
//
// Each kernel replaces one of the reference's Pallas kernels
// (src/repro/kernels/rmsnorm.py, src/repro/kernels/attention.py) and
// computes the same function on the layouts the reference's ops hand it:
// (R, D) rows for the norm, (BH, T, D) heads flattened and GQA repeated
// for attention.  Inputs are float32 or bfloat16 (the dtype code is an
// argument: 0, 1); all arithmetic is float32 and every output is
// rounded once to the input's dtype.  The reference tiles rows into blocks
// and pads; here each kernel computes its own offsets (64-bit) and masks
// the ragged edges itself, so nothing is padded and nothing past the end of
// an input is read.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through ctypes (kernels/common.py).
// Every C entry launches on the caller's stream and returns
// cudaGetLastError().  No --use_fast_math: expf and rsqrtf are the
// library's accurate versions.

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
// element is far below any rate.  Design: one block a row (the model's
// rows are 1536 wide: 6 elements a thread), the sum of squares in float32
// (warp shuffles, then the warps' partials in a fixed order, so every
// thread holds the same r), then a second pass over the row, which the
// first pass left in L1.  The row's edge is masked by the loop bound.
// ---------------------------------------------------------------------------
constexpr int RMS_MAX_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(RMS_MAX_THREADS)
rmsnorm_kernel(int D, float eps, const T* __restrict__ x,
               const T* __restrict__ w, T* __restrict__ y) {
  __shared__ float part[RMS_MAX_THREADS / 32];
  const T* xr = x + (size_t)blockIdx.x * D;
  T* yr = y + (size_t)blockIdx.x * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float v = to_f(xr[d]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < (int)(blockDim.x >> 5); ++i) tot += part[i];
  const float r = rsqrtf(tot / (float)D + eps);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const float xn = to_f(from_f<T>(to_f(xr[d]) * r));
    yr[d] = from_f<T>(xn * to_f(w[d]));
  }
}

template <typename T>
int launch_rmsnorm(int R, int D, float eps, const void* x, const void* w,
                   void* y, cudaStream_t stream) {
  int threads = ((D + 31) / 32) * 32;
  if (threads > RMS_MAX_THREADS) threads = RMS_MAX_THREADS;
  rmsnorm_kernel<T><<<R, threads, 0, stream>>>(
      D, eps, (const T*)x, (const T*)w, (T*)y);
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
// 51.6 GFLOP against 100.7 MB: operations.  This first kernel does them on
// the CUDA cores in float32 (67 TFLOP/s; the bf16 tensor cores' 989 are
// later work, which must first argue the rounding of P).  Design: one CTA
// of 16 x 16 threads a (head-batch, block of FA_BQ query rows), heavy
// causal blocks launched first; it loops over blocks of FA_BK keys up to
// the last one its rows can see (fully masked causal blocks are never
// visited).  Q, the K and V block and P live in shared memory as float32;
// a thread owns FA_BQ/16 rows x (FA_BK/16 score, D/16 output) columns, so
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

template <typename T, int D>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(int BH, int Tq, int Tk, int nqb, int causal,
                       int q_offset, float scale, const T* __restrict__ q,
                       const T* __restrict__ k, const T* __restrict__ v,
                       T* __restrict__ o) {
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
    sq[r * QP + c] = (q0 + r < Tq) ? to_f(q[qbase + (size_t)(q0 + r) * D + c])
                                   : 0.f;
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
      sk[r * KP + c] = in ? to_f(k[g]) : 0.f;
      sv[r * VP + c] = in ? to_f(v[g]) : 0.f;
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
    T* orow = o + qbase + (size_t)row * D;
#pragma unroll
    for (int j = 0; j < OCT; ++j) orow[tx + 16 * j] = from_f<T>(acc[i][j] / inv);
  }
}

template <typename T, int D>
int launch_attention(int BH, int Tq, int Tk, int causal, int q_offset,
                     float scale, const void* q, const void* k, const void* v,
                     void* o, cudaStream_t stream) {
  constexpr size_t smem = fa_smem_bytes<D>();
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nqb = (Tq + FA_BQ - 1) / FA_BQ;
  const long long blocks = (long long)BH * nqb;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  flash_attention_kernel<T, D><<<(unsigned)blocks, FA_THREADS, smem, stream>>>(
      BH, Tq, Tk, nqb, causal, q_offset, scale, (const T*)q, (const T*)k,
      (const T*)v, (T*)o);
  return (int)cudaGetLastError();
}

template <typename T>
int attention_for_dim(int BH, int Tq, int Tk, int D, int causal,
                      int q_offset, float scale, const void* q,
                      const void* k, const void* v, void* o,
                      cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch_attention<T, 32>(BH, Tq, Tk, causal, q_offset, scale, q,
                                     k, v, o, stream);
    case 64:
      return launch_attention<T, 64>(BH, Tq, Tk, causal, q_offset, scale, q,
                                     k, v, o, stream);
    case 128:
      return launch_attention<T, 128>(BH, Tq, Tk, causal, q_offset, scale, q,
                                      k, v, o, stream);
    default:
      return (int)cudaErrorInvalidValue;
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

int tf_flash_attention(int BH, int Tq, int Tk, int D, int dtype, int causal,
                       int q_offset, float scale, void* q, void* k, void* v,
                       void* o, void* stream) {
  if (BH < 0 || Tq < 0 || Tk < 1 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Tq == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DT_F32:
      return attention_for_dim<float>(BH, Tq, Tk, D, causal, q_offset, scale,
                                      q, k, v, o, s);
    case DT_BF16:
      return attention_for_dim<__nv_bfloat16>(BH, Tq, Tk, D, causal,
                                              q_offset, scale, q, k, v, o, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
