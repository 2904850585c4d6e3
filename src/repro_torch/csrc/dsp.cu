// The DSP accelerators of the audio pipeline (paper Table II), for Hopper
// (sm_90a): real FIR, vector dot, cross-correlation and the radix-2 FFT.
//
// Each kernel replaces one of the reference's Pallas kernels
// (src/repro/kernels/dsp_fir.py, dsp_vector.py, dsp_spectral.py) and
// computes the same function on float32 frames laid out as the reference
// lays them out: (B, N) rows, or (B, N, 2) interleaved re/im for the FFT.
// The reference tiles the batch into blocks of BB rows and the wrapper
// pads B up to a multiple of BB; here each kernel computes its own offsets
// (64-bit, so no batch size overflows them) and masks the ragged batch
// edge itself, so nothing is padded.
//
// At the audio pipeline's shape (B = 65536 frames of N = 256 samples) all
// four are bound by device-memory bytes: each does a few flops per byte
// it moves, far below the card's fp32 rate.  Each is written to stream its
// bytes once, coalesced; tiling through TMA and tuning are later work.
// Every float constant (FIR taps, FFT twiddles) comes from the caller:
// nothing here calls device trig, and the library is built without
// --use_fast_math.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through ctypes (kernels/common.py).
// Every C entry launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int FIR_THREADS = 256;
constexpr int DOT_THREADS = 256;         // one warp per row: 8 rows a block
constexpr int CORR_WARPS = 8;            // one warp per row, at most 8 a block
constexpr int FFT_THREADS = 256;
constexpr int SMEM_LIMIT = 48 * 1024;    // static-launch shared memory cap

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// K5 real_fir — replaces src/repro/kernels/dsp_fir.py real_fir
// (_real_fir_kernel, pl.pallas_call at dsp_fir.py:49).
//   y[b, n] = sum_k h[k] * x[b, n - k], zero fill for n - k < 0.
// Bound: B*N*4 bytes read plus B*N*4 written; 2K flops a sample is far
// below the fp32 rate.  Design: one thread per output sample, a row split
// into tiles of FIR_THREADS (grid = B * tiles, so B may pass gridDim.y's
// 65535).  Neighbouring threads read neighbouring samples, so each of the
// K shifted reads is coalesced and all but the first hit L1: device memory
// sees each input byte about once.  The taps are read through the
// read-only path, the same K words for every thread.  The sum runs in the
// reference's order: h[0]*x[n], then + h[k]*x[n-k] for k = 1..K-1.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(FIR_THREADS)
real_fir_kernel(int N, int K, int tiles, const float* __restrict__ x,
                const float* __restrict__ h, float* __restrict__ y) {
  const size_t row = blockIdx.x / tiles;
  const int n = (blockIdx.x % tiles) * FIR_THREADS + threadIdx.x;
  if (n >= N) return;
  const float* xr = x + row * (size_t)N;
  float acc = __ldg(h) * __ldg(xr + n);
  const int kmax = K < n + 1 ? K : n + 1;       // taps that reach x[0..n]
  for (int k = 1; k < kmax; ++k) acc += __ldg(h + k) * __ldg(xr + n - k);
  y[row * (size_t)N + n] = acc;
}

// ---------------------------------------------------------------------------
// K9 vector_dot — replaces src/repro/kernels/dsp_vector.py vector_dot
// (_vdot_kernel, pl.pallas_call at dsp_vector.py:22).
//   out[b] = sum_n x[b, n] * y[b, n]
// Bound: 2*B*N*4 bytes read plus B*4 written (the pipeline passes one
// tensor twice, but 64 MiB does not stay in the 50 MB L2 between the two
// reads).  Design: one warp per row, 16-byte loads where the rows allow
// (N % 4 == 0 and 16-byte aligned pointers: 8 floats a lane at N = 256),
// then a shuffle reduction; a warp past the last row exits whole.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(DOT_THREADS)
vector_dot_kernel(int B, int N, int vec4, const float* __restrict__ x,
                  const float* __restrict__ y, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (DOT_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= (size_t)B) return;
  const float* xr = x + row * (size_t)N;
  const float* yr = y + row * (size_t)N;
  float acc = 0.f;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    const float4* y4 = reinterpret_cast<const float4*>(yr);
    for (int i = lane; i < N / 4; i += 32) {
      const float4 a = __ldg(x4 + i), b = __ldg(y4 + i);
      acc += a.x * b.x;
      acc += a.y * b.y;
      acc += a.z * b.z;
      acc += a.w * b.w;
    }
  } else {
    for (int i = lane; i < N; i += 32) acc += __ldg(xr + i) * __ldg(yr + i);
  }
  acc = warp_sum(acc);
  if (lane == 0) out[row] = acc;
}

// ---------------------------------------------------------------------------
// K12 correlation — replaces src/repro/kernels/dsp_vector.py correlation
// (_corr_kernel, pl.pallas_call at dsp_vector.py:83).
//   c[b, l] = sum_n x[b, n] * y[b, n + l - L], l = 0..2L (column 0 is lag
//   -L), y zero-padded by L on both sides.
// Bound: 2*B*N*4 bytes read plus B*(2L+1)*4 written; 2(2L+1)N flops a row
// is far below the fp32 rate at small L.  Design: one warp per row; the
// warp stages its x row and its zero-padded y row in shared memory (each
// byte read once from device memory, coalesced), then computes the 2L+1
// lag sums from shared memory, one shuffle reduction each.  Rows per
// block shrink for long frames so the block stays under 48 KB.
// ---------------------------------------------------------------------------
__global__ void correlation_kernel(int B, int N, int L,
                                   const float* __restrict__ x,
                                   const float* __restrict__ y,
                                   float* __restrict__ out) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = N + 2 * L;                       // padded y row
  const int lags = 2 * L + 1;
  const size_t row = (size_t)blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= (size_t)B) return;
  float* xs = smem + (size_t)warp * (N + W);
  float* ys = xs + N;
  const float* xr = x + row * (size_t)N;
  const float* yr = y + row * (size_t)N;
  for (int i = lane; i < N; i += 32) xs[i] = __ldg(xr + i);
  for (int i = lane; i < W; i += 32)
    ys[i] = (i >= L && i < L + N) ? __ldg(yr + i - L) : 0.f;
  __syncwarp();
  for (int l = 0; l < lags; ++l) {
    float acc = 0.f;
    for (int n = lane; n < N; n += 32) acc += xs[n] * ys[n + l];
    acc = warp_sum(acc);
    if (lane == 0) out[row * (size_t)lags + l] = acc;
  }
}

// ---------------------------------------------------------------------------
// K13 fft — replaces src/repro/kernels/dsp_spectral.py fft (_fft_kernel,
// pl.pallas_call at dsp_spectral.py:78; fft_256 is its 256-point case).
//   Radix-2 decimation-in-time FFT of (B, N, 2) re/im frames, N a power of
//   two: bit-reversal permutation, then log2 N stages of N/2 butterflies
//   with the caller's float32 (stages, N/2) twiddle tables.
// Bound: B*N*2*4 bytes read plus the same written; 5 N log2 N flops a
// frame is far below the fp32 rate.  Design: a frame lives in shared
// memory as re/im planes for all its stages, so device memory sees it
// once each way.  The reference's bit-reversal pre-pass (dsp_spectral.py
// :77, a separate gather over the whole batch) moves into the load: each
// thread reads consecutive samples (coalesced) and stores them at their
// bit-reversed place (__brev).  min(N/2, 256) threads per frame, each
// taking every tpf-th butterfly of a stage, __syncthreads() between
// stages; 256 / tpf frames a block (two at N = 256).  The butterfly and
// its twiddle index are the reference's: stage s has half-span m = 2^s,
// pair (g*2m + j, g*2m + j + m) uses twiddle j.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(FFT_THREADS)
fft_kernel(int B, int N, int bits, const float* __restrict__ x,
           const float* __restrict__ twr, const float* __restrict__ twi,
           float* __restrict__ out) {
  extern __shared__ float smem[];
  const int half = N >> 1;
  const int tpf = half < FFT_THREADS ? half : FFT_THREADS;
  const int fpb = FFT_THREADS / tpf;
  const int f = threadIdx.x / tpf, t = threadIdx.x % tpf;
  const size_t frame = (size_t)blockIdx.x * fpb + f;
  const bool live = frame < (size_t)B;
  float* re = smem + (size_t)f * 2 * N;
  float* im = re + N;
  if (live) {
    const float* xf = x + frame * 2 * (size_t)N;
    for (int i = t; i < N; i += tpf) {
      const int r = (int)(__brev((unsigned)i) >> (32 - bits));
      re[r] = __ldg(xf + 2 * i);
      im[r] = __ldg(xf + 2 * i + 1);
    }
  }
  __syncthreads();
  for (int s = 0; s < bits; ++s) {
    const int m = 1 << s;
    const float* wr_s = twr + (size_t)s * half;
    const float* wi_s = twi + (size_t)s * half;
    for (int b = t; b < half; b += tpf) {
      const int j = b & (m - 1);
      const int e = ((b >> s) << (s + 1)) + j;   // group * 2m + j
      const int o = e + m;
      const float wr = __ldg(wr_s + j), wi = __ldg(wi_s + j);
      const float orr = re[o], oii = im[o];
      const float tr = orr * wr - oii * wi;      // twiddled odd
      const float ti = orr * wi + oii * wr;
      const float er = re[e], ei = im[e];
      re[e] = er + tr;
      im[e] = ei + ti;
      re[o] = er - tr;
      im[o] = ei - ti;
    }
    __syncthreads();
  }
  if (live) {
    float* of = out + frame * 2 * (size_t)N;
    for (int i = t; i < N; i += tpf) {
      of[2 * i] = re[i];
      of[2 * i + 1] = im[i];
    }
  }
}

}  // namespace

extern "C" {

int dsp_real_fir(int B, int N, int K, void* x, void* h, void* y,
                 void* stream) {
  if (B > 0 && N > 0) {
    const int tiles = (N + FIR_THREADS - 1) / FIR_THREADS;
    const long long blocks = (long long)B * tiles;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    real_fir_kernel<<<(unsigned)blocks, FIR_THREADS, 0, (cudaStream_t)stream>>>(
        N, K, tiles, (const float*)x, (const float*)h, (float*)y);
  }
  return (int)cudaGetLastError();
}

int dsp_vector_dot(int B, int N, void* x, void* y, void* out, void* stream) {
  if (B > 0) {
    const int rows = DOT_THREADS / 32;
    const int vec4 = N % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)y % 16 == 0;
    vector_dot_kernel<<<(B + rows - 1) / rows, DOT_THREADS, 0,
                        (cudaStream_t)stream>>>(B, N, vec4, (const float*)x,
                                                (const float*)y, (float*)out);
  }
  return (int)cudaGetLastError();
}

int dsp_correlation(int B, int N, int L, void* x, void* y, void* out,
                    void* stream) {
  if (B > 0) {
    const size_t row_bytes = (size_t)(2 * N + 2 * L) * sizeof(float);
    int rows = CORR_WARPS;
    while (rows > 1 && rows * row_bytes > (size_t)SMEM_LIMIT) rows >>= 1;
    if (rows * row_bytes > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    correlation_kernel<<<(B + rows - 1) / rows, rows * 32, rows * row_bytes,
                         (cudaStream_t)stream>>>(B, N, L, (const float*)x,
                                                 (const float*)y, (float*)out);
  }
  return (int)cudaGetLastError();
}

int dsp_fft(int B, int N, void* x, void* twr, void* twi, void* out,
            void* stream) {
  if (N < 2 || (N & (N - 1))) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int bits = 31 - __builtin_clz((unsigned)N);
    const int half = N >> 1;
    const int tpf = half < FFT_THREADS ? half : FFT_THREADS;
    const int fpb = FFT_THREADS / tpf;
    const size_t smem = (size_t)fpb * 2 * N * sizeof(float);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    fft_kernel<<<(B + fpb - 1) / fpb, FFT_THREADS, smem,
                 (cudaStream_t)stream>>>(B, N, bits, (const float*)x,
                                         (const float*)twr, (const float*)twi,
                                         (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
