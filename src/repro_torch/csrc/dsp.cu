// The DSP accelerators of the paper's Table II, for Hopper (sm_90a): real
// FIR, complex FIR, adaptive (LMS) FIR, IIR, vector dot, vector add,
// vector max, cross-correlation, the radix-2 FFT and the DCT-II.
//
// Each kernel replaces one of the reference's Pallas kernels
// (src/repro/kernels/dsp_fir.py, dsp_vector.py, dsp_spectral.py) and
// computes the same function on float32 frames laid out as the reference
// lays them out: (B, N) rows, or (B, N, 2) interleaved re/im for the FFT
// and the complex FIR.  The reference tiles the batch into blocks of BB
// rows and the wrapper pads B up to a multiple of BB; here each kernel
// computes its own offsets (64-bit, so no batch size overflows them) and
// masks the ragged batch edge itself, so nothing is padded.
//
// At the pipelines' shapes (the audio's 65536 frames of 256 samples, the
// image's 262144 tiles of 64 pixels, Table II's 524288 frames of 40
// samples) all ten are bound by device-memory bytes: each but the DCT
// does a few flops per byte it moves, far below the card's fp32 rate, and
// the DCT's 64 multiply-adds a pixel come to 0.8 of its bytes bound.  Each
// is written to stream its bytes once, coalesced; tiling through TMA and
// tuning are later work.  Every float constant (FIR taps, FFT twiddles,
// the DCT matrix, the LMS step) comes from the caller: nothing here calls
// device trig, and the library is built without --use_fast_math.
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
constexpr int ADD_THREADS = 256;
constexpr int MAX_THREADS = 256;         // one warp per row: 8 rows a block
constexpr int DCT_THREADS = 128;         // at most: column x row threads
constexpr int DCT_MAX_N = 128;
constexpr int SMEM_LIMIT = 48 * 1024;    // default-launch shared memory cap
constexpr int CFIR_THREADS = 256;
constexpr int SEQ_ROWS = 128;            // LMS, IIR: a thread a frame
constexpr int SEQ_CHUNK = 32;            // samples a frame, staged at a time
constexpr int SEQ_PITCH = SEQ_CHUNK + 1; // odd pitch: conflict-free row walks
constexpr int IIR_MAX_TAPS = 8;

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
// K6 complex_fir — replaces src/repro/kernels/dsp_fir.py complex_fir
// (_complex_fir_kernel, pl.pallas_call at dsp_fir.py:82).
//   y[b, n] = sum_k h[k] * x[b, n - k] in complex arithmetic, x (B, N, 2)
//   and y interleaved re/im, h (K, 2), zero fill for n - k < 0.
// Bound: B*N*8 bytes read plus B*N*8 written; 8K flops a sample is far
// below the fp32 rate.  Design: one thread per output sample over the
// flat B*N samples (a row of 40 would leave most of a row-tile idle), the
// re/im pair read as one float2; neighbouring threads read neighbouring
// pairs, so the K shifted reads are coalesced and all but the first hit
// L1.  Every product and sum is rounded on its own, in the Pallas order:
//   ar = h00*xr - h01*xi,  ai = h00*xi + h01*xr,  then per tap
//   ar = (ar + hk0*sr) - hk1*si,  ai = (ai + hk0*si) + hk1*sr.
// __fmul_rn/__fadd_rn/__fsub_rn are never contracted into FMAs (a global
// -fmad=false would change the other kernels): with the dispatch entry's
// x + jx and equal taps the real part is then exactly zero, as in the
// reference.  Taps that reach before the frame add h*0 there; skipping
// them leaves every value equal.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CFIR_THREADS)
complex_fir_kernel(size_t total, int N, int K, const float2* __restrict__ x,
                   const float2* __restrict__ h, float2* __restrict__ y) {
  const size_t i = (size_t)blockIdx.x * CFIR_THREADS + threadIdx.x;
  if (i >= total) return;
  const int n = (int)(i % (size_t)N);
  const float2 h0 = __ldg(h), x0 = __ldg(x + i);
  float ar = __fsub_rn(__fmul_rn(h0.x, x0.x), __fmul_rn(h0.y, x0.y));
  float ai = __fadd_rn(__fmul_rn(h0.x, x0.y), __fmul_rn(h0.y, x0.x));
  const int kmax = K < n + 1 ? K : n + 1;       // taps that reach x[0..n]
  for (int k = 1; k < kmax; ++k) {
    const float2 hk = __ldg(h + k), s = __ldg(x + i - k);
    ar = __fsub_rn(__fadd_rn(ar, __fmul_rn(hk.x, s.x)), __fmul_rn(hk.y, s.y));
    ai = __fadd_rn(__fadd_rn(ai, __fmul_rn(hk.x, s.y)), __fmul_rn(hk.y, s.x));
  }
  y[i] = make_float2(ar, ai);
}

// The LMS and IIR kernels walk each frame in order, one thread a frame.
// A thread reading its own 160-byte row would not coalesce with its
// neighbours, so a block stages SEQ_CHUNK samples of each of its SEQ_ROWS
// frames through shared memory (a warp copies 32 consecutive floats of
// one row), walks them from there, writes each output over the sample it
// came from, and copies the outputs back the same way; the filter state
// (weights, windows, histories) stays in registers across chunks, so any
// N works with a fixed 17 KB tile per staged array.
__device__ __forceinline__ void stage_in(float* tile, const float* g,
                                         size_t r0, int rows, int N, int c0,
                                         int cols) {
  for (int e = threadIdx.x; e < rows * SEQ_CHUNK; e += SEQ_ROWS) {
    const int r = e / SEQ_CHUNK, c = e % SEQ_CHUNK;
    if (c < cols) tile[r * SEQ_PITCH + c] = __ldg(g + (r0 + r) * N + c0 + c);
  }
}

__device__ __forceinline__ void stage_out(const float* tile, float* g,
                                          size_t r0, int rows, int N, int c0,
                                          int cols) {
  for (int e = threadIdx.x; e < rows * SEQ_CHUNK; e += SEQ_ROWS) {
    const int r = e / SEQ_CHUNK, c = e % SEQ_CHUNK;
    if (c < cols) g[(r0 + r) * N + c0 + c] = tile[r * SEQ_PITCH + c];
  }
}

// ---------------------------------------------------------------------------
// K7 adaptive_fir — replaces src/repro/kernels/dsp_fir.py adaptive_fir
// (_adaptive_fir_kernel, pl.pallas_call at dsp_fir.py:123).
//   LMS per frame, weights w (K) from zero; for n = 0..N-1, with
//   win[k] = x[n - k] (zero fill): y[n] = sum_k w[k]*win[k],
//   e = d[n] - y[n], w[k] += (mu*e)*win[k].  Output y (B, N).
// Bound: x and d read, y written, B*N*12 bytes; about 4K flops a sample.
// Design: one thread a frame, the K weights and the window in registers
// (K a template parameter: 4 and 8, the reference's), sequential over the
// frame, staged through shared memory as above (x and d in, y out over x).
// ---------------------------------------------------------------------------
template <int K>
__global__ void __launch_bounds__(SEQ_ROWS)
adaptive_fir_kernel(int B, int N, float mu, const float* __restrict__ x,
                    const float* __restrict__ d, float* __restrict__ y) {
  __shared__ float xs[SEQ_ROWS * SEQ_PITCH];
  __shared__ float ds[SEQ_ROWS * SEQ_PITCH];
  const int t = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * SEQ_ROWS;
  const int rows = (size_t)B - r0 < (size_t)SEQ_ROWS ? (int)(B - r0) : SEQ_ROWS;
  float w[K], win[K];
#pragma unroll
  for (int k = 0; k < K; ++k) w[k] = win[k] = 0.f;
  for (int c0 = 0; c0 < N; c0 += SEQ_CHUNK) {
    const int cols = N - c0 < SEQ_CHUNK ? N - c0 : SEQ_CHUNK;
    stage_in(xs, x, r0, rows, N, c0, cols);
    stage_in(ds, d, r0, rows, N, c0, cols);
    __syncthreads();
    if (t < rows) {
      float* xr = xs + t * SEQ_PITCH;
      const float* dr = ds + t * SEQ_PITCH;
      for (int c = 0; c < cols; ++c) {
#pragma unroll
        for (int k = K - 1; k > 0; --k) win[k] = win[k - 1];
        win[0] = xr[c];
        float acc = w[0] * win[0];
#pragma unroll
        for (int k = 1; k < K; ++k) acc += w[k] * win[k];
        const float me = mu * (dr[c] - acc);
#pragma unroll
        for (int k = 0; k < K; ++k) w[k] += me * win[k];
        xr[c] = acc;                            // y[n] over x[n]
      }
    }
    __syncthreads();
    stage_out(xs, y, r0, rows, N, c0, cols);
    __syncthreads();                            // before the next chunk's copy
  }
}

// ---------------------------------------------------------------------------
// K8 iir — replaces src/repro/kernels/dsp_fir.py iir (_iir_kernel,
// pl.pallas_call at dsp_fir.py:160).
//   y[n] = sum_j b[j]*x[n-j] - sum_{j>=1} a[j]*y[n-j], zero fill, a[0]
//   ignored (the reference assumes 1 and never divides by it); the two
//   sums are formed separately and then subtracted, as xwin @ b - ys @ a[1:].
// Bound: x read and y written, B*N*8 bytes; 2(Kb + Ka) flops a sample.
// Design: one thread a frame, staged as K7; the Kb newest inputs, the
// Ka-1 newest outputs and both coefficient sets in registers (arrays of
// IIR_MAX_TAPS, fully unrolled, terms past Kb or Ka masked).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(SEQ_ROWS)
iir_kernel(int B, int N, int Kb, int Ka, const float* __restrict__ x,
           const float* __restrict__ b, const float* __restrict__ a,
           float* __restrict__ y) {
  __shared__ float xs[SEQ_ROWS * SEQ_PITCH];
  const int t = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * SEQ_ROWS;
  const int rows = (size_t)B - r0 < (size_t)SEQ_ROWS ? (int)(B - r0) : SEQ_ROWS;
  float bc[IIR_MAX_TAPS], ac[IIR_MAX_TAPS], xw[IIR_MAX_TAPS],
      yh[IIR_MAX_TAPS];                         // yh[j] = y[n-1-j]
#pragma unroll
  for (int j = 0; j < IIR_MAX_TAPS; ++j) {
    bc[j] = j < Kb ? __ldg(b + j) : 0.f;
    ac[j] = j < Ka ? __ldg(a + j) : 0.f;
    xw[j] = yh[j] = 0.f;
  }
  for (int c0 = 0; c0 < N; c0 += SEQ_CHUNK) {
    const int cols = N - c0 < SEQ_CHUNK ? N - c0 : SEQ_CHUNK;
    stage_in(xs, x, r0, rows, N, c0, cols);
    __syncthreads();
    if (t < rows) {
      float* xr = xs + t * SEQ_PITCH;
      for (int c = 0; c < cols; ++c) {
#pragma unroll
        for (int j = IIR_MAX_TAPS - 1; j > 0; --j) xw[j] = xw[j - 1];
        xw[0] = xr[c];
        float fwd = bc[0] * xw[0];
#pragma unroll
        for (int j = 1; j < IIR_MAX_TAPS; ++j)
          if (j < Kb) fwd += bc[j] * xw[j];
        float back = ac[1] * yh[0];
#pragma unroll
        for (int j = 2; j < IIR_MAX_TAPS; ++j)
          if (j < Ka) back += ac[j] * yh[j - 1];
        const float v = fwd - back;
#pragma unroll
        for (int j = IIR_MAX_TAPS - 1; j > 0; --j) yh[j] = yh[j - 1];
        yh[0] = v;
        xr[c] = v;                              // y[n] over x[n]
      }
    }
    __syncthreads();
    stage_out(xs, y, r0, rows, N, c0, cols);
    __syncthreads();
  }
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
// K10 vector_add — replaces src/repro/kernels/dsp_vector.py vector_add
// (_vadd_kernel, pl.pallas_call at dsp_vector.py:40).
//   out[e] = x[e] + y[e] over the B*N elements, one fp32 add each: bit for
//   bit x + y.
// Bound: 2*B*N*4 bytes read plus B*N*4 written (the pipeline passes one
// tensor as x and y, but 64 MiB does not stay in the 50 MB L2 between the
// two reads).  Design: a grid-stride pass over the flat elements with
// 16-byte loads and stores where B*N % 4 == 0 and all three pointers are
// 16-byte aligned, scalar ones otherwise.  x and y are only read, so the
// pipeline's y == x aliasing is safe under __restrict__; out is the
// wrapper's fresh tensor.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(ADD_THREADS)
vector_add_kernel(size_t n, int vec4, const float* __restrict__ x,
                  const float* __restrict__ y, float* __restrict__ out) {
  const size_t stride = (size_t)gridDim.x * ADD_THREADS;
  size_t i = (size_t)blockIdx.x * ADD_THREADS + threadIdx.x;
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* y4 = reinterpret_cast<const float4*>(y);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (; i < n / 4; i += stride) {
      const float4 a = __ldg(x4 + i), b = __ldg(y4 + i);
      o4[i] = make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
    }
  } else {
    for (; i < n; i += stride) out[i] = __ldg(x + i) + __ldg(y + i);
  }
}

// ---------------------------------------------------------------------------
// K11 vector_max — replaces src/repro/kernels/dsp_vector.py vector_max
// (_vmax_kernel, pl.pallas_call at dsp_vector.py:57).
//   out[b] = max_n x[b, n], a NaN anywhere in the row giving NaN (as
//   jnp.max and torch.amax do; fmaxf would drop it).
// Bound: B*N*4 bytes read plus B*4 written.  Design: one warp per row,
// 16-byte loads where N % 4 == 0 and the rows are 16-byte aligned (N = 64:
// 16 lanes of 4 floats; N = 256: 2 loads a lane), scalar loads otherwise,
// then a shuffle reduction with the same NaN-propagating max; a warp past
// the last row exits whole.  max is exact, so the order does not matter.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;            // a NaN in a or b wins
}

__global__ void __launch_bounds__(MAX_THREADS)
vector_max_kernel(int B, int N, int vec4, const float* __restrict__ x,
                  float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * (MAX_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= (size_t)B) return;
  const float* xr = x + row * (size_t)N;
  float m = __int_as_float(0xff800000);        // -inf
  if (vec4) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = lane; i < N / 4; i += 32) {
      const float4 a = __ldg(x4 + i);
      m = nan_max(nan_max(m, a.x), nan_max(a.y, nan_max(a.z, a.w)));
    }
  } else {
    for (int i = lane; i < N; i += 32) m = nan_max(m, __ldg(xr + i));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, o));
  if (lane == 0) out[row] = m;
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
//   Radix-2 decimation-in-time FFT of (B, N, 2) re/im frames, N = 2^L a
//   power of two: bit-reversal permutation, then L stages of N/2
//   butterflies with the float32 twiddles of the (stages, N/2) tables;
//   the caller passes their last row (N/2 entries), see below.
// Bound: B*N*8 bytes read plus the same written (0.080 ms at 65536 x 256);
// 5 N log2 N flops a frame are far below the fp32 rate.  So the design
// keeps a frame out of device memory between its stages and spends as
// little as it can on everything else:
//   Points in registers.  A thread holds R = 16 complex points of a frame
//   (N/16 threads a frame; for N < 16 one thread holds all N): those whose
//   index in the bit-reversed order differs only in four bits.  The four
//   stages that pair along those bits run on the registers with no
//   barrier (a pass); between passes the frame goes once through shared
//   memory (an exchange: each thread writes its 16 points, reads the 16
//   of the next pass).  N = 256: passes of stages 0-3 and 4-7, one
//   exchange; N = 4096: three passes.  When L is not a multiple of four the
//   last pass pairs along fewer bits and its thread holds a few bits below
//   them too.  A frame of N <= 512 lies in one warp, so its exchange syncs
//   the warp only.  The buffer holds a padding point after every 16, so
//   neither the exchange's writes nor its reads conflict in the banks.
//   Butterflies.  The reference's own: stage s (half-span m = 2^s) pairs
//   (e, e + m), twiddles the odd point by entry j = e mod m of row s, the
//   same expressions in the same order; only their grouping into passes
//   differs.  Row s's entry j equals the last row's entry j * 2^(L-1-s)
//   bit for bit (the same dyadic angle in float64 before the cast to
//   float32; tests/test_torch_dsp.py pins it for every N), so the kernel
//   takes that one row and the block stages it in shared memory, once.
//   Loads and stores.  The bit-reversal is folded into which points a
//   thread loads: in the first pass thread t's point u sits at index
//   rev(u) * N/16 + rev(t) of the input, so for each u a frame's threads
//   read one run of consecutive samples; the last pass stores runs of
//   consecutive samples too.  One 8-byte (re, im) load or store a point.
// ---------------------------------------------------------------------------
constexpr int FFT_BLOCK = 128;           // threads a block (more for N > 2048)
constexpr int FFT_MAX_BITS = 12;         // N <= 4096

// the pass structure of an N = 2^L point transform
template <int L> struct FftPlan {
  static constexpr int LR = L < 4 ? L : 4;             // bits a thread holds
  static constexpr int R = 1 << LR;                    // points a thread
  static constexpr int T = (1 << L) / R;               // threads a frame
  static constexpr int BT = T > FFT_BLOCK ? T : FFT_BLOCK;  // threads a block
  static constexpr int FPB = BT / T;                   // frames a block
  static constexpr int PASSES = (L + LR - 1) / LR;
  static constexpr int PADN = (1 << L) + ((1 << L) >> 4);  // buffer points
  static constexpr size_t SMEM =
      sizeof(float2) * ((size_t)(1 << L) / 2 +
                        (PASSES > 1 ? (size_t)FPB * PADN : 0));
  // pass p pairs along bits [lo, lo + w) of the bit-reversed index
  static __host__ __device__ constexpr int lo(int p) { return LR * p; }
  static __host__ __device__ constexpr int w(int p) {
    return L - LR * p < LR ? L - LR * p : LR;
  }
  // the thread's LR bits are [c, c + LR): the pass's bits and, below them,
  // LR - w filler bits
  static __host__ __device__ constexpr int c(int p) {
    return lo(p) - (LR - w(p));
  }
  // bit-reversed index of the thread's point u in pass p: u's low w bits
  // are the pass's bits, its high bits the filler; t fills the rest
  static __device__ __forceinline__ int idx(int p, int u, int t) {
    const int f = LR - w(p);
    const int pos = ((u & ((1 << w(p)) - 1)) << f) | (u >> w(p));
    return (t & ((1 << c(p)) - 1)) | (pos << c(p)) |
           ((t >> c(p)) << (c(p) + LR));
  }
};

__device__ __forceinline__ int fft_pad(int i) { return i + (i >> 4); }

template <int L>
__global__ void __launch_bounds__(FftPlan<L>::BT)
fft_kernel(int B, const float2* __restrict__ x, const float* __restrict__ twr,
           const float* __restrict__ twi, float2* __restrict__ out) {
  using P = FftPlan<L>;
  constexpr int N = 1 << L, R = P::R, T = P::T;
  extern __shared__ float2 fsm[];
  float2* tw = fsm;                                   // the last row, N/2
  float2* buf = fsm + N / 2 + (threadIdx.x / T) * P::PADN;
  const int t = threadIdx.x % T;
  const long long frame = (long long)blockIdx.x * P::FPB + threadIdx.x / T;
  const bool live = frame < B;

  for (int k = threadIdx.x; k < N / 2; k += P::BT)
    tw[k] = make_float2(twr[k], twi[k]);

  float2 v[R];
  const float2* xf = x + frame * N;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = P::idx(0, u, t);
    const int src = (int)(__brev((unsigned)i) >> (32 - L));
    v[u] = live ? xf[src] : make_float2(0.f, 0.f);
  }
  __syncthreads();                                    // the twiddles

#pragma unroll
  for (int p = 0; p < P::PASSES; ++p) {
    if (p > 0) {                                      // the exchange
      if (p > 1) {
        if (T <= 32) __syncwarp(); else __syncthreads();
      }
#pragma unroll
      for (int u = 0; u < R; ++u) buf[fft_pad(P::idx(p - 1, u, t))] = v[u];
      if (T <= 32) __syncwarp(); else __syncthreads();
#pragma unroll
      for (int u = 0; u < R; ++u) v[u] = buf[fft_pad(P::idx(p, u, t))];
    }
#pragma unroll
    for (int b = 0; b < P::w(p); ++b) {
      const int s = P::lo(p) + b;                     // the stage
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (u & (1 << b)) continue;
        const int ue = u, uo = u | (1 << b);
        const int j = P::idx(p, ue, t) & ((1 << s) - 1);
        const float2 wv = tw[j << (L - 1 - s)];
        const float orr = v[uo].x, oii = v[uo].y;
        const float tr = orr * wv.x - oii * wv.y;     // twiddled odd
        const float ti = orr * wv.y + oii * wv.x;
        const float er = v[ue].x, ei = v[ue].y;
        v[ue] = make_float2(er + tr, ei + ti);
        v[uo] = make_float2(er - tr, ei - ti);
      }
    }
  }

  if (live) {
    float2* of = out + frame * N;
#pragma unroll
    for (int u = 0; u < R; ++u) of[P::idx(P::PASSES - 1, u, t)] = v[u];
  }
}

template <int L>
int launch_fft(int B, const void* x, const void* twr, const void* twi,
               void* out, cudaStream_t stream) {
  using P = FftPlan<L>;
  if (P::SMEM > (size_t)SMEM_LIMIT) {
    static bool configured = false;
    if (!configured) {
      const cudaError_t err = cudaFuncSetAttribute(
          fft_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)P::SMEM);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
  }
  const long long blocks = ((long long)B + P::FPB - 1) / P::FPB;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  fft_kernel<L><<<(unsigned)blocks, P::BT, P::SMEM, stream>>>(
      B, (const float2*)x, (const float*)twr, (const float*)twi,
      (float2*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K14 dct — replaces src/repro/kernels/dsp_spectral.py dct (_dct_kernel,
// pl.pallas_call at dsp_spectral.py:110, an MXU matmul there).
//   out[b, k] = sum_i x[b, i] * m[k, i], with m the (N, N) DCT-II matrix,
//   row k the k-th basis vector (ref.dct_matrix): out = x @ m^T.
// Bound: B*N*4 bytes read plus the same written, against 2*B*N*N flops:
// at N = 64 the flops take 0.8 of the bytes' time, so only a kernel that
// overlaps its loads with multiply-adds near the fp32 rate approaches the
// bound.  Full fp32 on the CUDA cores, one fmaf per term in i order: TF32
// tensor cores keep about three digits and the reference tests the DCT at
// 1e-4.  Design: persistent CTAs, as many as fit on the card (two per SM
// at N = 64), at most one per tile.  Each loads the matrix into shared
// memory once, transposed (mt[i][k] = m[k][i], columns zero-padded to NP
// = 16 C), then walks tiles of R rows of x: tile t+1 is copied by cp.async
// into the second of two buffers while tile t is computed.  A thread owns
// 8 rows (ty + a TY: a warp's rows sit 16 bytes apart in the banks, the
// row pitch being round4(N) + 4 floats) x 8 columns (4 tx.. and NP/2 +
// 4 tx..) in registers; per 4 terms it reads its rows' x[i..i+3] and the
// matrix's 4 rows of its columns, 16 128-bit loads per 256 FMAs.  The
// outputs go straight from registers to memory: a warp's 16-byte stores
// cover 128 contiguous bytes of each of its rows, which measured faster
// than staging them through shared memory (PERF.md §6).  Where N is not a
// multiple of 4 or x or out is not 16-byte aligned, the copies and the
// stores move 4 bytes each.
// ---------------------------------------------------------------------------
template <int C>                                 // 16*C >= N columns
struct DctShape {
  static constexpr int NP = 16 * C;              // padded columns
  static constexpr int TX = 2 * C;               // 8 columns a thread
  static constexpr int TY = DCT_THREADS / TX;    // 8 rows a thread
  static constexpr int THREADS = TX * TY;
  static constexpr int R = 8 * TY;               // rows a tile
  static size_t smem(int N) {                    // matrix + two x tiles
    const int N4 = (N + 3) & ~3;
    return sizeof(float) * ((size_t)N4 * NP + 2 * (size_t)R * (N4 + 4));
  }
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;"
               ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but newest
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

template <int C>
__global__ void __launch_bounds__(DCT_THREADS, 1)
dct_kernel(int B, int N, int vec, const float* __restrict__ x,
           const float* __restrict__ m, float* __restrict__ out) {
  using S = DctShape<C>;
  extern __shared__ __align__(16) float smem[];
  const int N4 = (N + 3) & ~3, XP = N4 + 4;
  float* mt = smem;                              // [N4][NP]
  float* xb0 = smem + N4 * S::NP;                // [R][XP], twice
  float* xb1 = xb0 + S::R * XP;
  const int t = threadIdx.x, tx = t % S::TX, ty = t / S::TX;
  const int ntiles = (int)(((size_t)B + S::R - 1) / S::R);

  for (int e = t; e < N4 * S::NP; e += S::THREADS) {
    const int i = e / S::NP, k = e - i * S::NP;
    mt[e] = (i < N && k < N) ? __ldg(m + (size_t)k * N + i) : 0.f;
  }
  // x's columns N..N4-1 stay zero: those terms add fmaf(0, 0, acc)
  for (int e = t; e < 2 * S::R * (N4 - N); e += S::THREADS) {
    const int r = e / (N4 - N), i = N + e % (N4 - N);
    xb0[r * XP + i] = 0.f;                       // r < 2R spans both
  }

  auto rows_of = [&](int tile) {
    const size_t left = (size_t)B - (size_t)tile * S::R;
    return left < (size_t)S::R ? (int)left : S::R;
  };
  auto load = [&](int tile, float* buf) {
    const int rows = rows_of(tile);
    const float* src = x + (size_t)tile * S::R * N;
    if (vec) {
      const int q = N >> 2;                      // 16-byte chunks a row
      for (int e = t; e < rows * q; e += S::THREADS) {
        const int r = e / q, c = e - r * q;
        cp_async16(buf + r * XP + 4 * c, src + (size_t)r * N + 4 * c);
      }
    } else {
      for (int e = t; e < rows * N; e += S::THREADS) {
        const int r = e / N, i = e - r * N;
        cp_async4(buf + r * XP + i, src + e);
      }
    }
  };

  int tile = blockIdx.x;
  if (tile < ntiles) load(tile, xb0);
  cp_async_commit();
  float* cur = xb0;
  float* nxt = xb1;
  for (; tile < ntiles; tile += gridDim.x) {
    if (tile + (int)gridDim.x < ntiles) load(tile + gridDim.x, nxt);
    cp_async_commit();                           // (empty on the last)
    cp_async_wait_prior();                       // this tile's copies
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[a][c] = 0.f;
    const float* xr = cur + ty * XP;
    const float* mc = mt + 4 * tx;
#pragma unroll 2
    for (int i = 0; i < N4; i += 4) {
      float4 xv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a)
        xv[a] = *reinterpret_cast<const float4*>(xr + a * S::TY * XP + i);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* mrow = mc + (i + u) * S::NP;
        const float4 m0 = *reinterpret_cast<const float4*>(mrow);
        const float4 m1 = *reinterpret_cast<const float4*>(mrow + S::NP / 2);
#pragma unroll
        for (int a = 0; a < 8; ++a) {
          const float xa = lane4(xv[a], u);
          acc[a][0] = fmaf(xa, m0.x, acc[a][0]);
          acc[a][1] = fmaf(xa, m0.y, acc[a][1]);
          acc[a][2] = fmaf(xa, m0.z, acc[a][2]);
          acc[a][3] = fmaf(xa, m0.w, acc[a][3]);
          acc[a][4] = fmaf(xa, m1.x, acc[a][4]);
          acc[a][5] = fmaf(xa, m1.y, acc[a][5]);
          acc[a][6] = fmaf(xa, m1.z, acc[a][6]);
          acc[a][7] = fmaf(xa, m1.w, acc[a][7]);
        }
      }
    }
    __syncthreads();                             // all reads of the tile

    // the outputs straight from registers: at N = 64 a warp's 16-byte
    // stores cover 128 contiguous bytes of each of its 4 rows
    const int rows = rows_of(tile);
    float* dst = out + (size_t)tile * S::R * N;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int r = ty + a * S::TY;
      if (r >= rows) continue;
      float* orow = dst + (size_t)r * N;
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int k0 = 4 * tx + g * (S::NP / 2);
        if (vec && k0 + 4 <= N) {
          __stcs(reinterpret_cast<float4*>(orow + k0),
                 make_float4(acc[a][4 * g], acc[a][4 * g + 1],
                             acc[a][4 * g + 2], acc[a][4 * g + 3]));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (k0 + c < N) orow[k0 + c] = acc[a][4 * g + c];
        }
      }
    }
    float* swap = cur;
    cur = nxt;
    nxt = swap;
  }
}

template <int C>
cudaError_t launch_dct(int B, int N, const float* x, const float* m,
                       float* out, cudaStream_t stream) {
  using S = DctShape<C>;
  const size_t smem = S::smem(N);
  cudaError_t e = cudaFuncSetAttribute(
      dct_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, dct_kernel<C>, S::THREADS, smem)) != cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const size_t tiles = ((size_t)B + S::R - 1) / S::R;
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const size_t grid = tiles < (size_t)sms * per_sm ? tiles
                                                   : (size_t)sms * per_sm;
  const int vec = N % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                  (uintptr_t)out % 16 == 0;
  dct_kernel<C><<<(unsigned)grid, S::THREADS, smem, stream>>>(B, N, vec, x,
                                                              m, out);
  return cudaGetLastError();
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

// x, y: (B, N, 2) interleaved re/im; h: (K, 2).
int dsp_complex_fir(int B, int N, int K, void* x, void* h, void* y,
                    void* stream) {
  if (K < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)(B > 0 ? B : 0) * (size_t)(N > 0 ? N : 0);
  if (total > 0) {
    const size_t blocks = (total + CFIR_THREADS - 1) / CFIR_THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    complex_fir_kernel<<<(unsigned)blocks, CFIR_THREADS, 0,
                         (cudaStream_t)stream>>>(
        total, N, K, (const float2*)x, (const float2*)h, (float2*)y);
  }
  return (int)cudaGetLastError();
}

// K must be 4 or 8 (the kernel's template instances).
int dsp_adaptive_fir(int B, int N, int K, float mu, void* x, void* d,
                     void* y, void* stream) {
  if (K != 4 && K != 8) return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0) {
    const unsigned blocks =
        (unsigned)(((size_t)B + SEQ_ROWS - 1) / SEQ_ROWS);
    cudaStream_t s = (cudaStream_t)stream;
    const float* xf = (const float*)x;
    const float* df = (const float*)d;
    if (K == 4)
      adaptive_fir_kernel<4><<<blocks, SEQ_ROWS, 0, s>>>(B, N, mu, xf, df,
                                                         (float*)y);
    else
      adaptive_fir_kernel<8><<<blocks, SEQ_ROWS, 0, s>>>(B, N, mu, xf, df,
                                                         (float*)y);
  }
  return (int)cudaGetLastError();
}

// 1 <= Kb <= IIR_MAX_TAPS, 2 <= Ka <= IIR_MAX_TAPS.
int dsp_iir(int B, int N, int Kb, int Ka, void* x, void* b, void* a,
            void* y, void* stream) {
  if (Kb < 1 || Kb > IIR_MAX_TAPS || Ka < 2 || Ka > IIR_MAX_TAPS)
    return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0) {
    iir_kernel<<<(unsigned)(((size_t)B + SEQ_ROWS - 1) / SEQ_ROWS), SEQ_ROWS, 0,
                 (cudaStream_t)stream>>>(B, N, Kb, Ka, (const float*)x,
                                         (const float*)b, (const float*)a,
                                         (float*)y);
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

int dsp_vector_add(int B, int N, void* x, void* y, void* out,
                   void* stream) {
  const size_t n = (size_t)(B > 0 ? B : 0) * (size_t)(N > 0 ? N : 0);
  if (n > 0) {
    const int vec4 = n % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)y % 16 == 0 && (uintptr_t)out % 16 == 0;
    const size_t work = vec4 ? n / 4 : n;
    size_t blocks = (work + ADD_THREADS - 1) / ADD_THREADS;
    if (blocks > (1u << 20)) blocks = 1u << 20;   // grid-stride beyond
    vector_add_kernel<<<(unsigned)blocks, ADD_THREADS, 0,
                        (cudaStream_t)stream>>>(n, vec4, (const float*)x,
                                                (const float*)y, (float*)out);
  }
  return (int)cudaGetLastError();
}

int dsp_vector_max(int B, int N, void* x, void* out, void* stream) {
  if (N < 1) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    const int rows = MAX_THREADS / 32;
    const int vec4 = N % 4 == 0 && (uintptr_t)x % 16 == 0;
    vector_max_kernel<<<(B + rows - 1) / rows, MAX_THREADS, 0,
                        (cudaStream_t)stream>>>(B, N, vec4, (const float*)x,
                                                (float*)out);
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

// twr, twi: the last row (N/2 entries) of the (stages, N/2) twiddle tables
int dsp_fft(int B, int N, void* x, void* twr, void* twi, void* out,
            void* stream) {
  if (N < 2 || (N & (N - 1)) || N > (1 << FFT_MAX_BITS))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (31 - __builtin_clz((unsigned)N)) {
    case 1: return launch_fft<1>(B, x, twr, twi, out, s);
    case 2: return launch_fft<2>(B, x, twr, twi, out, s);
    case 3: return launch_fft<3>(B, x, twr, twi, out, s);
    case 4: return launch_fft<4>(B, x, twr, twi, out, s);
    case 5: return launch_fft<5>(B, x, twr, twi, out, s);
    case 6: return launch_fft<6>(B, x, twr, twi, out, s);
    case 7: return launch_fft<7>(B, x, twr, twi, out, s);
    case 8: return launch_fft<8>(B, x, twr, twi, out, s);
    case 9: return launch_fft<9>(B, x, twr, twi, out, s);
    case 10: return launch_fft<10>(B, x, twr, twi, out, s);
    case 11: return launch_fft<11>(B, x, twr, twi, out, s);
    default: return launch_fft<12>(B, x, twr, twi, out, s);
  }
}

// m: the (N, N) DCT-II matrix as ref.dct_matrix builds it (row k is the
// k-th basis vector), not its transpose; out = x @ m^T.
int dsp_dct(int B, int N, void* x, void* m, void* out, void* stream) {
  if (N < 1 || N > DCT_MAX_N) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const float* xf = (const float*)x;
  const float* mf = (const float*)m;
  float* of = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  switch ((N + 15) / 16) {
    case 1: return (int)launch_dct<1>(B, N, xf, mf, of, s);
    case 2: return (int)launch_dct<2>(B, N, xf, mf, of, s);
    case 3: return (int)launch_dct<3>(B, N, xf, mf, of, s);
    case 4: return (int)launch_dct<4>(B, N, xf, mf, of, s);
    case 5: return (int)launch_dct<5>(B, N, xf, mf, of, s);
    case 6: return (int)launch_dct<6>(B, N, xf, mf, of, s);
    case 7: return (int)launch_dct<7>(B, N, xf, mf, of, s);
    default: return (int)launch_dct<8>(B, N, xf, mf, of, s);
  }
}

}  // extern "C"
