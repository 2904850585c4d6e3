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

constexpr int DOT_THREADS = 256;         // one warp per row: 8 rows a block
constexpr int ADD_THREADS = 256;
constexpr int MAX_THREADS = 256;         // one warp per row: 8 rows a block
constexpr int DCT_THREADS = 128;         // at most: column x row threads
constexpr int DCT_MAX_N = 128;
constexpr int CFIR_THREADS = 256;

// cp.async: 16- and 4-byte copies from device to shared memory that run
// while the thread goes on; commit groups the copies issued so far, and a
// wait blocks until all groups (or all but the newest) have landed
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n\tcp.async.wait_group 0;"
               ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prior() {  // all but newest
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// `kernel` (a function pointer: no template commas in the macro's
// arguments) on `grid` x `threads` with `smem` dynamic shared bytes.  A
// macro so that the K5, K7, K8 and K12 spans below also build with g++
// against tests/cuda_emu.h, which runs a launch's blocks on the CPU.
#define KERNEL_LAUNCH(kernel, grid, threads, smem, stream, ...) \
  kernel<<<grid, threads, smem, stream>>>(__VA_ARGS__)

__host__ __device__ inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// ==== helpers span: the K7, K8 and K12 tests build this before their spans
constexpr int SMEM_LIMIT = 48 * 1024;    // default-launch shared memory cap

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Copies `rows` rows of `vecs` float4s each, the first at `src`, one every
// `stride` floats, into shared memory at `dst`, one every `pitch` floats,
// by 16-byte cp.async (uncommitted).  The `nthreads` threads of the block
// take consecutive float4s of the rows (coalesced: whole rows, as K7 and
// K12 copy them, are one contiguous span), and each steps its row and
// column along without a divide.
__device__ __forceinline__ void stage_rows(float* dst, int pitch,
                                           const float* src, int stride,
                                           int rows, int vecs, int nthreads) {
  int r = (int)threadIdx.x / vecs, c = (int)threadIdx.x % vecs;
  const int dr = nthreads / vecs, dc = nthreads % vecs;
  for (int e = threadIdx.x; e < rows * vecs; e += nthreads) {
    cp_async16(dst + r * pitch + 4 * c, src + (size_t)r * stride + 4 * c);
    r += dr;
    c += dc;
    if (c >= vecs) {
      c -= vecs;
      ++r;
    }
  }
}

// The LMS and IIR kernels walk each frame in order, one thread a frame.
// A thread reading its own row would not coalesce with its neighbours, so
// a block stages samples of its frames through shared memory, walks them
// from there, writes each output over the sample it came from, and copies
// the outputs back; the filter state (weights, windows, histories) stays
// in registers across a row's tiles, so any N works.  stage_in / stage_out
// are the flat kernels' (K7's and K8's): SEQ_CHUNK samples of each of
// SEQ_ROWS frames at a time, a warp copying 32 consecutive floats of one
// row, a fixed 17 KB tile per array.
constexpr int SEQ_ROWS = 128;            // LMS, IIR: a thread a frame
constexpr int SEQ_CHUNK = 32;            // samples a frame, staged at a time
constexpr int SEQ_PITCH = SEQ_CHUNK + 1; // odd pitch: conflict-free row walks

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

// The packed LMS and IIR kernels (K7, K8) walk their frames on a
// persistent grid: as many blocks as fit on the card, at most one a row
// group, each block walking tiles of ROW_THREADS whole rows (or, past
// ROW_SPAN samples, ROW_SPAN-sample column tiles of them, the filter
// state carried in registers from one to the next) through a two-stage
// ring in shared memory: tile i+1 is copied by 16-byte cp.async while the
// threads walk tile i.  A tile of whole rows is one contiguous span, so
// the copy is coalesced.  The row pitch is an odd number of float4s, so
// each thread's float4 reads and writes of its own row are conflict-free.
// The outputs go over x in shared memory and leave by 16-byte stores.
// When d is x (one pointer) one array is staged.
constexpr int ROW_THREADS = 128;         // a thread a row of a tile
constexpr int ROW_SPAN = 64;             // samples of a row a tile

// a tile's columns, and its pitch (an odd float4 count)
__host__ __device__ inline int row_cols(int N) {
  return N < ROW_SPAN ? N : ROW_SPAN;
}
__host__ __device__ inline int row_pitch(int N) {
  return 4 * ((row_cols(N) / 4) | 1);
}
// shared bytes: two stages of one (d is x) or two arrays
inline size_t row_smem(int N, bool alias) {
  return sizeof(float) * 2 * (alias ? 1 : 2) * ROW_THREADS *
         (size_t)row_pitch(N);
}

// One thread a row of x (B, N): f.reset() at the row's start, then
// y[n] = f.step(x[n], d[n]) for n in order.  N a multiple of 4; x, d and
// y 16-byte aligned; `ring` is row_smem(N, x == d) bytes of shared memory.
template <class Frame>
__device__ void walk_row_tiles(long long B, int N, const float* x,
                               const float* d, float* y, float* ring,
                               Frame& f) {
  const bool alias = x == d;
  const int cols = row_cols(N), pitch = row_pitch(N);
  const int chunks = (N + cols - 1) / cols;      // tiles a row group
  const int plane = ROW_THREADS * pitch;         // one array of a stage
  const int stage = (alias ? 1 : 2) * plane;
  const long long groups = (B + ROW_THREADS - 1) / ROW_THREADS;
  const int t = threadIdx.x;

  // tile (g, j): rows g*ROW_THREADS.., columns j*cols..; copies uncommitted
  auto rows_of = [&](long long g) {
    return (int)min((long long)ROW_THREADS, B - g * ROW_THREADS);
  };
  auto load = [&](long long g, int j, float* st) {
    const size_t at = (size_t)g * ROW_THREADS * N + (size_t)j * cols;
    const int vecs = min(cols, N - j * cols) / 4;
    stage_rows(st, pitch, x + at, N, rows_of(g), vecs, ROW_THREADS);
    if (!alias)
      stage_rows(st + plane, pitch, d + at, N, rows_of(g), vecs, ROW_THREADS);
  };

  long long g = blockIdx.x;
  int j = 0;
  if (g < groups) load(g, 0, ring);
  for (int s = 0; g < groups; s ^= 1) {
    long long gn = g;                            // the tile after this one
    int jn = j + 1;
    if (jn == chunks) {
      jn = 0;
      gn += gridDim.x;
    }
    cp_async_wait_all();                         // this tile's copies
    __syncthreads();       // ... seen by all; the last tile's stores done
    if (gn < groups) load(gn, jn, ring + (s ^ 1) * stage);
    cp_async_commit();

    float* xs = ring + s * stage;
    const float* ds = alias ? xs : xs + plane;
    const int nrows = rows_of(g), c0 = j * cols, w4 = min(cols, N - c0) / 4;
    if (j == 0) f.reset();
    if (t < nrows) {
      float* xr = xs + t * pitch;
      const float* dr = ds + t * pitch;
      for (int c = 0; c < w4; ++c) {
        const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * c);
        const float4 dv =
            alias ? xv : *reinterpret_cast<const float4*>(dr + 4 * c);
        const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
        const float dq[4] = {dv.x, dv.y, dv.z, dv.w};
        float yq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) yq[q] = f.step(xq[q], dq[q]);
        *reinterpret_cast<float4*>(xr + 4 * c) =     // y over x
            make_float4(yq[0], yq[1], yq[2], yq[3]);
      }
    }
    __syncthreads();                             // the tile's outputs
    {
      // y's tile from shared memory, float4 e of its rows, as it came in
      float* dst = y + (size_t)g * ROW_THREADS * N + c0;
      int r = t / w4, c = t % w4;
      const int dr = ROW_THREADS / w4, dc = ROW_THREADS % w4;
      for (int e = t; e < nrows * w4; e += ROW_THREADS) {
        *reinterpret_cast<float4*>(dst + (size_t)r * N + 4 * c) =
            *reinterpret_cast<const float4*>(xs + r * pitch + 4 * c);
        r += dr;
        c += dc;
        if (c >= w4) {
          c -= w4;
          ++r;
        }
      }
    }
    g = gn;
    j = jn;
  }
}

// Launches `kern`, a kernel of ROW_THREADS threads around walk_row_tiles
// over B rows, on the persistent grid: as many blocks as the occupancy
// query fits on the card with `smem` shared bytes each, at most one a row
// group.  A failed query or launch returns its error.
template <class... P, class... A>
int launch_persistent(void (*kern)(P...), size_t smem, long long B,
                      cudaStream_t stream, A... args) {
  int err = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int dev = 0, sms = 0, per_sm = 0;
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (!err)
    err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kern, ROW_THREADS, smem);
  if (err) return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long groups = (B + ROW_THREADS - 1) / ROW_THREADS;
  const long long grid = min(groups, (long long)sms * per_sm);
  KERNEL_LAUNCH(kern, dim3((unsigned)grid), ROW_THREADS, smem, stream,
                args...);
  return (int)cudaGetLastError();
}

// ==== end of the helpers span

// ==== K5 span: tests/test_torch_fir.py builds from here
// ---------------------------------------------------------------------------
// K5 real_fir — replaces src/repro/kernels/dsp_fir.py real_fir
// (_real_fir_kernel, pl.pallas_call at dsp_fir.py:49).
//   y[b, n] = sum_k h[k] * x[b, n - k], zero fill for n - k < 0.
// Bound: B*N*4 bytes read plus B*N*4 written; 2K flops a sample is far
// below the fp32 rate.
// real_fir_packed, where N is a multiple of 4, x and y are 16-byte
// aligned and K <= FIR_MAX_TAPS: rows packed into blocks.  A block takes
// FIR_SPAN / N whole rows (25 rows of 40 in 1000 of its 1024 samples), or,
// for a row wider than FIR_SPAN, one FIR_SPAN-sample tile of it.  It
// stages its samples into shared memory by 16-byte cp.async, each row (or
// tile) behind a halo of fir_halo(K) >= K - 1 samples: zeros at a row's
// start (the reference's zero fill), the row's previous samples before a
// later tile.  Each thread then computes 4 consecutive outputs from a
// window of float4 reads, with the taps in registers (templated on the K
// the repo uses, 8 and 5; any other K from shared memory), and stores them
// as one float4.  real_fir_flat takes every other shape: one thread per
// output over the flat B*N samples, its K shifted reads coalesced and all
// but the first hitting L1.  Both sum in the reference's order, h[0]*x[n],
// then + h[k]*x[n-k] for k = 1..K-1 (the halo's zeros add h[k]*0, as the
// reference's padding does).
// ---------------------------------------------------------------------------
constexpr int FIR_THREADS = 256;
constexpr int FIR_SPAN = 4 * FIR_THREADS;   // samples a block
constexpr int FIR_MAX_TAPS = 32;            // the packed kernel's taps

// the halo before a row or tile: K - 1 samples rounded up to float4s
__host__ __device__ inline int fir_halo(int K) { return (K + 2) / 4 * 4; }

// KT > 0: exactly KT taps, in registers; KT == 0: K taps from shared memory
template <int KT>
__global__ void __launch_bounds__(FIR_THREADS)
real_fir_packed(long long B, int N, int K, int rows, int tiles,
                const float* __restrict__ x, const float* __restrict__ h,
                float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char fir_raw[];
  float* sh = reinterpret_cast<float*>(fir_raw);   // [FIR_MAX_TAPS] taps
  float* sx = sh + FIR_MAX_TAPS;                   // [rows][halo + L]
  const int taps = KT > 0 ? KT : K, halo = fir_halo(taps);
  const int L = tiles > 1 ? FIR_SPAN : N, pitch = halo + L;
  const long long row0 = (long long)(blockIdx.x / tiles) * rows;
  const int n0 = (int)(blockIdx.x % tiles) * FIR_SPAN;
  const int nrows = (int)min((long long)rows, B - row0);
  const int len = min(L, N - n0);                  // samples a row here
  const int vecs = (halo + len) / 4;               // float4s, halo included
  for (int e = threadIdx.x; e < nrows * vecs; e += FIR_THREADS) {
    const int rr = e / vecs, i = 4 * (e % vecs);
    const int n = n0 - halo + i;                   // the sample in its row
    float* dst = sx + rr * pitch + i;
    if (n < 0)
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    else
      cp_async16(dst, x + (row0 + rr) * N + n);
  }
  if (KT == 0 && (int)threadIdx.x < K) sh[threadIdx.x] = h[threadIdx.x];
  float hr[KT > 0 ? KT : 1];
#pragma unroll
  for (int k = 0; k < KT; ++k) hr[k] = __ldg(h + k);
  cp_async_wait_all();
  __syncthreads();
  const int groups = len / 4;                      // float4 outputs a row
  for (int g = threadIdx.x; g < nrows * groups; g += FIR_THREADS) {
    const int rr = g / groups, n = 4 * (g % groups);
    const float* s = sx + rr * pitch + halo + n;   // s[j] = x[n0 + n + j]
    float o[4];
    if constexpr (KT > 0) {
      constexpr int HK = (KT + 2) / 4 * 4;         // fir_halo(KT)
      float win[HK + 4];                           // win[m] = s[m - HK]
#pragma unroll
      for (int m = 0; m < HK + 4; m += 4) {
        const float4 v = *reinterpret_cast<const float4*>(s - HK + m);
        win[m] = v.x; win[m + 1] = v.y; win[m + 2] = v.z; win[m + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float acc = hr[0] * win[HK + q];
#pragma unroll
        for (int k = 1; k < KT; ++k) acc += hr[k] * win[HK + q - k];
        o[q] = acc;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float acc = sh[0] * s[q];
        for (int k = 1; k < K; ++k) acc += sh[k] * s[q - k];
        o[q] = acc;
      }
    }
    *reinterpret_cast<float4*>(y + (row0 + rr) * N + n0 + n) =
        make_float4(o[0], o[1], o[2], o[3]);
  }
}

__global__ void __launch_bounds__(FIR_THREADS)
real_fir_flat(size_t total, int N, int K, const float* __restrict__ x,
              const float* __restrict__ h, float* __restrict__ y) {
  const size_t i = (size_t)blockIdx.x * FIR_THREADS + threadIdx.x;
  if (i >= total) return;
  const int n = (int)(i % (size_t)N);
  float acc = __ldg(h) * __ldg(x + i);
  const int kmax = K < n + 1 ? K : n + 1;          // taps that reach x[0..n]
  for (int k = 1; k < kmax; ++k) acc += __ldg(h + k) * __ldg(x + i - k);
  y[i] = acc;
}

int launch_real_fir(int B, int N, int K, const float* x, const float* h,
                    float* y, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (N % 4 == 0 && K <= FIR_MAX_TAPS && (uintptr_t)x % 16 == 0 &&
      (uintptr_t)y % 16 == 0) {
    const int tiles = N > FIR_SPAN ? (N + FIR_SPAN - 1) / FIR_SPAN : 1;
    const int rows = N > FIR_SPAN ? 1 : FIR_SPAN / N;
    const long long blocks = ((long long)B + rows - 1) / rows * tiles;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    const size_t smem =
        sizeof(float) * (FIR_MAX_TAPS +
                         (size_t)rows * (fir_halo(K) +
                                         (tiles > 1 ? FIR_SPAN : N)));
    auto* kern = K == 8   ? &real_fir_packed<8>
                 : K == 5 ? &real_fir_packed<5>
                          : &real_fir_packed<0>;
    KERNEL_LAUNCH(kern, dim3((unsigned)blocks), FIR_THREADS, smem, stream,
                  (long long)B, N, K, rows, tiles, x, h, y);
  } else {
    const size_t total = (size_t)B * (size_t)N;
    const size_t blocks = (total + FIR_THREADS - 1) / FIR_THREADS;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    auto* kern = &real_fir_flat;
    KERNEL_LAUNCH(kern, dim3((unsigned)blocks), FIR_THREADS, 0, stream,
                  total, N, K, x, h, y);
  }
  return (int)cudaGetLastError();
}
// ==== end of the K5 span

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

// ==== K7 span: tests/test_torch_fir.py builds from here (after the helpers)
// ---------------------------------------------------------------------------
// K7 adaptive_fir — replaces src/repro/kernels/dsp_fir.py adaptive_fir
// (_adaptive_fir_kernel, pl.pallas_call at dsp_fir.py:123).
//   LMS per frame, weights w (K) from zero; for n = 0..N-1, with
//   win[k] = x[n - k] (zero fill): y[n] = sum_k w[k]*win[k],
//   e = d[n] - y[n], w[k] += (mu*e)*win[k].  Output y (B, N).
// Bound: x and d read, y written, B*N*12 bytes (B*N*8 when d is x, as the
// dispatch entry passes it); about 4K flops a sample.  The recursion is
// sequential in n, so one thread walks one frame, the K weights and the
// window in registers (LmsFilter<K>, K 4 and 8, the reference's).  Its
// arithmetic is cheap (about 26 instructions a sample); what costs is
// moving the frames, so the design is about data movement.
// adaptive_fir_packed, where N is a multiple of 4 and x, d, y are 16-byte
// aligned, is walk_row_tiles (the helpers span) on its persistent grid.
// adaptive_fir_flat takes every other shape: SEQ_ROWS frames a block,
// SEQ_CHUNK-sample chunks by 4-byte loads, x and d both staged.  Both run
// LmsFilter, so they agree bit for bit.
// ---------------------------------------------------------------------------
template <int K>
struct LmsFilter {
  float mu, w[K], win[K];

  __device__ void reset() {
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] = win[k] = 0.f;
  }
  // y[n] from x[n] and d[n]; the window and weights move on a sample
  __device__ float step(float xv, float dv) {
#pragma unroll
    for (int k = K - 1; k > 0; --k) win[k] = win[k - 1];
    win[0] = xv;
    float acc = w[0] * win[0];
#pragma unroll
    for (int k = 1; k < K; ++k) acc += w[k] * win[k];
    const float me = mu * (dv - acc);
#pragma unroll
    for (int k = 0; k < K; ++k) w[k] += me * win[k];
    return acc;
  }
};

template <int K>
__global__ void __launch_bounds__(SEQ_ROWS)
adaptive_fir_flat(int B, int N, float mu, const float* __restrict__ x,
                  const float* __restrict__ d, float* __restrict__ y) {
  __shared__ float xs[SEQ_ROWS * SEQ_PITCH];
  __shared__ float ds[SEQ_ROWS * SEQ_PITCH];
  const int t = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * SEQ_ROWS;
  const int rows = (size_t)B - r0 < (size_t)SEQ_ROWS ? (int)(B - r0) : SEQ_ROWS;
  LmsFilter<K> f{mu};
  f.reset();
  for (int c0 = 0; c0 < N; c0 += SEQ_CHUNK) {
    const int cols = N - c0 < SEQ_CHUNK ? N - c0 : SEQ_CHUNK;
    stage_in(xs, x, r0, rows, N, c0, cols);
    stage_in(ds, d, r0, rows, N, c0, cols);
    __syncthreads();
    if (t < rows) {
      float* xr = xs + t * SEQ_PITCH;
      const float* dr = ds + t * SEQ_PITCH;
      for (int c = 0; c < cols; ++c) xr[c] = f.step(xr[c], dr[c]);
    }
    __syncthreads();
    stage_out(xs, y, r0, rows, N, c0, cols);
    __syncthreads();                            // before the next chunk's copy
  }
}

template <int K>
__global__ void __launch_bounds__(ROW_THREADS)
adaptive_fir_packed(long long B, int N, float mu, const float* __restrict__ x,
                    const float* __restrict__ d, float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char lms_raw[];
  LmsFilter<K> f{mu};
  walk_row_tiles(B, N, x, d, y, reinterpret_cast<float*>(lms_raw), f);
}

int launch_adaptive_fir(int B, int N, int K, float mu, const float* x,
                        const float* d, float* y, cudaStream_t stream) {
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  if (N % 4 == 0 && aligned(x, 16) && aligned(d, 16) && aligned(y, 16)) {
    auto* kern = K == 4 ? &adaptive_fir_packed<4> : &adaptive_fir_packed<8>;
    return launch_persistent(kern, row_smem(N, x == d), B, stream,
                             (long long)B, N, mu, x, d, y);
  }
  // flat: SEQ_ROWS frames a block, SEQ_CHUNK samples at a time
  const unsigned blocks = (unsigned)(((size_t)B + SEQ_ROWS - 1) / SEQ_ROWS);
  auto* kern = K == 4 ? &adaptive_fir_flat<4> : &adaptive_fir_flat<8>;
  KERNEL_LAUNCH(kern, dim3(blocks), SEQ_ROWS, 0, stream, B, N, mu, x, d, y);
  return (int)cudaGetLastError();
}
// ==== end of the K7 span

// ==== K8 span: tests/test_torch_fir.py builds from here (after the helpers)
// ---------------------------------------------------------------------------
// K8 iir — replaces src/repro/kernels/dsp_fir.py iir (_iir_kernel,
// pl.pallas_call at dsp_fir.py:160).
//   y[n] = sum_j b[j]*x[n-j] - sum_{j>=1} a[j]*y[n-j], zero fill, a[0]
//   ignored (the reference assumes 1 and never divides by it); the two
//   sums are formed separately and then subtracted, as xwin @ b - ys @ a[1:].
// Bound: x read and y written, B*N*8 bytes; 2(Kb + Ka) flops a sample.
// The recursion is sequential in n, so one thread walks one frame; what
// costs is moving the frames, so the design is about data movement, as
// K7's is.  iir_packed, where max(Kb, Ka) <= IIR_REG_TAPS, N is a
// multiple of 4 and x, y are 16-byte aligned, is walk_row_tiles (the
// helpers span) on its persistent grid, one array staged.  iir_flat takes
// every other shape: SEQ_ROWS frames a block, SEQ_CHUNK-sample chunks by
// 4-byte loads.  Both keep the coefficients and both histories in
// registers (IirFilter<MT>: arrays of MT, fully unrolled, terms past Kb
// or Ka skipped): MT 8, and for iir_packed MT 2 where the filter is first
// order, as the dispatch entry's is, so that it shifts two registers a
// sample, not eight (0.0602-0.0610 ms against 0.0647-0.0651 at MT 8 on an
// H100 at 524288 x 40, tools/dsp_kernel_ab.py).  iir_flat<0> takes longer
// filters: the coefficients through the read-only cache, the histories
// read back from the frame itself (x from global memory, y from the
// staged chunk or the rows already stored), so no filter is too long.
// Every instance rounds alike: b[0]*x[n], then one fused multiply-add a
// tap, j = 1 up; a[1]*y[n-1], then one a tap, j = 2 up; then the
// difference; each an explicit intrinsic, so no instance's contraction
// differs and all agree bit for bit.
// ---------------------------------------------------------------------------
constexpr int IIR_REG_TAPS = 8;          // the register instances' bound

// One frame's filter: Kb <= MT and Ka <= MT coefficients and the
// histories xw[j] = x[n-j], yh[j] = y[n-1-j] in registers
template <int MT>
struct IirFilter {
  int Kb, Ka;
  float bc[MT], ac[MT], xw[MT], yh[MT];

  __device__ void load(const float* b, const float* a, int kb, int ka) {
    Kb = kb;
    Ka = ka;
#pragma unroll
    for (int j = 0; j < MT; ++j) {
      bc[j] = j < Kb ? __ldg(b + j) : 0.f;
      ac[j] = j < Ka ? __ldg(a + j) : 0.f;
    }
    reset();
  }
  __device__ void reset() {
#pragma unroll
    for (int j = 0; j < MT; ++j) xw[j] = yh[j] = 0.f;
  }
  // y[n] from x[n] (walk_row_tiles passes d, which is x); the histories
  // move on a sample
  __device__ float step(float in, float = 0.f) {
#pragma unroll
    for (int j = MT - 1; j > 0; --j) xw[j] = xw[j - 1];
    xw[0] = in;
    float fwd = __fmul_rn(bc[0], xw[0]);
#pragma unroll
    for (int j = 1; j < MT; ++j)
      if (j < Kb) fwd = __fmaf_rn(bc[j], xw[j], fwd);
    float back = __fmul_rn(ac[1], yh[0]);
#pragma unroll
    for (int j = 2; j < MT; ++j)
      if (j < Ka) back = __fmaf_rn(ac[j], yh[j - 1], back);
    const float v = __fsub_rn(fwd, back);
#pragma unroll
    for (int j = MT - 1; j > 0; --j) yh[j] = yh[j - 1];
    yh[0] = v;
    return v;
  }
};

// MT > 0: IirFilter<MT>; MT == 0: any Kb, Ka, the histories read back
template <int MT>
__global__ void __launch_bounds__(SEQ_ROWS)
iir_flat(int B, int N, int Kb, int Ka, const float* __restrict__ x,
         const float* __restrict__ b, const float* __restrict__ a,
         float* __restrict__ y) {
  __shared__ float xs[SEQ_ROWS * SEQ_PITCH];
  const int t = threadIdx.x;
  const size_t r0 = (size_t)blockIdx.x * SEQ_ROWS;
  const int rows = (size_t)B - r0 < (size_t)SEQ_ROWS ? (int)(B - r0) : SEQ_ROWS;
  IirFilter<(MT > 0 ? MT : 2)> f;
  if constexpr (MT > 0) f.load(b, a, Kb, Ka);
  const float* xg = x + (r0 + t) * N;            // this thread's frame
  const float* yg = y + (r0 + t) * N;
  for (int c0 = 0; c0 < N; c0 += SEQ_CHUNK) {
    const int cols = N - c0 < SEQ_CHUNK ? N - c0 : SEQ_CHUNK;
    stage_in(xs, x, r0, rows, N, c0, cols);
    __syncthreads();
    if (t < rows) {
      float* xr = xs + t * SEQ_PITCH;
      for (int c = 0; c < cols; ++c) {
        if constexpr (MT > 0) {
          xr[c] = f.step(xr[c]);                  // y[n] over x[n]
        } else {
          const int n = c0 + c;
          float fwd = __fmul_rn(__ldg(b), xr[c]);
          for (int j = 1; j < Kb; ++j)
            fwd = __fmaf_rn(__ldg(b + j), n >= j ? __ldg(xg + n - j) : 0.f,
                            fwd);
          // y[m]: this chunk's from shared memory, earlier ones stored
          auto past = [&](int m) {
            return m < 0 ? 0.f : m >= c0 ? xr[m - c0] : yg[m];
          };
          float back = __fmul_rn(__ldg(a + 1), past(n - 1));
          for (int j = 2; j < Ka; ++j)
            back = __fmaf_rn(__ldg(a + j), past(n - j), back);
          xr[c] = __fsub_rn(fwd, back);
        }
      }
    }
    __syncthreads();
    stage_out(xs, y, r0, rows, N, c0, cols);
    __syncthreads();              // the chunk stored, before the next copy
  }
}

template <int MT>
__global__ void __launch_bounds__(ROW_THREADS)
iir_packed(long long B, int N, int Kb, int Ka, const float* __restrict__ x,
           const float* __restrict__ b, const float* __restrict__ a,
           float* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char iir_raw[];
  IirFilter<MT> f;
  f.load(b, a, Kb, Ka);
  walk_row_tiles(B, N, x, x, y, reinterpret_cast<float*>(iir_raw), f);
}

// Kb >= 1, Ka >= 2 (any length); the route by shape and alignment only
int launch_iir(int B, int N, int Kb, int Ka, const float* x, const float* b,
               const float* a, float* y, cudaStream_t stream) {
  if (Kb < 1 || Ka < 2) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N <= 0) return (int)cudaGetLastError();
  const bool regs = (Kb > Ka ? Kb : Ka) <= IIR_REG_TAPS;
  if (regs && N % 4 == 0 && aligned(x, 16) && aligned(y, 16)) {
    auto* kern = Kb <= 2 && Ka <= 2 ? &iir_packed<2>
                                    : &iir_packed<IIR_REG_TAPS>;
    return launch_persistent(kern, row_smem(N, true), B, stream,
                             (long long)B, N, Kb, Ka, x, b, a, y);
  }
  // flat: SEQ_ROWS frames a block, SEQ_CHUNK samples at a time
  const unsigned blocks = (unsigned)(((size_t)B + SEQ_ROWS - 1) / SEQ_ROWS);
  auto* kern = regs ? &iir_flat<IIR_REG_TAPS> : &iir_flat<0>;
  KERNEL_LAUNCH(kern, dim3(blocks), SEQ_ROWS, 0, stream, B, N, Kb, Ka, x, b,
                a, y);
  return (int)cudaGetLastError();
}
// ==== end of the K8 span

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

// ==== K12 span: tests/test_torch_dsp.py builds from here (after the helpers)
// ---------------------------------------------------------------------------
// K12 correlation — replaces src/repro/kernels/dsp_vector.py correlation
// (_corr_kernel, pl.pallas_call at dsp_vector.py:83).
//   c[b, l] = sum_n x[b, n] * y[b, n + l - L], l = 0..2L (column 0 is lag
//   -L), y zero-padded by L on both sides.
// Bound: 2*B*N*4 bytes read (B*N*4 when y is x, as the dispatch entry
// passes it) plus B*(2L+1)*4 written; 2(2L+1)N flops a row is far below
// the fp32 rate at small L.
// correlation_packed<LT>, where L is 4 or 10 (the repo's), N is a multiple
// of 4, x, y and out are 16-byte aligned and a block's rows fit
// CORR_PACKED_SMEM: whole rows packed into blocks of CORR_THREADS threads.
// A block takes CORR_THREADS / tpr consecutive rows (one contiguous span
// of x and of y) and stages them into shared memory by 16-byte cp.async,
// each y row between zero halos (CorrShape.halo >= L floats before, the
// rest of the last window after).  When y is x (one pointer) one array is
// staged and x is read from the middle of the haloed rows.  Then tpr
// threads take a row (tpr = 1 at 64 samples; more for longer rows, so
// that the SMs hold enough threads): each walks float4 chunks of its row
// (chunks ts, ts + tpr, ...), keeps the 2L+1 lag sums in registers (four
// interleaved partials each, one a position of the float4, added at the
// end: short sequential sums), reads each x float4 once and a window of
// WIN4 y float4s (with tpr = 1 it slides: one new float4 a chunk), and
// does no shuffle until the tpr threads of a row add their sums (log2 tpr
// xor steps).  The row pitches are chosen so that the float4 walks of a
// quarter warp (8/tpr rows, tpr threads on consecutive float4s) hit eight
// distinct 16-byte bank groups.  The block's (rows, 2L+1) outputs are one
// contiguous span of out: they go through shared memory and leave by
// 16-byte stores.  correlation_flat takes every other shape: one warp a
// row, its x row and zero-padded y row in shared memory (4-byte loads),
// one shuffle reduction a lag; rows a block shrink for long frames so the
// block stays under 48 KB.  The sums' order differs from the plain
// version's; both are held to the reference tests' 1e-5.
// ---------------------------------------------------------------------------
constexpr int CORR_WARPS = 8;                // flat: a warp a row, 8 rows
constexpr int CORR_THREADS = 128;            // packed: threads a block
constexpr int CORR_PACKED_SMEM = 96 * 1024;  // packed: shared bytes at most

__global__ void correlation_flat(int B, int N, int L,
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

// the packed kernel's geometry at (N, L)
struct CorrShape {
  int tpr;        // threads a row: 1, 2, 4 or 8
  int rows;       // rows a block, CORR_THREADS / tpr
  int ypitch;     // floats a staged y row (halos included) takes
  int xpitch;     // floats a staged x row takes (y is not x)
};
// y float4s a chunk of 4 x samples reads, and the zeros before a y row
__host__ __device__ constexpr int corr_halo(int L) { return (L + 3) / 4 * 4; }
__host__ __device__ constexpr int corr_win4(int L) {
  return (corr_halo(L) - L + 2 * L + 7) / 4;
}
// the least pitch >= n4 float4s at which a quarter warp's float4 walks
// (8/tpr rows, tpr consecutive float4s each) are conflict-free: a row
// moves tpr 16-byte bank groups on, modulo 2 tpr
__host__ __device__ inline int corr_pitch4(int n4, int tpr) {
  if (tpr >= 8) return n4;
  const int m = 2 * tpr;
  return n4 + ((tpr - n4 % m) % m + m) % m;
}
inline CorrShape corr_shape(int N, int L) {
  const int n4 = N / 4;
  int tpr = 1;                                   // >= 16 float4s a thread
  while (tpr < 8 && n4 >= 32 * tpr) tpr *= 2;
  const int ylen = N - 4 + 4 * corr_win4(L);     // halos included
  return {tpr, CORR_THREADS / tpr, 4 * corr_pitch4(ylen / 4, tpr),
          4 * corr_pitch4(n4, tpr)};
}
inline size_t corr_smem(const CorrShape& s, bool alias) {
  return sizeof(float) * (size_t)s.rows * (s.ypitch + (alias ? 0 : s.xpitch));
}

template <int LT>
__global__ void __launch_bounds__(CORR_THREADS)
correlation_packed(long long B, int N, CorrShape s,
                   const float* __restrict__ x, const float* __restrict__ y,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char corr_raw[];
  constexpr int LAGS = 2 * LT + 1, HALO = corr_halo(LT), OFF = HALO - LT;
  constexpr int WIN4 = corr_win4(LT);
  constexpr int TAIL = 4 * WIN4 - 4 - HALO;     // zeros after a y row
  constexpr int Z4 = (HALO + TAIL) / 4;         // zero float4s a y row
  const bool alias = x == y;
  float* ys = reinterpret_cast<float*>(corr_raw);  // [rows][ypitch]
  float* xs = alias ? ys + HALO : ys + s.rows * s.ypitch;
  const int xp = alias ? s.ypitch : s.xpitch;
  const long long row0 = (long long)blockIdx.x * s.rows;
  const int nrows = (int)min((long long)s.rows, B - row0);
  const int n4 = N / 4, t = threadIdx.x;

  for (int e = t; e < nrows * Z4; e += CORR_THREADS) {  // the zero halos
    const int r = e / Z4, k = e % Z4;
    // before the samples, or after them: HALO + N + 4 (k - HALO / 4)
    const int c = k < HALO / 4 ? 4 * k : N + 4 * k;
    *reinterpret_cast<float4*>(ys + r * s.ypitch + c) =
        make_float4(0.f, 0.f, 0.f, 0.f);
  }
  stage_rows(ys + HALO, s.ypitch, y + row0 * N, N, nrows, n4, CORR_THREADS);
  if (!alias)
    stage_rows(xs, s.xpitch, x + row0 * N, N, nrows, n4, CORR_THREADS);
  cp_async_wait_all();
  __syncthreads();

  // thread ts of row tr: ys[tr][p] = y[p - HALO], so the window of chunk c
  // is win[i] = ys[tr][4c + i] and x[4c + q] * ypad[4c + q + l] is
  // xq[q] * win[q + l + OFF]
  const int tr = t / s.tpr, ts = t % s.tpr;
  float acc[LAGS][4];
#pragma unroll
  for (int l = 0; l < LAGS; ++l)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[l][q] = 0.f;
  if (tr < nrows) {
    const float* xr = xs + tr * xp;
    const float* yr = ys + tr * s.ypitch;
    float win[4 * WIN4];
    for (int c = ts; c < n4; c += s.tpr) {
      if (s.tpr == 1 && c > 0) {                 // slide by one float4
#pragma unroll
        for (int i = 0; i < 4 * (WIN4 - 1); ++i) win[i] = win[i + 4];
        const float4 v =
            *reinterpret_cast<const float4*>(yr + 4 * (c + WIN4 - 1));
        win[4 * WIN4 - 4] = v.x;
        win[4 * WIN4 - 3] = v.y;
        win[4 * WIN4 - 2] = v.z;
        win[4 * WIN4 - 1] = v.w;
      } else {
#pragma unroll
        for (int k = 0; k < WIN4; ++k) {
          const float4 v = *reinterpret_cast<const float4*>(yr + 4 * (c + k));
          win[4 * k] = v.x;
          win[4 * k + 1] = v.y;
          win[4 * k + 2] = v.z;
          win[4 * k + 3] = v.w;
        }
      }
      const float4 xv = *reinterpret_cast<const float4*>(xr + 4 * c);
      const float xq[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int l = 0; l < LAGS; ++l) acc[l][q] += xq[q] * win[q + l + OFF];
    }
  }
  float v[LAGS];
#pragma unroll
  for (int l = 0; l < LAGS; ++l) {
    v[l] = (acc[l][0] + acc[l][1]) + (acc[l][2] + acc[l][3]);
    for (int o = 1; o < s.tpr; o <<= 1)          // the row's threads, whole
      v[l] += __shfl_xor_sync(0xffffffffu, v[l], o);
  }
  __syncthreads();                               // every read of the rows

  // the block's outputs, one contiguous span, through shared memory
  float* os = ys;                                // [rows][LAGS]
  if (tr < nrows) {
#pragma unroll
    for (int l = 0; l < LAGS; ++l)
      if ((l & (s.tpr - 1)) == ts) os[tr * LAGS + l] = v[l];
  }
  __syncthreads();
  float* dst = out + row0 * LAGS;
  const int total = nrows * LAGS;                // rows % 4 == 0: aligned
  for (int e = t; e < total / 4; e += CORR_THREADS)
    *reinterpret_cast<float4*>(dst + 4 * e) =
        *reinterpret_cast<const float4*>(os + 4 * e);
  for (int e = total / 4 * 4 + t; e < total; e += CORR_THREADS)
    dst[e] = os[e];
}

int launch_correlation(int B, int N, int L, const float* x, const float* y,
                       float* out, cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  const CorrShape s = corr_shape(N, L);
  const size_t smem = corr_smem(s, x == y);
  if ((L == 4 || L == 10) && N % 4 == 0 && aligned(x, 16) && aligned(y, 16) &&
      aligned(out, 16) && smem <= (size_t)CORR_PACKED_SMEM) {
    // packed: whole rows a block, tpr threads a row
    auto* kern = L == 4 ? &correlation_packed<4> : &correlation_packed<10>;
    const int err = (int)cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err) return err;
    const long long blocks = ((long long)B + s.rows - 1) / s.rows;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    KERNEL_LAUNCH(kern, dim3((unsigned)blocks), CORR_THREADS, smem, stream,
                  (long long)B, N, s, x, y, out);
  } else {
    // flat: a warp a row, as many rows a block as fit 48 KB
    const size_t row_bytes = (size_t)(2 * N + 2 * L) * sizeof(float);
    int rows = CORR_WARPS;
    while (rows > 1 && rows * row_bytes > (size_t)SMEM_LIMIT) rows >>= 1;
    if (rows * row_bytes > (size_t)SMEM_LIMIT)
      return (int)cudaErrorInvalidValue;
    auto* kern = &correlation_flat;
    KERNEL_LAUNCH(kern, dim3((unsigned)((B + rows - 1) / rows)), rows * 32,
                  rows * row_bytes, stream, B, N, L, x, y, out);
  }
  return (int)cudaGetLastError();
}
// ==== end of the K12 span

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
  if (K < 1) return (int)cudaErrorInvalidValue;
  return launch_real_fir(B, N, K, (const float*)x, (const float*)h,
                         (float*)y, (cudaStream_t)stream);
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

// K must be 4 or 8 (the kernels' template instances).
int dsp_adaptive_fir(int B, int N, int K, float mu, void* x, void* d,
                     void* y, void* stream) {
  if (K != 4 && K != 8) return (int)cudaErrorInvalidValue;
  return launch_adaptive_fir(B, N, K, mu, (const float*)x, (const float*)d,
                             (float*)y, (cudaStream_t)stream);
}

// Kb >= 1, Ka >= 2.
int dsp_iir(int B, int N, int Kb, int Ka, void* x, void* b, void* a,
            void* y, void* stream) {
  return launch_iir(B, N, Kb, Ka, (const float*)x, (const float*)b,
                    (const float*)a, (float*)y, (cudaStream_t)stream);
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
  return launch_correlation(B, N, L, (const float*)x, (const float*)y,
                            (float*)out, (cudaStream_t)stream);
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
