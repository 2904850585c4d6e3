// A CPU stand-in for the CUDA features the port's kernels use, so that
// their source can be compiled with g++ (C++20) and held against the plain
// versions where there is no card: csrc/hts_run.cu's kernel
// (tests/test_torch_run.py), K17's span of csrc/transformer.cu
// (tests/test_torch_transformer_kernels.py), and K5's, K7's and K8's
// (tests/test_torch_fir.py) and K12's (tests/test_torch_dsp.py) of
// csrc/dsp.cu.  A block runs as blockDim.x std::threads;
// each warp shares a std::barrier, and every warp collective is a gather
// through it: all 32 lanes post a value, wait, read every lane's, wait.  A
// lane reaching a different collective than the others aborts
// (warp-divergent collectives are a fault on the card too).  Shared memory
// is the block's buffer, returned by emu_smem(); emu_launch fills it with
// 0xff bytes (NaN as float) before each block, since the card leaves it
// undefined.  cp.async is a plain 16-byte copy, complete at once, so its
// commit and waits are no-ops; the emulation shows the kernel's logic, not
// its timing.  The card it reports has EMU_SMS multiprocessors, each
// holding one block of any kernel, so a persistent grid has EMU_SMS blocks
// and each walks several tiles.
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __grid_constant__
#define __restrict__ __restrict
#define __align__(n) alignas(n)

struct EmuDim { unsigned x, y, z; };
inline thread_local EmuDim threadIdx, blockIdx, blockDim, gridDim;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
// bfloat16 as the card stores it, rounded to nearest even like
// __float2bfloat16_rn (and torch)
struct __nv_bfloat16 { uint16_t bits; };
inline float __bfloat162float(__nv_bfloat16 v) {
  const uint32_t u = (uint32_t)v.bits << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if (std::isnan(f)) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}

struct EmuWarp {
  std::barrier<>* bar;
  unsigned long long slot[32];
  int tag[32];
};
inline thread_local EmuWarp* emu_warp;
inline thread_local std::barrier<>* emu_block;
inline thread_local unsigned char* emu_shared;
inline unsigned char* emu_smem() { return emu_shared; }

inline void emu_gather(unsigned long long v, int tag,
                       unsigned long long* out) {
  const int l = threadIdx.x & 31;
  emu_warp->slot[l] = v;
  emu_warp->tag[l] = tag;
  emu_warp->bar->arrive_and_wait();
  for (int i = 0; i < 32; ++i) {
    if (emu_warp->tag[i] != tag) {
      fprintf(stderr, "block %u: lanes %d and %d at different collectives\n",
              blockIdx.x, l, i);
      abort();
    }
    out[i] = emu_warp->slot[i];
  }
  emu_warp->bar->arrive_and_wait();
}

template <class T>
inline T emu_shfl(T v, int src, int tag) {
  unsigned long long raw = 0, all[32];
  memcpy(&raw, &v, sizeof(T));
  emu_gather(raw, tag, all);
  T out;
  memcpy(&out, &all[src & 31], sizeof(T));
  return out;
}
template <class T>
inline T __shfl_sync(unsigned, T v, int src) { return emu_shfl(v, src, 1); }
template <class T>
inline T __shfl_xor_sync(unsigned, T v, int mask) {
  return emu_shfl(v, (int)(threadIdx.x & 31) ^ mask, 9);
}
template <class T>
inline T __shfl_up_sync(unsigned, T v, unsigned d) {
  const int l = threadIdx.x & 31, s = l - (int)d;
  return emu_shfl(v, s < 0 ? l : s, 2);
}
inline unsigned __ballot_sync(unsigned, int p) {
  unsigned long long all[32];
  emu_gather(p ? 1 : 0, 3, all);
  unsigned r = 0;
  for (int i = 0; i < 32; ++i) r |= (all[i] ? 1u : 0u) << i;
  return r;
}
inline int __any_sync(unsigned m, int p) { return __ballot_sync(m, p) != 0; }
inline int __all_sync(unsigned m, int p) {
  return __ballot_sync(m, p) == 0xffffffffu;
}
template <class F>
inline unsigned emu_reduce(unsigned v, int tag, unsigned init, F f) {
  unsigned long long all[32];
  emu_gather(v, tag, all);
  for (int i = 0; i < 32; ++i) init = f(init, (unsigned)all[i]);
  return init;
}
inline int __reduce_add_sync(unsigned, int v) {
  return (int)emu_reduce(v, 4, 0u, [](unsigned a, unsigned b) {
    return a + b; });
}
inline int __reduce_min_sync(unsigned, int v) {
  return (int)emu_reduce(v, 5, (unsigned)INT_MAX, [](unsigned a, unsigned b) {
    return (unsigned)min((int)a, (int)b); });
}
inline int __reduce_max_sync(unsigned, int v) {
  return (int)emu_reduce(v, 6, (unsigned)INT_MIN, [](unsigned a, unsigned b) {
    return (unsigned)max((int)a, (int)b); });
}
inline unsigned __reduce_or_sync(unsigned, unsigned v) {
  return emu_reduce(v, 7, 0u, [](unsigned a, unsigned b) { return a | b; });
}
inline void __syncwarp(unsigned = 0xffffffffu) {
  unsigned long long all[32];
  emu_gather(0, 8, all);
}
inline void __syncthreads() { emu_block->arrive_and_wait(); }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __popcll(unsigned long long x) { return __builtin_popcountll(x); }
inline int __ffs(int x) { return __builtin_ffs(x); }
inline int __ffsll(long long x) { return __builtin_ffsll(x); }
template <class T>
inline T __ldg(const T* p) { return *p; }
// rounded float arithmetic, never contracted: one rounding an intrinsic
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmaf_rn(float a, float b, float c) { return std::fma(a, b, c); }

// cp.async: the copy lands at once, so committing and waiting are no-ops
inline void cp_async16(void* dst, const void* src) { memcpy(dst, src, 16); }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
inline void cp_async_wait_prior() {}

// the runtime calls a launch makes
using cudaStream_t = void*;
using cudaError_t = int;
enum {
  cudaSuccess = 0, cudaErrorInvalidValue = 1,
  cudaErrorInvalidConfiguration = 9,
  cudaFuncAttributeMaxDynamicSharedMemorySize, cudaDevAttrMultiProcessorCount
};
constexpr int EMU_SMS = 2;
inline int cudaGetLastError() { return 0; }
template <class F>
inline int cudaFuncSetAttribute(F*, int, int) { return 0; }
inline int cudaGetDevice(int* dev) { *dev = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMultiProcessorCount ? EMU_SMS : 0;
  return 0;
}
template <class F>
inline int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F*, int,
                                                         size_t) {
  *n = 1;
  return 0;
}

// kernel<<<grid, block, smem>>>(args...): blocks one after another, each
// as block.x threads (whole warps) over a fresh shared buffer
template <class... P, class... A>
inline void emu_launch(void (*kernel)(P...), dim3 grid, dim3 block,
                       size_t smem, A... args) {
  const unsigned nt = block.x * block.y * block.z;
  if (nt % 32 != 0 || block.y != 1 || block.z != 1) {
    fprintf(stderr, "emu_launch: blocks of whole warps in x only\n");
    abort();
  }
  std::vector<float4> sm(smem / 16 + 1);
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        memset(sm.data(), 0xff, sm.size() * sizeof(float4));
        std::barrier<> blk(nt);
        std::vector<std::unique_ptr<std::barrier<>>> bars;
        std::vector<EmuWarp> warps(nt / 32);
        for (unsigned w = 0; w < nt / 32; ++w) {
          bars.push_back(std::make_unique<std::barrier<>>(32));
          warps[w].bar = bars[w].get();
        }
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < nt; ++t)
          threads.emplace_back([&, t] {
            threadIdx = {t, 0, 0};
            blockIdx = {x, y, z};
            blockDim = {block.x, block.y, block.z};
            gridDim = {grid.x, grid.y, grid.z};
            emu_warp = &warps[t / 32];
            emu_block = &blk;
            emu_shared = reinterpret_cast<unsigned char*>(sm.data());
            kernel(args...);
          });
        for (auto& th : threads) th.join();
      }
}
