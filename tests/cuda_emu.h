// A CPU stand-in for the CUDA features csrc/hts_run.cu uses, so that its
// kernel can be compiled with g++ (C++20) and held against the per-phase
// loop where there is no card (tests/test_torch_run.py).  A block runs as
// blockDim.x std::threads; each warp shares a std::barrier, and every warp
// collective is a gather through it: all 32 lanes post a value, wait, read
// every lane's, wait.  A lane reaching a different collective than the
// others aborts (warp-divergent collectives are a fault on the card too).
// Shared memory is the block's buffer, returned by emu_smem().
#pragma once
#include <algorithm>
#include <barrier>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

using std::max;
using std::min;

#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(a, b)
#define __grid_constant__
#define __restrict__ __restrict
#define __align__(n) alignas(n)

struct EmuDim { unsigned x, y, z; };
inline thread_local EmuDim threadIdx, blockIdx;

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
