// The HTS population step's four kernel phases, for Hopper (sm_90a).
//
// Each kernel replaces one of the reference's lane-per-program Pallas
// kernels (src/repro/core/hts/machine.py make_pop_step, driven through
// pallas_step.py lane_phase's pl.pallas_call) and keeps its mapping: one
// CTA per scenario lane (gridDim.x = lanes), working on that lane's rows
// in device memory.  A lane's state is int32 and bool (one byte, 0 or 1)
// arrays laid out lane-major, so lane i's row of an (N, K) array starts at
// i * K.  Each kernel writes, in place, exactly the arrays its reference
// kernel returns, and reproduces the reference's integer semantics bit
// for bit: ties in argmin/argmax go to the first index, a gather clamps
// its index like JAX, and a scatter to an index outside [0, U) is dropped
// (U is the reference's "no write" index).
//
// What bounds them at the machine's capacities (C = 1024 CDB slots,
// U = 1025 trace rows, S = 32 RS entries, 10 classes of Wc units): launch
// latency first, then a few tens of KB of a lane's rows read and written
// once.  A CTA reads its rows straight from device memory (coalesced
// across threads); the scratch that ranks and matches need sits in shared
// memory.  Fusing the four with the rest of the step into one persistent
// kernel is later work.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through ctypes (cuda_step.py).
// Every C entry launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

typedef unsigned char u8;

constexpr int BIG = 1 << 30;        // machine.py BIG
constexpr int PRIO_CAP = 1 << 12;   // policy.PRIO_CAP
constexpr int AGE_SPAN = 1 << 17;   // policy.AGE_SPAN
constexpr int BR_BR = 2;            // isa.BR_BR

constexpr int ENQ_THREADS = 256;
constexpr int GRANT_THREADS = 256;
constexpr int ISSUE_THREADS = 128;
constexpr int TRACE_THREADS = 64;

// JAX scatter index (mode="drop"): a negative index wraps once; whatever
// is then outside [0, n) writes nothing.
__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }
__device__ __forceinline__ bool in_range(int i, int n) { return 0 <= i && i < n; }

// JAX gather index: wrap once, then clamp into [0, n).
__device__ __forceinline__ int clamp_index(int i, int n) {
  i = wrap(i, n);
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__device__ __forceinline__ bool pair_less(int k1, int i1, int k2, int i2) {
  return k1 < k2 || (k1 == k2 && i1 < i2);
}

// Exclusive prefix sum of one int per thread over the block; *total gets
// the block's sum.  blockDim.x is a multiple of 32.  s_warp: 32 ints.
__device__ int block_exclusive_scan(int v, int* s_warp, int* total) {
  const int ln = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (ln >= o) x += y;
  }
  if (ln == 31) s_warp[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = ln < nw ? s_warp[ln] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (ln >= o) w += y;
    }
    if (ln < nw) s_warp[ln] = w;
  }
  __syncthreads();
  const int base = wid > 0 ? s_warp[wid - 1] : 0;
  *total = s_warp[nw - 1];
  __syncthreads();  // s_warp is free for the next call
  return base + x - v;
}

// Block-wide minimum of (key, index) pairs, smallest index among equal
// keys (jnp.argmin's first-index rule); the result reaches every thread.
__device__ void block_argmin(int* key, int* idx, int* s_k, int* s_i) {
  const int ln = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int k = *key, i = *idx;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const int k2 = __shfl_down_sync(0xffffffffu, k, o);
    const int i2 = __shfl_down_sync(0xffffffffu, i, o);
    if (pair_less(k2, i2, k, i)) { k = k2; i = i2; }
  }
  if (ln == 0) { s_k[wid] = k; s_i[wid] = i; }
  __syncthreads();
  if (wid == 0) {
    k = ln < nw ? s_k[ln] : INT_MAX;
    i = ln < nw ? s_i[ln] : INT_MAX;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const int k2 = __shfl_down_sync(0xffffffffu, k, o);
      const int i2 = __shfl_down_sync(0xffffffffu, i, o);
      if (pair_less(k2, i2, k, i)) { k = k2; i = i2; }
    }
    if (ln == 0) { s_k[0] = k; s_i[0] = i; }
  }
  __syncthreads();
  *key = s_k[0];
  *idx = s_i[0];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1 — replaces k_enqueue (machine.py cdb_enqueue, :380-421).
// The k-th done unit in FU-index order takes the k-th free CDB slot in
// slot order and ticket `ticket + k`; cdb_ready = cycle + completion_extra;
// overflow when more units finish than slots are free; tr_complete[uid] =
// cycle; the units are released.  Writes cdb_valid, cdb_uid, cdb_ticket,
// cdb_ready, cdb_spec, ticket, overflow, tr_complete, fu_busy, fu_uid.
// Two block scans (done units, free slots) stand in for the reference's
// cumsum + searchsorted; unit_of_rank (NFU ints) is in shared memory.
// Bound: launch latency, then the lane's C-wide CDB rows (~14 KB at C=1024).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(ENQ_THREADS)
enqueue_kernel(int C, int NFU, int U, int completion_extra,
               const u8* __restrict__ done, u8* __restrict__ cdb_valid,
               int* __restrict__ cdb_uid, int* __restrict__ cdb_ticket,
               int* __restrict__ cdb_ready, u8* __restrict__ cdb_spec,
               int* __restrict__ ticket, u8* __restrict__ overflow,
               const int* __restrict__ cycle, int* __restrict__ tr_complete,
               u8* __restrict__ fu_busy, int* __restrict__ fu_uid,
               const u8* __restrict__ fu_spec) {
  extern __shared__ int unit_of_rank[];  // NFU
  __shared__ int s_warp[32];
  const long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  done += lane * NFU;
  fu_busy += lane * NFU;
  fu_uid += lane * NFU;
  fu_spec += lane * NFU;
  cdb_valid += lane * C;
  cdb_uid += lane * C;
  cdb_ticket += lane * C;
  cdb_ready += lane * C;
  cdb_spec += lane * C;
  tr_complete += lane * U;
  const int cyc = cycle[lane];
  const int t0 = ticket[lane];

  // rank the done units: each thread owns a contiguous run of units
  int per = (NFU + nt - 1) / nt;
  int lo = min(tid * per, NFU), hi = min(lo + per, NFU);
  int cnt = 0;
  for (int i = lo; i < hi; ++i) cnt += done[i] != 0;
  int n_done;
  int r = block_exclusive_scan(cnt, s_warp, &n_done);
  for (int i = lo; i < hi; ++i)
    if (done[i]) unit_of_rank[r++] = i;

  // rank the free slots; the scan's barriers also publish unit_of_rank
  per = (C + nt - 1) / nt;
  lo = min(tid * per, C);
  hi = min(lo + per, C);
  cnt = 0;
  for (int s = lo; s < hi; ++s) cnt += cdb_valid[s] == 0;
  int n_free;
  r = block_exclusive_scan(cnt, s_warp, &n_free);
  const int n_enq = min(n_done, n_free);
  for (int s = lo; s < hi; ++s) {
    if (cdb_valid[s]) continue;
    if (r < n_enq) {
      const int u = unit_of_rank[r];
      cdb_valid[s] = 1;
      cdb_uid[s] = fu_uid[u];
      cdb_ticket[s] = t0 + r;
      cdb_ready[s] = cyc + completion_extra;
      cdb_spec[s] = fu_spec[u] ? 1 : 0;
    }
    ++r;
  }
  __syncthreads();  // every fu_uid read above precedes the release below
  if (tid == 0) {
    ticket[lane] = t0 + n_enq;
    if (n_done > n_free) overflow[lane] = 1;
  }
  for (int i = tid; i < NFU; i += nt) {
    if (!done[i]) continue;
    const int t = wrap(fu_uid[i], U);
    if (in_range(t, U)) tr_complete[t] = cyc;
    fu_busy[i] = 0;
    fu_uid[i] = 0;
  }
}

// ---------------------------------------------------------------------------
// K2 — replaces k_grant (machine.py cdb_grant(unroll=True), :434-462).
// Per grant (cdb_width of them): the ready entry (valid, cdb_ready <= cycle,
// lane alive) with the smallest ticket broadcasts its uid: its slot frees,
// rs_dep == uid clears, tracker entries of uid invalidate,
// tr_broadcast[uid] = cycle, and br_ready rises for a bus branch waiting
// on uid.  Writes cdb_valid, rs_dep, trk_valid, tr_broadcast, br_ready.
// One block argmin over (key, slot) pairs per grant, keys BIG off-ready,
// exactly the reference's argmin(where(ready, ticket, BIG)).
// Bound: launch latency, then one pass over the lane's C-wide CDB rows.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GRANT_THREADS)
grant_kernel(int C, int S, int T, int U, int cdb_width,
             u8* __restrict__ cdb_valid, const int* __restrict__ cdb_ready,
             const int* __restrict__ cdb_ticket,
             const int* __restrict__ cdb_uid, const int* __restrict__ cycle,
             const u8* __restrict__ alive, int* __restrict__ rs_dep,
             u8* __restrict__ trk_valid, const int* __restrict__ trk_uid,
             int* __restrict__ tr_broadcast, const u8* __restrict__ br_active,
             const int* __restrict__ br_kind, const int* __restrict__ br_wait,
             u8* __restrict__ br_ready) {
  __shared__ int s_k[32], s_i[32];
  const long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  cdb_valid += lane * C;
  cdb_ready += lane * C;
  cdb_ticket += lane * C;
  cdb_uid += lane * C;
  rs_dep += lane * S;
  trk_valid += lane * T;
  trk_uid += lane * T;
  tr_broadcast += lane * U;
  const int cyc = cycle[lane];
  const bool al = alive[lane] != 0;
  for (int g = 0; g < cdb_width; ++g) {
    int key = INT_MAX, idx = INT_MAX;
    int any = 0;
    for (int s = tid; s < C; s += nt) {
      const bool ready = al && cdb_valid[s] && cdb_ready[s] <= cyc;
      any |= ready;
      const int k = ready ? cdb_ticket[s] : BIG;
      if (pair_less(k, s, key, idx)) { key = k; idx = s; }
    }
    const int has = __syncthreads_or(any);
    block_argmin(&key, &idx, s_k, s_i);
    if (!has) continue;  // the same for every thread of the block
    const int uid = cdb_uid[idx];
    if (tid == 0) {
      cdb_valid[idx] = 0;
      const int t = wrap(uid, U);
      if (in_range(t, U)) tr_broadcast[t] = cyc;
      if (br_active[lane] && br_kind[lane] == BR_BR && br_wait[lane] == uid)
        br_ready[lane] = 1;
    }
    for (int e = tid; e < S; e += nt)
      if (rs_dep[e] == uid) rs_dep[e] = 0;
    for (int t = tid; t < T; t += nt)
      if (trk_uid[t] == uid) trk_valid[t] = 0;
    __syncthreads();  // the next grant reads cdb_valid
  }
}

// ---------------------------------------------------------------------------
// K3 — replaces k_issue (machine.py rs_issue_fast :613-661 + _issue_apply
// :540-562).  The weighted RS arbiter: issue key (PRIO_CAP - w) * AGE_SPAN
// + age over ready entries (BIG elsewhere); per-(pid, class) quota mask
// (units in flight plus ready same-(pid, class) entries ahead); rank within
// the class against its free units; the issue_width cap; then the k-th
// fired entry of a class takes the class's free unit of rank k by ckey
// (FU index, or cost-major under eft), which loads fu_*, fu_rem = exec *
// cost, tr_issue[uid] = cycle and leaves the RS.  Writes fu_busy, fu_uid,
// fu_rem, fu_out_s, fu_out_e, fu_src, fu_spec, fu_pid, tr_issue, rs_valid.
// Each rank is a count over the lane's S entries (S x S compares) held in
// shared memory; a unit takes the first matching entry (argmax's rule).
// Bound: launch latency, then the lane's S- and NFU-wide rows (~2 KB).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(ISSUE_THREADS)
issue_kernel(int S, int NF, int Wc, int U, int NP, int issue_width,
             u8* __restrict__ rs_valid, const int* __restrict__ rs_dep,
             const int* __restrict__ rs_pid, const int* __restrict__ rs_age,
             const int* __restrict__ rs_func, const int* __restrict__ rs_uid,
             const int* __restrict__ rs_exec, const int* __restrict__ rs_out_s,
             const int* __restrict__ rs_out_e, const int* __restrict__ rs_src,
             const u8* __restrict__ rs_spec, u8* __restrict__ fu_busy,
             int* __restrict__ fu_uid, int* __restrict__ fu_rem,
             int* __restrict__ fu_out_s, int* __restrict__ fu_out_e,
             int* __restrict__ fu_src, u8* __restrict__ fu_spec,
             int* __restrict__ fu_pid, int* __restrict__ tr_issue,
             const int* __restrict__ cycle, const u8* __restrict__ exists,
             const int* __restrict__ prio, const int* __restrict__ quota,
             const int* __restrict__ cost, const int* __restrict__ eft,
             const u8* __restrict__ alive) {
  extern __shared__ int sm[];
  const int NFU = NF * Wc;
  int* key = sm;                  // S
  int* ready = key + S;           // S
  int* elig = ready + S;          // S
  int* issuable = elig + S;       // S
  int* fire = issuable + S;       // S
  int* f_rank = fire + S;         // S
  int* n_free = f_rank + S;       // NF
  int* freeu = n_free + NF;       // NFU
  int* unit_rank = freeu + NFU;   // NFU
  const long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  rs_valid += lane * S;
  rs_dep += lane * S;
  rs_pid += lane * S;
  rs_age += lane * S;
  rs_func += lane * S;
  rs_uid += lane * S;
  rs_exec += lane * S;
  rs_out_s += lane * S;
  rs_out_e += lane * S;
  rs_src += lane * S;
  rs_spec += lane * S;
  fu_busy += lane * NFU;
  fu_uid += lane * NFU;
  fu_rem += lane * NFU;
  fu_out_s += lane * NFU;
  fu_out_e += lane * NFU;
  fu_src += lane * NFU;
  fu_spec += lane * NFU;
  fu_pid += lane * NFU;
  exists += lane * NFU;
  cost += lane * NFU;
  tr_issue += lane * U;
  prio += lane * NP;
  quota += lane * NP;
  const int cyc = cycle[lane];
  const bool al = alive[lane] != 0;
  const bool by_cost = eft[lane] != 0;

  // 1. ready entries and their keys; free units
  for (int e = tid; e < S; e += nt) {
    const bool r = al && rs_valid[e] && rs_dep[e] == 0;
    int w = prio[clamp_index(rs_pid[e], NP)];
    w = w < 0 ? 0 : (w > PRIO_CAP ? PRIO_CAP : w);
    ready[e] = r;
    key[e] = r ? (PRIO_CAP - w) * AGE_SPAN + rs_age[e] : BIG;
  }
  for (int u = tid; u < NFU; u += nt) freeu[u] = exists[u] && !fu_busy[u];
  __syncthreads();

  // 2. free units per class and each unit's rank among its class's free
  //    units by ckey; the quota mask
  for (int c = tid; c < NF; c += nt) {
    int cnt = 0;
    for (int v = c * Wc; v < (c + 1) * Wc; ++v) cnt += freeu[v];
    n_free[c] = cnt;
  }
  for (int u = tid; u < NFU; u += nt) {
    const int c = u / Wc;
    const int ck = (by_cost ? cost[u] : 0) * NFU + u;
    int rank = 0;
    for (int v = c * Wc; v < (c + 1) * Wc; ++v)
      rank += freeu[v] && (by_cost ? cost[v] : 0) * NFU + v < ck;
    unit_rank[u] = rank;
  }
  for (int e = tid; e < S; e += nt) {
    const int pid = rs_pid[e], fn = rs_func[e];
    int inflight = 0;
    for (int u = 0; u < NFU; ++u)
      inflight += fu_busy[u] && exists[u] && fu_pid[u] == pid && u / Wc == fn;
    int q = 0;
    for (int j = 0; j < S; ++j)
      q += key[j] < key[e] && rs_func[j] == fn && rs_pid[j] == pid && ready[j];
    elig[e] = ready[e] && inflight + q < quota[clamp_index(pid, NP)];
  }
  __syncthreads();

  // 3. rank among eligible entries of the class vs its free units
  for (int e = tid; e < S; e += nt) {
    int cls_rank = 0;
    for (int j = 0; j < S; ++j)
      cls_rank += key[j] < key[e] && rs_func[j] == rs_func[e] && elig[j];
    issuable[e] = elig[e] && cls_rank < n_free[clamp_index(rs_func[e], NF)];
  }
  __syncthreads();

  // 4. the global issue-width cap
  for (int e = tid; e < S; e += nt) {
    int g = 0;
    for (int j = 0; j < S; ++j) g += key[j] < key[e] && issuable[j];
    fire[e] = issuable[e] && g < issue_width;
  }
  __syncthreads();

  // 5. rank among fired entries of the class
  for (int e = tid; e < S; e += nt) {
    int f = 0;
    for (int j = 0; j < S; ++j)
      f += key[j] < key[e] && rs_func[j] == rs_func[e] && fire[j];
    f_rank[e] = f;
  }
  __syncthreads();

  // 6. entry → unit match, applied; fired entries leave the RS
  for (int u = tid; u < NFU; u += nt) {
    if (!freeu[u]) continue;
    const int c = u / Wc;
    for (int e = 0; e < S; ++e) {
      if (fire[e] && rs_func[e] == c && f_rank[e] == unit_rank[u]) {
        fu_busy[u] = 1;
        fu_uid[u] = rs_uid[e];
        fu_rem[u] = rs_exec[e] * cost[u];
        fu_out_s[u] = rs_out_s[e];
        fu_out_e[u] = rs_out_e[e];
        fu_src[u] = rs_src[e];
        fu_spec[u] = rs_spec[e] ? 1 : 0;
        fu_pid[u] = rs_pid[e];
        break;
      }
    }
  }
  for (int e = tid; e < S; e += nt) {
    if (!fire[e]) continue;
    const int t = wrap(rs_uid[e], U);
    if (in_range(t, U)) tr_issue[t] = cyc;
    rs_valid[e] = 0;
  }
}

// ---------------------------------------------------------------------------
// K4 — replaces k_traces (machine.py abort_traces + the dispatch traces,
// :1092-1102).  tr_aborted[uid] for every killed RS entry and unit, then
// tr_func / tr_dispatch / tr_dep / tr_pid at the uid dispatched this cycle.
// Writes tr_func, tr_dispatch, tr_dep, tr_pid, tr_aborted.
// Bound: launch latency; it touches a handful of words per lane.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(TRACE_THREADS)
traces_kernel(int S, int NFU, int U, u8* __restrict__ tr_aborted,
              int* __restrict__ tr_func, int* __restrict__ tr_dispatch,
              int* __restrict__ tr_dep, int* __restrict__ tr_pid,
              const int* __restrict__ rs_uid_k, const u8* __restrict__ rs_kill,
              const int* __restrict__ fu_uid_k, const u8* __restrict__ fu_kill,
              const int* __restrict__ uid, const int* __restrict__ acc,
              const int* __restrict__ dep, const int* __restrict__ pid,
              const u8* __restrict__ dispatch, const int* __restrict__ cycle) {
  const long lane = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  tr_aborted += lane * U;
  rs_uid_k += lane * S;
  rs_kill += lane * S;
  fu_uid_k += lane * NFU;
  fu_kill += lane * NFU;
  for (int e = tid; e < S; e += nt) {
    const int t = wrap(rs_uid_k[e], U);
    if (rs_kill[e] && in_range(t, U)) tr_aborted[t] = 1;
  }
  for (int u = tid; u < NFU; u += nt) {
    const int t = wrap(fu_uid_k[u], U);
    if (fu_kill[u] && in_range(t, U)) tr_aborted[t] = 1;
  }
  if (tid == 0 && dispatch[lane]) {
    const int t = wrap(uid[lane], U);
    if (in_range(t, U)) {
      const long row = lane * U + t;
      tr_func[row] = acc[lane];
      tr_dispatch[row] = cycle[lane];
      tr_dep[row] = dep[lane];
      tr_pid[row] = pid[lane];
    }
  }
}

}  // namespace

extern "C" {

int hts_enqueue(int n, int C, int NFU, int U, int completion_extra,
                void* done, void* cdb_valid, void* cdb_uid, void* cdb_ticket,
                void* cdb_ready, void* cdb_spec, void* ticket, void* overflow,
                void* cycle, void* tr_complete, void* fu_busy, void* fu_uid,
                void* fu_spec, void* stream) {
  if (n > 0)
    enqueue_kernel<<<n, ENQ_THREADS, NFU * sizeof(int),
                     (cudaStream_t)stream>>>(
        C, NFU, U, completion_extra, (const u8*)done, (u8*)cdb_valid,
        (int*)cdb_uid, (int*)cdb_ticket, (int*)cdb_ready, (u8*)cdb_spec,
        (int*)ticket, (u8*)overflow, (const int*)cycle, (int*)tr_complete,
        (u8*)fu_busy, (int*)fu_uid, (const u8*)fu_spec);
  return (int)cudaGetLastError();
}

int hts_grant(int n, int C, int S, int T, int U, int cdb_width,
              void* cdb_valid, void* cdb_ready, void* cdb_ticket,
              void* cdb_uid, void* cycle, void* alive, void* rs_dep,
              void* trk_valid, void* trk_uid, void* tr_broadcast,
              void* br_active, void* br_kind, void* br_wait, void* br_ready,
              void* stream) {
  if (n > 0)
    grant_kernel<<<n, GRANT_THREADS, 0, (cudaStream_t)stream>>>(
        C, S, T, U, cdb_width, (u8*)cdb_valid, (const int*)cdb_ready,
        (const int*)cdb_ticket, (const int*)cdb_uid, (const int*)cycle,
        (const u8*)alive, (int*)rs_dep, (u8*)trk_valid, (const int*)trk_uid,
        (int*)tr_broadcast, (const u8*)br_active, (const int*)br_kind,
        (const int*)br_wait, (u8*)br_ready);
  return (int)cudaGetLastError();
}

int hts_issue(int n, int S, int NF, int Wc, int U, int NP, int issue_width,
              void* rs_valid, void* rs_dep, void* rs_pid, void* rs_age,
              void* rs_func, void* rs_uid, void* rs_exec, void* rs_out_s,
              void* rs_out_e, void* rs_src, void* rs_spec, void* fu_busy,
              void* fu_uid, void* fu_rem, void* fu_out_s, void* fu_out_e,
              void* fu_src, void* fu_spec, void* fu_pid, void* tr_issue,
              void* cycle, void* exists, void* prio, void* quota, void* cost,
              void* eft, void* alive, void* stream) {
  const size_t smem = (6 * S + NF + 2 * NF * Wc) * sizeof(int);
  if (n > 0)
    issue_kernel<<<n, ISSUE_THREADS, smem, (cudaStream_t)stream>>>(
        S, NF, Wc, U, NP, issue_width, (u8*)rs_valid, (const int*)rs_dep,
        (const int*)rs_pid, (const int*)rs_age, (const int*)rs_func,
        (const int*)rs_uid, (const int*)rs_exec, (const int*)rs_out_s,
        (const int*)rs_out_e, (const int*)rs_src, (const u8*)rs_spec,
        (u8*)fu_busy, (int*)fu_uid, (int*)fu_rem, (int*)fu_out_s,
        (int*)fu_out_e, (int*)fu_src, (u8*)fu_spec, (int*)fu_pid,
        (int*)tr_issue, (const int*)cycle, (const u8*)exists,
        (const int*)prio, (const int*)quota, (const int*)cost,
        (const int*)eft, (const u8*)alive);
  return (int)cudaGetLastError();
}

int hts_traces(int n, int S, int NFU, int U, void* tr_aborted, void* tr_func,
               void* tr_dispatch, void* tr_dep, void* tr_pid, void* rs_uid_k,
               void* rs_kill, void* fu_uid_k, void* fu_kill, void* uid,
               void* acc, void* dep, void* pid, void* dispatch, void* cycle,
               void* stream) {
  if (n > 0)
    traces_kernel<<<n, TRACE_THREADS, 0, (cudaStream_t)stream>>>(
        S, NFU, U, (u8*)tr_aborted, (int*)tr_func, (int*)tr_dispatch,
        (int*)tr_dep, (int*)tr_pid, (const int*)rs_uid_k,
        (const u8*)rs_kill, (const int*)fu_uid_k, (const u8*)fu_kill,
        (const int*)uid, (const int*)acc, (const int*)dep, (const int*)pid,
        (const u8*)dispatch, (const int*)cycle);
  return (int)cudaGetLastError();
}

}  // extern "C"
