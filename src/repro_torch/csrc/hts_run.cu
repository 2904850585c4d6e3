// hts_run: the HTS population machine's whole step loop in one persistent
// kernel, for Hopper (sm_90a).
//
// Replaces the reference's four lane-per-program Pallas kernels k_enqueue,
// k_grant, k_issue and k_traces (src/repro/core/hts/machine.py:1079-1102,
// each reaching pl.pallas_call at src/repro/core/hts/pallas_step.py:87)
// together with the vmapped phases of pop_step that run between them
// (machine.py:1104-1153: step_top, fu_exec, memread_tick, branch_core,
// frontend_core, step_bottom with next_dt), and the host loop around them.
// One CTA of 128 threads per scenario lane runs the lane's steps, in the
// reference's phase order,
//
//   step_top -> fu_exec -> K1 enqueue -> memread_tick -> K2 grant
//   -> branch_core -> K3 issue -> frontend_core (with K4's traces)
//   -> step_bottom / next_dt,
//
// until the lane halts, overflows, reaches max_cycles or its step limit
// (steps at entry + budget).  A dead or paused lane is a fixed point of the
// step, so leaving its loop early is exact.
//
// What bounds it: not bytes (a lane's carry is ~53 KB at HtsParams(), read
// and written once) and not arithmetic, but the latency of one step: a
// chain of a few thousand dependent integer instructions, shared-memory
// loads and warp collectives, repeated for each of the slowest lane's
// steps (6299 on the main path).  The per-phase route paid a launch for
// each kernel of each step and ~850 device activities a step from the
// host.  The design:
//
// * The lane's hot state (mem, the CDB, the RS, the unit table, the
//   trackers, the TLB, regs and spec_ckpt) is loaded into dynamic shared
//   memory once, by all four warps, and stored once at exit; the scalars
//   live in registers of warp 0.  The uid-indexed trace tables tr_* stay in
//   device memory and are written at their uid in place, as before.  The
//   read-only arguments (program tables, effects, streams, exists, cost,
//   prio, quota, rs_cap, eft) are read through __ldg.  The layout (every
//   array's byte offset) comes from the wrapper (cuda_run.py), which also
//   refuses a spec that does not fit in 227 KB.  Four warps move the
//   state so that a short slice is not held by its load and store: their
//   __launch_bounds__ caps the stepping warp at 64 registers (ptxas
//   spills ~130 B), yet a one-warp CTA (108 registers, no spills) stepped
//   no faster on the H100 and took 1.3-1.4x as long for a 16-step slice.
// * Warp 0 runs the step, warp-synchronously: RS entry e sits in lane e
//   (and e - 32), units and slots are strided over the lanes, and data
//   crosses lanes through __shfl_sync, __ballot_sync and __reduce_*_sync,
//   with __syncwarp where a lane reads what another wrote.  There is no
//   block barrier inside the loop.
// * K3 (the weighted RS arbiter) works on 64-bit masks: one broadcast of
//   each ready entry's key, class and pid gives every entry its "ahead of
//   me", "same class" and "same pid" masks; the quota, class, issue-width
//   and fired ranks are then popcounts of masks ANDed with ballots.
// * K1 keeps the CDB's valid and speculative bits as bitmaps (32 words at
//   C = 1024): the k-th free slot comes from a popcount scan over the
//   words, the done units from a ballot scan.  K2's smallest-ticket argmin
//   and next_dt's CDB minimum walk the valid bits only.
//
// Integer semantics are the reference's, bit for bit: int32 arithmetic
// wraps (done in unsigned), a data-dependent gather wraps a negative index
// once and clamps, a scatter to an index outside [0, n) is dropped, and
// argmin / argmax / first-index take the first index.
//
// Built with: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//             -Xcompiler -fPIC; called through ctypes (cuda_run.py).  The
// C entry launches on the caller's stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

namespace {

typedef unsigned char u8;
typedef unsigned long long u64;

constexpr unsigned FULL = 0xffffffffu;
constexpr int THREADS = 128;  // four warps: all load and store, warp 0 steps
constexpr int MIN_CTAS = 8;      // CTAs an SM the register budget is cut for
constexpr int MAX_FUNCS = 32;

constexpr int BIG = 1 << 30;        // machine.py BIG
constexpr int PRIO_CAP = 1 << 12;   // policy.PRIO_CAP
constexpr int AGE_SPAN = 1 << 17;   // policy.AGE_SPAN

// isa.py
constexpr int OP_TASK = 0, OP_ADD = 1, OP_MUL = 2, OP_MOV = 3, OP_JUMP = 4,
              OP_IF = 5, OP_LBEG = 6, OP_LEND = 7, OP_NOP = 8;
constexpr int BR_RR = 0, BR_MR = 1, BR_BR = 2;
constexpr int CND_EQ = 0, CND_NEQ = 1, CND_GE = 2;
constexpr int CTL_IN_INDIRECT = 1, CTL_OUT_INDIRECT = 2, CTL_IMM = 1;

// The carry's keys, in cuda_run.CARRY_KEYS order (machine.init_state's).
enum Key {
  K_pc, K_cycle, K_dt, K_fe_wait, K_fe_ptr, K_fe_stall, K_next_uid, K_age,
  K_ticket, K_regs, K_mem, K_rs_valid, K_rs_uid, K_rs_func, K_rs_dep,
  K_rs_age, K_rs_out_s, K_rs_out_e, K_rs_src, K_rs_exec, K_rs_spec, K_rs_pid,
  K_fu_busy, K_fu_uid, K_fu_rem, K_fu_out_s, K_fu_out_e, K_fu_src, K_fu_spec,
  K_fu_busy_cycles, K_fu_pid, K_trk_valid, K_trk_s, K_trk_e, K_trk_uid,
  K_trk_spec, K_tlb_valid, K_tlb_os, K_tlb_oe, K_tlb_slot, K_tlb_seq,
  K_tlb_com, K_tlb_seq_ctr, K_cdb_valid, K_cdb_uid, K_cdb_ticket,
  K_cdb_ready, K_cdb_spec, K_br_active, K_br_kind, K_br_pc, K_br_off,
  K_br_cond, K_br_thr, K_br_addr, K_br_wait, K_br_speculating, K_br_stream,
  K_spec_active, K_spec_ckpt, K_mr_active, K_mr_rem, K_halted, K_overflow,
  K_stall_cycles, K_spec_aborted, K_steps, K_tr_func, K_tr_dispatch,
  K_tr_issue, K_tr_complete, K_tr_broadcast, K_tr_dep, K_tr_aborted,
  K_tr_pid, NCARRY
};

// The read-only arguments, in cuda_run.ARG_KEYS order, after the carry's
// pointers in the pointer array.
enum Arg {
  A_op, A_acc, A_a, A_asz, A_b, A_bsz, A_pid, A_ctl, A_exists, A_effects,
  A_prio, A_quota, A_rs_cap, A_cost, A_eft, A_streams, NARGS
};

// Where each carry array lives (cuda_run.ROW32 ...).
enum Kind { ROW32, ROW8, BITS, SC32, SC8, TRACE32, TRACE8 };

// The launch's sizes, costs and shared-memory layout, as cuda_run.dims()
// packs them (one int each, in this order).
struct Dims {
  int n, S, T, L, C, U, NFU, NF, Wc, M, W, R, NS, P, NP, TMS;
  int tm_base, tm_slot_words, tlb_drain_cycles, mem_read_cycles;
  int max_cycles, budget, event_skip, in_order, dispatch_serial_cost,
      completion_extra, speculation, issue_width, cdb_width;
  int scratch, smem_bytes;
  int func_cycles[MAX_FUNCS];
  int off[NCARRY];   // byte offset in shared memory (-1: device memory)
  int kind[NCARRY];
  int len[NCARRY];   // elements a lane
};

// ---------------------------------------------------------------------------
// int32 semantics of the reference
// ---------------------------------------------------------------------------
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}
__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
// JAX gather index: a negative index wraps once, then clamps into [0, n).
__device__ __forceinline__ int take(int i, int n) {
  return clampi(i < 0 ? i + n : i, 0, n - 1);
}
// JAX scatter index (mode="drop"): wrap once; outside [0, n) writes nothing.
__device__ __forceinline__ int wrap(int i, int n) { return i < 0 ? i + n : i; }
__device__ __forceinline__ bool in_range(int i, int n) {
  return 0 <= i && i < n;
}
__device__ __forceinline__ bool eval_cond(int cond, int v, int thr) {
  return cond == CND_EQ ? v == thr
         : cond == CND_NEQ ? v != thr
         : cond == CND_GE ? v >= thr : v <= thr;
}
// the bits of CDB word k that are slots below C
__device__ __forceinline__ unsigned slot_mask(int C, int k) {
  const int rem = C - k * 32;
  return rem >= 32 ? FULL : ((1u << rem) - 1u);
}

// ---------------------------------------------------------------------------
// warp collectives (every lane of warp 0 calls each one)
// ---------------------------------------------------------------------------
__device__ __forceinline__ int warp_sum(int v) {
  return __reduce_add_sync(FULL, v);
}
__device__ __forceinline__ int warp_min(int v) {
  return __reduce_min_sync(FULL, v);
}
__device__ __forceinline__ int warp_max(int v) {
  return __reduce_max_sync(FULL, v);
}
__device__ __forceinline__ int warp_incl_scan(int v) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if ((int)(threadIdx.x & 31) >= o) v += y;
  }
  return v;
}
// First index of the smallest key: each lane passes its own first minimum
// (i == INT_MAX where it holds no element, with k == INT_MAX).
__device__ __forceinline__ int warp_argmin(int k, int i) {
  const int mk = warp_min(k);
  return warp_min(k == mk ? i : INT_MAX);
}
__device__ __forceinline__ int warp_argmax(int k, int i) {
  const int mk = warp_max(k);
  return warp_min(k == mk ? i : INT_MAX);
}
template <int KS, typename T>
__device__ __forceinline__ T pick(const T (&v)[KS], int k) {
  T r = v[0];
#pragma unroll
  for (int j = 1; j < KS; ++j)
    if (k == j) r = v[j];
  return r;
}

// ---------------------------------------------------------------------------
// the lane: its shared-memory block, its rows in device memory
// ---------------------------------------------------------------------------
struct Lane {
  const Dims& d;
  u8* sm;
  void* const* g;
  long row;
  int L;  // lane of warp 0

  __device__ __forceinline__ int* I(int k) const {
    return reinterpret_cast<int*>(sm + d.off[k]);
  }
  __device__ __forceinline__ u8* B(int k) const { return sm + d.off[k]; }
  __device__ __forceinline__ unsigned* W(int k) const {
    return reinterpret_cast<unsigned*>(sm + d.off[k]);
  }
  __device__ __forceinline__ int* scratch() const {
    return reinterpret_cast<int*>(sm + d.scratch);
  }
  __device__ __forceinline__ void* ptr(int i) const {
    return reinterpret_cast<void*>(
        __ldg(reinterpret_cast<const unsigned long long*>(g) + i));
  }
  template <typename T>
  __device__ __forceinline__ T* trace(int k) const {
    return reinterpret_cast<T*>(ptr(k)) + row * d.len[k];
  }
  template <typename T>
  __device__ __forceinline__ const T* arg(int a, int per) const {
    return reinterpret_cast<const T*>(ptr(NCARRY + a)) + row * per;
  }
};

// The lane's scalars, in registers of warp 0 (every lane holds them all).
struct Sc {
  int cycle, dt, fe_ptr, next_uid, age, ticket, tlb_seq_ctr;
  int br_active, br_kind, br_pc, br_off, br_cond, br_thr, br_addr, br_wait,
      br_speculating, br_stream;
  int spec_active, mr_active, mr_rem, halted, overflow, stall_cycles,
      spec_aborted, steps;
};

#define HTS_SCALARS(X)                                                      \
  X(cycle) X(dt) X(fe_ptr) X(next_uid) X(age) X(ticket) X(tlb_seq_ctr)      \
  X(br_active) X(br_kind) X(br_pc) X(br_off) X(br_cond) X(br_thr)           \
  X(br_addr) X(br_wait) X(br_speculating) X(br_stream) X(spec_active)       \
  X(mr_active) X(mr_rem) X(halted) X(overflow) X(stall_cycles)              \
  X(spec_aborted) X(steps)

// One frontend stream (lane s < NS): its row of `streams`.
struct Strm {
  int start, end, arr, w;
  bool active, is;
};

// ---------------------------------------------------------------------------
// loading and storing the hot state (all 128 threads)
// ---------------------------------------------------------------------------
__device__ void move_state(const Dims& d, void* const* g, long row, u8* sm,
                           bool load) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < NCARRY; ++k) {
    const int kind = d.kind[k], n = d.len[k];
    if (kind == TRACE32 || kind == TRACE8) continue;
    u8* gb = reinterpret_cast<u8*>(
        __ldg(reinterpret_cast<const unsigned long long*>(g) + k));
    u8* s = sm + d.off[k];
    if (kind == ROW32) {
      int* gr = reinterpret_cast<int*>(gb) + row * n;
      int* sr = reinterpret_cast<int*>(s);
      for (int i = tid; i < n; i += THREADS) {
        if (load) sr[i] = gr[i];
        else gr[i] = sr[i];
      }
    } else if (kind == ROW8) {
      u8* gr = gb + row * n;
      for (int i = tid; i < n; i += THREADS) {
        if (load) s[i] = gr[i] ? 1 : 0;
        else gr[i] = s[i];
      }
    } else if (kind == BITS) {
      u8* gr = gb + row * n;
      unsigned* bits = reinterpret_cast<unsigned*>(s);
      const int npad = (n + 31) & ~31;
      for (int base = warp * 32; base < npad; base += THREADS) {
        const int i = base + lane;
        if (load) {
          const unsigned w = __ballot_sync(FULL, i < n && gr[i] != 0);
          if (lane == 0) bits[base >> 5] = w;
        } else if (i < n) {
          gr[i] = (bits[base >> 5] >> lane) & 1u;
        }
      }
    } else if (tid == k % THREADS) {  // a scalar, as an int in shared memory
      int* sv = reinterpret_cast<int*>(s);
      if (kind == SC32) {
        int* gr = reinterpret_cast<int*>(gb) + row;
        if (load) *sv = *gr;
        else *gr = *sv;
      } else {
        u8* gr = gb + row;
        if (load) *sv = *gr ? 1 : 0;
        else *gr = *sv ? 1 : 0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// lookups shared by several phases (warp 0)
// ---------------------------------------------------------------------------
// remap: a speculative output region's address in its TM slot (the TLB
// entry with the newest sequence number that covers addr), else addr.
__device__ int remap(const Lane& x, int addr) {
  const Dims& d = x.d;
  const u8* valid = x.B(K_tlb_valid);
  const int *os = x.I(K_tlb_os), *oe = x.I(K_tlb_oe), *seq = x.I(K_tlb_seq);
  int bk = INT_MIN, bi = INT_MAX;
  bool any = false;
  for (int l = x.L; l < d.L; l += 32) {
    const bool m = valid[l] && os[l] <= addr && addr < oe[l];
    any |= m;
    const int k = m ? seq[l] : -1;
    if (bi == INT_MAX || k > bk) { bk = k; bi = l; }
  }
  const int best = warp_argmax(bk, bi);
  if (!__any_sync(FULL, any)) return addr;
  return wadd(wadd(d.tm_base, wmul(x.I(K_tlb_slot)[best], d.tm_slot_words)),
              wsub(addr, os[best]));
}

// the newest tracker uid whose region overlaps [s, e) (0 if none)
__device__ int tracker_lookup(const Lane& x, int s, int e) {
  const Dims& d = x.d;
  const u8* valid = x.B(K_trk_valid);
  const int *ts = x.I(K_trk_s), *te = x.I(K_trk_e), *uid = x.I(K_trk_uid);
  int v = INT_MIN;
  for (int t = x.L; t < d.T; t += 32)
    v = max(v, (valid[t] && ts[t] < e && s < te[t]) ? uid[t] : 0);
  return warp_max(v);
}

// first False of a bool row (0 if none): jnp.argmin of a bool array
__device__ int first_false(const Lane& x, const u8* arr, int n) {
  int i = INT_MAX;
  for (int e = x.L; e < n; e += 32)
    if (!arr[e]) { i = e; break; }
  i = warp_min(i);
  return i == INT_MAX ? 0 : i;
}

__device__ bool all_true(const Lane& x, const u8* arr, int n) {
  bool a = true;
  for (int e = x.L; e < n; e += 32) a &= arr[e] != 0;
  return __all_sync(FULL, a);
}

__device__ bool machine_empty(const Lane& x, const Sc& sc) {
  const Dims& d = x.d;
  const u8 *rv = x.B(K_rs_valid), *fb = x.B(K_fu_busy);
  const unsigned* cv = x.W(K_cdb_valid);
  bool any = false;
  for (int e = x.L; e < d.S; e += 32) any |= rv[e] != 0;
  for (int u = x.L; u < d.NFU; u += 32) any |= fb[u] != 0;
  for (int k = x.L; k < (d.C + 31) >> 5; k += 32) any |= cv[k] != 0;
  return !__any_sync(FULL, any) && !sc.mr_active && !sc.br_active;
}

// valid RS entries of pid
__device__ int rs_of_pid(const Lane& x, int pid) {
  const Dims& d = x.d;
  const u8* rv = x.B(K_rs_valid);
  const int* rp = x.I(K_rs_pid);
  int c = 0;
  for (int e = x.L; e < d.S; e += 32) c += rv[e] && rp[e] == pid;
  return warp_sum(c);
}

// free units (exist, not busy) of class c, counted by the calling lane
__device__ __forceinline__ int free_in_class(const Lane& x, const u8* ex,
                                             int c) {
  const u8* fb = x.B(K_fu_busy);
  int n = 0;
  for (int v = c * x.d.Wc; v < (c + 1) * x.d.Wc; ++v)
    n += __ldg(ex + v) && !fb[v];
  return n;
}

// For each stream lane: its RS entries of the pid at its pc reach rs_cap.
__device__ bool pid_capped(const Lane& x, int pid_s) {
  const Dims& d = x.d;
  const int* cap = x.arg<int>(A_rs_cap, d.NP);
  bool capped = false;
  for (int s = 0; s < d.NS; ++s) {
    const int p = __shfl_sync(FULL, pid_s, s);
    const int cnt = rs_of_pid(x, p);
    if (x.L == s) capped = cnt >= __ldg(cap + take(p, d.NP));
  }
  return capped;
}

// ---------------------------------------------------------------------------
// the phases (warp 0)
// ---------------------------------------------------------------------------
// step_top: a step of an alive lane; dispatch-stall accounting for the
// event-skipped window behind it
__device__ __forceinline__ void step_top(const Lane& x, Sc& sc,
                                         const Strm& sr) {
  sc.steps = wadd(sc.steps, 1);
  if (sr.is) {
    int* fs = x.I(K_fe_stall);
    if (sr.active && x.I(K_pc)[x.L] < sr.end &&
        sr.arr <= wsub(sc.cycle, sc.dt))
      fs[x.L] = wadd(fs[x.L], wsub(sc.dt, 1));
  }
}

// fu_exec + K1 (k_enqueue): units tick; each done unit's output window is
// written into mem in FU order (later units overwrite); the k-th done unit
// takes the k-th free CDB slot and ticket `ticket + k`; tr_complete; the
// done units are released.
__device__ void fu_exec_enqueue(const Lane& x, Sc& sc) {
  const Dims& d = x.d;
  const int L = x.L, NFU = d.NFU, NFUW = (NFU + 31) >> 5;
  u8* fu_busy = x.B(K_fu_busy);
  int *fu_rem = x.I(K_fu_rem), *fbc = x.I(K_fu_busy_cycles);
  int* fu_uid = x.I(K_fu_uid);
  const u8* exists = x.arg<u8>(A_exists, NFU);
  unsigned my_done = 0;  // lane i holds done word i
  for (int i = 0; i < NFUW; ++i) {
    const int u = i * 32 + L;
    bool done = false;
    if (u < NFU && fu_busy[u] && __ldg(exists + u)) {
      fbc[u] = wadd(fbc[u], sc.dt);
      const int rem = wsub(fu_rem[u], sc.dt);
      fu_rem[u] = rem;
      done = rem <= 0;
    }
    const unsigned w = __ballot_sync(FULL, done);
    if (L == i) my_done = w;
  }
  const int cnt = __popc(my_done);
  const int incl = warp_incl_scan(cnt);
  const int n_done = __shfl_sync(FULL, incl, 31);
  if (n_done == 0) return;

  // the done units by rank (FU order)
  int* unit_of = x.scratch();
  {
    unsigned w = my_done;
    int r = incl - cnt;
    while (w) {
      unit_of[r++] = L * 32 + __ffs(w) - 1;
      w &= w - 1;
    }
  }
  __syncwarp();

  // completion writes, unit by unit; W <= 32 words, a word a lane
  int* mem = x.I(K_mem);
  const int* effects = x.arg<int>(A_effects, d.M);
  const int *fos = x.I(K_fu_out_s), *foe = x.I(K_fu_out_e),
            *fsrc = x.I(K_fu_src);
  for (int r = 0; r < n_done; ++r) {
    const int u = unit_of[r];
    const int dst = fos[u], dst_c = clampi(dst, 0, d.M - d.W);
    const int off = wsub(dst, dst_c), hi = wadd(off, wsub(foe[u], dst));
    if (L < d.W && L >= off && L < hi)
      mem[dst_c + L] = __ldg(effects + clampi(wadd(wsub(L, off), fsrc[u]), 0,
                                              d.M - 1));
    __syncwarp();
  }

  // K1: free slots from the valid bitmap, a word a lane
  const int C = d.C, CW = (C + 31) >> 5;
  unsigned *cv = x.W(K_cdb_valid), *cs = x.W(K_cdb_spec);
  int nf = 0;
  for (int k = L; k < CW; k += 32) nf += __popc(~cv[k] & slot_mask(C, k));
  const int n_free = warp_sum(nf);
  const int n_enq = min(n_done, n_free);
  int *cuid = x.I(K_cdb_uid), *ctk = x.I(K_cdb_ticket),
      *crd = x.I(K_cdb_ready);
  const u8* fu_spec = x.B(K_fu_spec);
  const int ready_at = wadd(sc.cycle, d.completion_extra);
  int base = 0;  // free slots in the chunks before this one
  for (int q = 0; q < CW && base < n_enq; q += 32) {
    const int k = q + L;
    unsigned fw = k < CW ? (~cv[k] & slot_mask(C, k)) : 0u;
    const int c = __popc(fw);
    const int inc = warp_incl_scan(c);
    int r = base + inc - c;
    unsigned taken = 0, spec = 0;
    while (fw && r < n_enq) {
      const int b = __ffs(fw) - 1;
      fw &= fw - 1;
      const int s = k * 32 + b, u = unit_of[r];
      cuid[s] = fu_uid[u];
      ctk[s] = wadd(sc.ticket, r);
      crd[s] = ready_at;
      taken |= 1u << b;
      if (fu_spec[u]) spec |= 1u << b;
      ++r;
    }
    if (taken) {
      cv[k] |= taken;
      cs[k] = (cs[k] & ~taken) | spec;
    }
    base += __shfl_sync(FULL, inc, 31);
  }
  __syncwarp();  // every fu_uid read above precedes the release below
  sc.ticket = wadd(sc.ticket, n_enq);
  if (n_done > n_free) sc.overflow = 1;
  int* trc = x.trace<int>(K_tr_complete);
  for (int r = L; r < n_done; r += 32) {
    const int u = unit_of[r], t = wrap(fu_uid[u], d.U);
    if (in_range(t, d.U)) trc[t] = sc.cycle;
    fu_busy[u] = 0;
    fu_uid[u] = 0;
  }
  __syncwarp();
}

// memread_tick: the memory read behind an MR branch; true when it fires
__device__ __forceinline__ bool memread_tick(Sc& sc) {
  if (!sc.mr_active) return false;
  sc.mr_rem = wsub(sc.mr_rem, sc.dt);
  if (sc.mr_rem > 0) return false;
  sc.mr_active = 0;
  return true;
}

// K2 (k_grant): cdb_width broadcasts, each of the ready slot with the
// smallest ticket (argmin over where(ready, ticket, BIG), first index).
__device__ void grant(const Lane& x, Sc& sc, bool& br_ready) {
  const Dims& d = x.d;
  const int L = x.L, C = d.C, CW = (C + 31) >> 5;
  unsigned* cv = x.W(K_cdb_valid);
  const int *crd = x.I(K_cdb_ready), *ctk = x.I(K_cdb_ticket),
            *cuid = x.I(K_cdb_uid);
  int* rs_dep = x.I(K_rs_dep);
  u8* trk_valid = x.B(K_trk_valid);
  const int* trk_uid = x.I(K_trk_uid);
  for (int g = 0; g < d.cdb_width; ++g) {
    int bk = INT_MAX, bi = INT_MAX;  // the lane's best ready (ticket, slot)
    int nr = INT_MAX;                // the lane's first slot that is not ready
    bool found = false;
    for (int k = L; k < CW; k += 32) {
      unsigned v = cv[k];
      const unsigned inval = ~v & slot_mask(C, k);
      if (inval) nr = min(nr, k * 32 + __ffs(inval) - 1);
      while (v) {
        const int s = k * 32 + __ffs(v) - 1;
        v &= v - 1;
        if (crd[s] <= sc.cycle) {
          const int t = ctk[s];
          if (!found || t < bk) { bk = t; bi = s; found = true; }
        } else {
          nr = min(nr, s);
        }
      }
    }
    if (!__any_sync(FULL, found)) continue;
    const int mk = warp_min(found ? bk : INT_MAX);
    const int mi = warp_min(found && bk == mk ? bi : INT_MAX);
    const int first_nr = warp_min(nr);
    // a slot that is not ready has key BIG: it wins only past a ready BIG
    const int idx = (first_nr != INT_MAX &&
                     (BIG < mk || (BIG == mk && first_nr < mi))) ? first_nr
                                                                 : mi;
    const int uid = cuid[idx];
    if (L == 0) {
      cv[idx >> 5] &= ~(1u << (idx & 31));
      const int t = wrap(uid, d.U);
      if (in_range(t, d.U)) x.trace<int>(K_tr_broadcast)[t] = sc.cycle;
    }
    for (int e = L; e < d.S; e += 32)
      if (rs_dep[e] == uid) rs_dep[e] = 0;
    for (int t = L; t < d.T; t += 32)
      if (trk_uid[t] == uid) trk_valid[t] = 0;
    if (sc.br_active && sc.br_kind == BR_BR && sc.br_wait == uid)
      br_ready = true;
    __syncwarp();  // the next grant reads cdb_valid
  }
}

// branch_core: resolve a branch whose condition is ready: commit or squash
// a speculation (the squash's tr_aborted traces, K4's part, are written
// here with the uids as of the squash; nothing else writes or reads
// tr_aborted), or redirect a plain branch.
__device__ void branch_core(const Lane& x, Sc& sc, bool br_ready) {
  if (!(sc.br_active && br_ready)) return;
  const Dims& d = x.d;
  const int L = x.L;
  const int value = x.I(K_mem)[take(remap(x, sc.br_addr), d.M)];
  const bool taken = eval_cond(sc.br_cond, value, sc.br_thr);
  const int target = wadd(sc.br_pc, taken ? sc.br_off : 1);
  const bool spec = sc.br_speculating;
  const bool commit = spec && !taken, squash = spec && taken;
  u8 *tlb_valid = x.B(K_tlb_valid), *tlb_com = x.B(K_tlb_com);
  u8 *trk_valid = x.B(K_trk_valid), *trk_spec = x.B(K_trk_spec);
  u8 *rs_valid = x.B(K_rs_valid), *rs_spec = x.B(K_rs_spec);
  u8 *fu_busy = x.B(K_fu_busy), *fu_spec = x.B(K_fu_spec);
  unsigned *cv = x.W(K_cdb_valid), *cs = x.W(K_cdb_spec);
  const int CW = (d.C + 31) >> 5;
  if (commit) {
    for (int l = L; l < d.L; l += 32)
      if (tlb_valid[l]) tlb_com[l] = 1;
    for (int t = L; t < d.T; t += 32) trk_spec[t] = 0;
    for (int e = L; e < d.S; e += 32) rs_spec[e] = 0;
    for (int u = L; u < d.NFU; u += 32) fu_spec[u] = 0;
    for (int k = L; k < CW; k += 32) cs[k] = 0;
  }
  if (squash) {
    u8* ab = x.trace<u8>(K_tr_aborted);
    const int* rs_uid = x.I(K_rs_uid);
    int* fu_uid = x.I(K_fu_uid);
    int nk = 0;
    for (int e = L; e < d.S; e += 32) {
      if (!(rs_valid[e] && rs_spec[e])) continue;
      ++nk;
      const int t = wrap(rs_uid[e], d.U);
      if (in_range(t, d.U)) ab[t] = 1;
      rs_valid[e] = 0;
    }
    for (int u = L; u < d.NFU; u += 32) {
      if (!(fu_busy[u] && fu_spec[u])) continue;
      ++nk;
      const int t = wrap(fu_uid[u], d.U);
      if (in_range(t, d.U)) ab[t] = 1;
      fu_busy[u] = 0;
      fu_uid[u] = 0;
    }
    sc.spec_aborted = wadd(sc.spec_aborted, warp_sum(nk));
    for (int t = L; t < d.T; t += 32)
      if (trk_spec[t]) trk_valid[t] = 0;
    for (int l = L; l < d.L; l += 32)
      if (!tlb_com[l]) tlb_valid[l] = 0;
    for (int k = L; k < CW; k += 32) cv[k] &= ~cs[k];
    int* regs = x.I(K_regs);
    const int* ckpt = x.I(K_spec_ckpt);
    for (int r = L; r < d.R; r += 32) regs[r] = ckpt[r];
    if (L == 0 && in_range(sc.br_stream, d.NS))
      x.I(K_fe_wait)[sc.br_stream] = 0;
  }
  if ((squash || !spec) && L == 0 && in_range(sc.br_stream, d.NS))
    x.I(K_pc)[sc.br_stream] = target;
  if (commit || squash) sc.spec_active = 0;
  sc.br_active = 0;
  __syncwarp();
}

// K3 (k_issue): the weighted RS arbiter.  Entry e = 32 k + lane sits in
// slot k of its lane; masks are over the S <= 64 entries.
template <int KS>
__device__ void issue(const Lane& x, Sc& sc) {
  const Dims& d = x.d;
  const int L = x.L, S = d.S, NFU = d.NFU, Wc = d.Wc;
  const u8 *rs_valid_c = x.B(K_rs_valid), *fu_busy_c = x.B(K_fu_busy);
  const int *rs_dep = x.I(K_rs_dep), *rs_pid = x.I(K_rs_pid),
            *rs_func = x.I(K_rs_func), *rs_age = x.I(K_rs_age);
  const int* prio = x.arg<int>(A_prio, d.NP);
  const int* quota = x.arg<int>(A_quota, d.NP);
  const u8* exists = x.arg<u8>(A_exists, NFU);
  int key[KS], fn[KS], pid[KS];
  bool rdy[KS];
  u64 ready_m = 0;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    const int e = k * 32 + L;
    rdy[k] = false;
    key[k] = BIG;
    fn[k] = 0;
    pid[k] = 0;
    if (e < S) {
      fn[k] = rs_func[e];
      pid[k] = rs_pid[e];
      rdy[k] = rs_valid_c[e] && rs_dep[e] == 0;
      const int w = clampi(__ldg(prio + take(pid[k], d.NP)), 0, PRIO_CAP);
      if (rdy[k]) key[k] = wadd(wmul(PRIO_CAP - w, AGE_SPAN), rs_age[e]);
    }
    ready_m |= (u64)__ballot_sync(FULL, rdy[k]) << (32 * k);
  }
  if (!ready_m) return;

  // per entry: the ready entries ahead of it, of its class, of its pid
  u64 lt[KS], sf[KS], sp[KS];
#pragma unroll
  for (int k = 0; k < KS; ++k) lt[k] = sf[k] = sp[k] = 0;
  for (u64 m = ready_m; m; m &= m - 1) {
    const int j = __ffsll((long long)m) - 1, src = j & 31, kj = j >> 5;
    const int key_j = __shfl_sync(FULL, pick(key, kj), src);
    const int fn_j = __shfl_sync(FULL, pick(fn, kj), src);
    const int pid_j = __shfl_sync(FULL, pick(pid, kj), src);
    const u64 bit = 1ull << j;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      if (key_j < key[k]) lt[k] |= bit;
      if (fn_j == fn[k]) sf[k] |= bit;
      if (pid_j == pid[k]) sp[k] |= bit;
    }
  }

  // quota: units in flight of the entry's (pid, class) plus ready entries
  // of both ahead of it; then the rank within the class against its free
  // units; the issue-width cap; the rank among fired entries of the class
  bool elig[KS], iss[KS], fire[KS];
  int nfree[KS], fr[KS];
  u64 elig_m = 0, iss_m = 0, fire_m = 0;
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    elig[k] = false;
    nfree[k] = 0;
    if (rdy[k]) {
      const int c = take(fn[k], d.NF);
      int inflight = 0;
      for (int v = c * Wc; v < (c + 1) * Wc; ++v) {
        const bool ex = __ldg(exists + v);
        nfree[k] += ex && !fu_busy_c[v];
        if (fn[k] == c)
          inflight += ex && fu_busy_c[v] && x.I(K_fu_pid)[v] == pid[k];
      }
      const int q = __popcll(lt[k] & sf[k] & sp[k]);
      elig[k] = inflight + q < __ldg(quota + take(pid[k], d.NP));
    }
    elig_m |= (u64)__ballot_sync(FULL, elig[k]) << (32 * k);
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    iss[k] = elig[k] && __popcll(lt[k] & sf[k] & elig_m) < nfree[k];
    iss_m |= (u64)__ballot_sync(FULL, iss[k]) << (32 * k);
  }
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    fire[k] = iss[k] && __popcll(lt[k] & iss_m) < d.issue_width;
    fire_m |= (u64)__ballot_sync(FULL, fire[k]) << (32 * k);
  }
  if (!fire_m) return;
#pragma unroll
  for (int k = 0; k < KS; ++k) fr[k] = __popcll(lt[k] & sf[k] & fire_m);

  // entry -> unit: the k-th fired entry of a class takes the class's free
  // unit of rank k by ckey (FU index, or cost-major under eft); a unit
  // takes the first matching entry (argmax's rule).  Match first, then load.
  const int* cost = x.arg<int>(A_cost, NFU);
  const bool by_cost = __ldg(x.arg<int>(A_eft, 1)) != 0;
  int* entry_of = x.scratch();
  for (int i = 0; i < ((NFU + 31) >> 5); ++i) {
    const int u = i * 32 + L, c = u / Wc;
    const bool free_u = u < NFU && __ldg(exists + u) && !fu_busy_c[u];
    int rank = 0;
    if (free_u) {
      const int ck = wadd(wmul(by_cost ? __ldg(cost + u) : 0, NFU), u);
      for (int v = c * Wc; v < (c + 1) * Wc; ++v)
        rank += __ldg(exists + v) && !fu_busy_c[v] &&
                wadd(wmul(by_cost ? __ldg(cost + v) : 0, NFU), v) < ck;
    }
    int hit = -1;
    for (u64 m = fire_m; m; m &= m - 1) {
      const int j = __ffsll((long long)m) - 1;
      const int fr_j = __shfl_sync(FULL, pick(fr, j >> 5), j & 31);
      if (free_u && hit < 0 && rs_func[j] == c && fr_j == rank) hit = j;
    }
    if (u < NFU) entry_of[u] = hit;
  }
  __syncwarp();
  u8* fu_busy = x.B(K_fu_busy);
  u8* fu_spec = x.B(K_fu_spec);
  int *fu_uid = x.I(K_fu_uid), *fu_rem = x.I(K_fu_rem),
      *fu_out_s = x.I(K_fu_out_s), *fu_out_e = x.I(K_fu_out_e),
      *fu_src = x.I(K_fu_src), *fu_pid = x.I(K_fu_pid);
  const int *rs_uid = x.I(K_rs_uid), *rs_exec = x.I(K_rs_exec),
            *rs_out_s = x.I(K_rs_out_s), *rs_out_e = x.I(K_rs_out_e),
            *rs_src = x.I(K_rs_src);
  const u8* rs_spec = x.B(K_rs_spec);
  for (int u = L; u < NFU; u += 32) {
    const int e = entry_of[u];
    if (e < 0) continue;
    fu_busy[u] = 1;
    fu_uid[u] = rs_uid[e];
    fu_rem[u] = wmul(rs_exec[e], __ldg(cost + u));
    fu_out_s[u] = rs_out_s[e];
    fu_out_e[u] = rs_out_e[e];
    fu_src[u] = rs_src[e];
    fu_spec[u] = rs_spec[e];
    fu_pid[u] = rs_pid[e];
  }
  int* tri = x.trace<int>(K_tr_issue);
  u8* rs_valid = x.B(K_rs_valid);
#pragma unroll
  for (int k = 0; k < KS; ++k) {
    if (!fire[k]) continue;
    const int e = k * 32 + L, t = wrap(rs_uid[e], d.U);
    if (in_range(t, d.U)) tri[t] = sc.cycle;
    rs_valid[e] = 0;
  }
  __syncwarp();
}

// the TLB / transactional-memory state the dispatch gates read
struct Tm {
  int slot, victim;
  bool avail, tlb_full, has_victim;
};

__device__ Tm tm_state(const Lane& x) {
  const Dims& d = x.d;
  const u8 *valid = x.B(K_tlb_valid), *com = x.B(K_tlb_com);
  const int *slot = x.I(K_tlb_slot), *seq = x.I(K_tlb_seq);
  unsigned used = 0;
  bool full = true;
  int bk = INT_MAX, bi = INT_MAX;
  for (int l = x.L; l < d.L; l += 32) {
    const bool v = valid[l];
    full &= v;
    if (v && in_range(slot[l], d.TMS)) used |= 1u << slot[l];
    const int k = (v && com[l]) ? seq[l] : BIG;
    if (bi == INT_MAX || k < bk) { bk = k; bi = l; }
  }
  used = __reduce_or_sync(FULL, used);
  Tm tm;
  tm.victim = warp_argmin(bk, bi);
  tm.has_victim = warp_min(bk) < BIG;
  tm.tlb_full = __all_sync(FULL, full);
  const unsigned freeb =
      ~used & (d.TMS >= 32 ? FULL : ((1u << d.TMS) - 1u));
  tm.avail = freeb != 0;
  tm.slot = freeb ? __ffs(freeb) - 1 : 0;
  return tm;
}

// dst_arr[dst:dst+n] = src_arr[src:src+n] through one W-wide window of mem
// (copy_window: every word read before any is written)
__device__ void copy_window(const Lane& x, int dst, int src, int n) {
  const Dims& d = x.d;
  int* mem = x.I(K_mem);
  const int dst_c = clampi(dst, 0, d.M - d.W), off = wsub(dst, dst_c);
  const bool m = x.L < d.W && x.L >= off && x.L < wadd(off, n);
  const int v = m ? mem[clampi(wadd(wsub(x.L, off), src), 0, d.M - 1)] : 0;
  __syncwarp();
  if (m) mem[dst_c + x.L] = v;
  __syncwarp();
}

// frontend_core + K4's dispatch traces: N per-tenant streams, one
// arbitrated dispatch per cycle (weight class first, round-robin within a
// class); stream s sits in lane s.
__device__ void frontend(const Lane& x, Sc& sc, const Strm& sr) {
  const Dims& d = x.d;
  const int L = x.L, NS = d.NS, P = d.P, R = d.R;
  int *pc = x.I(K_pc), *fe_wait = x.I(K_fe_wait), *fe_stall = x.I(K_fe_stall);
  const int* Fop = x.arg<int>(A_op, P);
  const int* Fpid = x.arg<int>(A_pid, P);
  const int* Fctl = x.arg<int>(A_ctl, P);

  const int pcs = sr.is ? pc[L] : 0;
  const bool drained = pcs >= sr.end, arrived = sc.cycle >= sr.arr;
  const bool fe_free = sr.is && fe_wait[L] == 0;
  const bool br_mine = L == sc.br_stream;
  const bool br_ok = sc.br_active ? (sc.br_speculating ? br_mine : !br_mine)
                                  : true;
  const bool base = sr.is && sr.active && arrived && !drained && fe_free &&
                    br_ok;
  const int pccs = clampi(pcs, 0, max(P - 1, 0));
  int op_s = 0, pid_s = 0, kind_s = 0;
  if (sr.is) {
    op_s = __ldg(Fop + pccs);
    pid_s = __ldg(Fpid + pccs);
    kind_s = __ldg(Fctl + pccs) & 3;
  }
  const bool any_task = __any_sync(FULL, base && op_s == OP_TASK);
  const bool any_if = __any_sync(FULL, base && op_s == OP_IF);
  bool empty_req = false;
  if (d.in_order && (any_task || any_if)) empty_req = !machine_empty(x, sc);

  // TASK gates: structural stalls, the pid cap, speculative TLB/TM room
  Tm tm{0, 0, false, false, false};
  bool task_ok = false;
  if (any_task) {
    const bool rs_full = all_true(x, x.B(K_rs_valid), d.S);
    const bool trk_full = all_true(x, x.B(K_trk_valid), d.T);
    tm = tm_state(x);
    const bool spec_gate = tm.avail ? !tm.tlb_full : tm.has_victim;
    const bool capped = pid_capped(x, pid_s);
    task_ok = !rs_full && !trk_full && !empty_req &&
              (!sc.spec_active || spec_gate) && !capped;
  }
  const bool if_ok = !sc.br_active && (kind_s == BR_RR || !empty_req);
  const bool elig = base && (op_s == OP_TASK ? task_ok
                             : op_s == OP_IF ? if_ok : true);
  int key = INT_MAX;  // lanes past NS hold no stream
  if (sr.is) {
    int md = wsub(L, sc.fe_ptr) % NS;
    if (md < 0) md += NS;
    key = elig ? wadd(wmul(PRIO_CAP - sr.w, NS), md) : BIG;
  }
  const int gidx = warp_argmin(key, sr.is ? L : INT_MAX);
  const bool has = __any_sync(FULL, elig);
  if (has) sc.fe_ptr = (gidx + 1) % NS;

  // decode windows tick every cycle on every stream
  if (sr.is) {
    const int fw = wsub(fe_wait[L], sc.dt);
    fe_wait[L] = fw < 0 ? 0 : fw;
    if (sr.active && arrived && !drained && !(has && L == gidx))
      fe_stall[L] = wadd(fe_stall[L], 1);
  }
  __syncwarp();
  if (!has) {
    sc.stall_cycles = wadd(sc.stall_cycles, 1);
    return;
  }

  // scalar fetch of the granted stream's instruction
  const int pcc = __shfl_sync(FULL, pccs, gidx);
  const int pc_g = __shfl_sync(FULL, pcs, gidx);
  const int op = __shfl_sync(FULL, op_s, gidx);
  const int a = __ldg(x.arg<int>(A_a, P) + pcc);
  const int asz = __ldg(x.arg<int>(A_asz, P) + pcc);
  const int b = __ldg(x.arg<int>(A_b, P) + pcc);
  const int bsz = __ldg(x.arg<int>(A_bsz, P) + pcc);
  const int ctl = __ldg(Fctl + pcc);
  const int acc = __ldg(x.arg<int>(A_acc, P) + pcc);
  const int pidv = __ldg(Fpid + pcc);

  // control ops (1 cycle each)
  int* regs = x.I(K_regs);
  const bool is_add = op == OP_ADD, is_mul = op == OP_MUL,
             is_mov = op == OP_MOV, is_jmp = op == OP_JUMP,
             is_lbeg = op == OP_LBEG, is_lend = op == OP_LEND,
             is_nop = op == OP_NOP;
  const int r_a = regs[take(a, R)], r_asz = regs[take(asz, R)];
  const int val = is_add ? wadd(r_a, r_asz)
                  : is_mul ? wmul(r_a, r_asz)
                  : is_mov ? ((ctl & CTL_IMM) ? a : r_a)
                  : is_lbeg ? ((ctl & 1) ? r_a : a) : 0;
  const bool writes = is_add || is_mul || is_mov;
  const int wr_reg = writes ? b : (is_lbeg ? asz : -1);
  const int lend_val = wsub(r_asz, 1);
  if (L == 0) {
    if ((writes || is_lbeg) && in_range(wr_reg, R)) regs[wr_reg] = val;
    if (is_lend && in_range(asz, R)) regs[asz] = lend_val;
  }
  __syncwarp();
  int pc_next = (writes || is_lbeg || is_nop) ? wadd(pc_g, 1) : pc_g;
  if (is_jmp) pc_next = a;
  if (is_lend) pc_next = lend_val > 0 ? wsub(pc_g, b) : wadd(pc_g, 1);
  bool progressed = writes || is_jmp || is_lbeg || is_lend || is_nop;

  if (op == OP_TASK) {
    // task dispatch: eligibility cleared the structural and speculative
    // gates, so a granted TASK either dispatches or drains
    const int in_s = (ctl & CTL_IN_INDIRECT) ? regs[take(a, R)] : a;
    const int out_s = (ctl & CTL_OUT_INDIRECT) ? regs[take(b, R)] : b;
    const int in_e = wadd(in_s, asz), out_e = wadd(out_s, bsz);
    const int phys_in = remap(x, in_s);
    const int dep = tracker_lookup(x, phys_in,
                                   wadd(phys_in, wsub(in_e, in_s)));
    u8* tlb_valid = x.B(K_tlb_valid);
    if (sc.spec_active && !tm.avail) {
      // drain path: TM full and a committed victim exists
      const int v = tm.victim, vos = x.I(K_tlb_os)[v];
      copy_window(x, vos,
                  wadd(d.tm_base, wmul(x.I(K_tlb_slot)[v], d.tm_slot_words)),
                  wsub(x.I(K_tlb_oe)[v], vos));
      if (L == 0) {
        tlb_valid[v] = 0;
        fe_wait[gidx] = d.tlb_drain_cycles;
      }
      __syncwarp();
    } else {
      const bool spec = sc.spec_active;
      const int phys_out =
          spec ? wadd(d.tm_base, wmul(tm.slot, d.tm_slot_words)) : out_s;
      const int phys_oe = wadd(phys_out, wsub(out_e, out_s));
      if (spec) {  // TLB insert for speculative dispatch
        const int tn = first_false(x, tlb_valid, d.L);
        if (L == 0) {
          tlb_valid[tn] = 1;
          x.I(K_tlb_os)[tn] = out_s;
          x.I(K_tlb_oe)[tn] = out_e;
          x.I(K_tlb_slot)[tn] = tm.slot;
          x.I(K_tlb_seq)[tn] = sc.tlb_seq_ctr;
          x.B(K_tlb_com)[tn] = 0;
        }
        sc.tlb_seq_ctr = wadd(sc.tlb_seq_ctr, 1);
        __syncwarp();
      }
      // WAW replacement + tracker insert
      u8* trk_valid = x.B(K_trk_valid);
      const int *trk_s = x.I(K_trk_s), *trk_e = x.I(K_trk_e);
      for (int t = L; t < d.T; t += 32)
        if (trk_valid[t] && trk_s[t] < phys_oe && phys_out < trk_e[t])
          trk_valid[t] = 0;
      __syncwarp();
      const int kn = first_false(x, trk_valid, d.T);
      const int rn = first_false(x, x.B(K_rs_valid), d.S);
      const int uid = sc.next_uid, uidc = clampi(uid, 0, d.U - 1);
      if (L == 0) {
        trk_valid[kn] = 1;
        x.I(K_trk_s)[kn] = phys_out;
        x.I(K_trk_e)[kn] = phys_oe;
        x.I(K_trk_uid)[kn] = uid;
        x.B(K_trk_spec)[kn] = spec;
        // RS insert
        x.B(K_rs_valid)[rn] = 1;
        x.I(K_rs_uid)[rn] = uid;
        x.I(K_rs_func)[rn] = acc;
        x.I(K_rs_dep)[rn] = dep;
        x.I(K_rs_age)[rn] = sc.age;
        x.I(K_rs_out_s)[rn] = phys_out;
        x.I(K_rs_out_e)[rn] = phys_oe;
        x.I(K_rs_src)[rn] = out_s;
        x.I(K_rs_exec)[rn] = d.func_cycles[clampi(acc, 0, d.NF - 1)];
        x.I(K_rs_pid)[rn] = pidv;
        x.B(K_rs_spec)[rn] = spec;
        fe_wait[gidx] = d.dispatch_serial_cost - 1;
        // K4: the dispatch traces at the (clamped) uid
        x.trace<int>(K_tr_func)[uidc] = acc;
        x.trace<int>(K_tr_dispatch)[uidc] = sc.cycle;
        x.trace<int>(K_tr_dep)[uidc] = dep;
        x.trace<int>(K_tr_pid)[uidc] = pidv;
      }
      if (uid >= d.U || wsub(out_e, out_s) > d.W) sc.overflow = 1;
      sc.next_uid = wadd(sc.next_uid, 1);
      sc.age = wadd(sc.age, 1);
      pc_next = wadd(pc_g, 1);
      progressed = true;
      __syncwarp();
    }
  } else if (op == OP_IF && !sc.br_active) {
    const int kind = ctl & 0x3, cond = (ctl >> 2) & 0x3;
    const int thr = regs[take(asz, R)];
    if (kind == BR_RR) {  // resolved inline with a 1-cycle bubble
      pc_next = eval_cond(cond, regs[take(a, R)], thr) ? wadd(pc_g, b)
                                                       : wadd(pc_g, 1);
      if (L == 0) fe_wait[gidx] = 1;
    } else {  // MR / BR: the branch unit takes it
      const int phys_a = remap(x, a);
      const int wait_uid = tracker_lookup(x, phys_a, wadd(phys_a, 1));
      const int eff = (kind == BR_BR && wait_uid == 0) ? BR_MR : kind;
      const bool speculate = d.speculation && !sc.spec_active;
      sc.br_active = 1;
      sc.br_kind = eff;
      sc.br_pc = pc_g;
      sc.br_off = b;
      sc.br_cond = cond;
      sc.br_thr = thr;
      sc.br_addr = a;
      sc.br_wait = wait_uid;
      sc.br_stream = gidx;
      sc.br_speculating = speculate;
      if (eff == BR_MR) {
        sc.mr_active = 1;
        sc.mr_rem = d.mem_read_cycles;
      }
      if (speculate) {
        sc.spec_active = 1;
        int* ckpt = x.I(K_spec_ckpt);
        for (int r = L; r < R; r += 32) ckpt[r] = regs[r];
        pc_next = wadd(pc_g, 1);
      }
    }
    progressed = true;
  }
  if (L == 0) pc[gidx] = pc_next;
  if (!progressed) sc.stall_cycles = wadd(sc.stall_cycles, 1);
  __syncwarp();
}

// next_dt: with event-skip, the time to the next scheduler event
__device__ int next_dt(const Lane& x, const Sc& sc, const Strm& sr,
                       bool empty) {
  const Dims& d = x.d;
  const int L = x.L;
  const u8 *rs_valid = x.B(K_rs_valid), *fu_busy = x.B(K_fu_busy);
  const u8* exists = x.arg<u8>(A_exists, d.NFU);
  // a ready RS entry with a free unit of its class issues next cycle
  bool now = false;
  const int *rs_dep = x.I(K_rs_dep), *rs_func = x.I(K_rs_func);
  for (int e = L; e < d.S; e += 32)
    if (rs_valid[e] && rs_dep[e] == 0 &&
        free_in_class(x, exists, take(rs_func[e], d.NF)) > 0)
      now = true;
  if (__any_sync(FULL, now)) return 1;

  // any stream's frontend can act next cycle: no skipping
  const int pcs = sr.is ? x.I(K_pc)[L] : 0;
  const bool drained = pcs >= sr.end;
  const int pccs = clampi(pcs, 0, max(d.P - 1, 0));
  int at_op = 0, pid_here = 0;
  if (sr.is) {
    at_op = __ldg(x.arg<int>(A_op, d.P) + pccs);
    pid_here = __ldg(x.arg<int>(A_pid, d.P) + pccs);
  }
  const bool br_mine = L == sc.br_stream;
  const bool br_ok = sc.br_active ? (sc.br_speculating ? br_mine : !br_mine)
                                  : true;
  const bool is_task = at_op == OP_TASK;
  const bool in_order_block =
      d.in_order && !empty && (is_task || at_op == OP_IF);
  bool act = sr.is && x.I(K_fe_wait)[L] == 0 && br_ok && sr.active &&
             !drained && sr.arr <= wadd(sc.cycle, 1) && !in_order_block;
  if (__any_sync(FULL, act && is_task)) {
    // a structural stall unblocks only through an issue or a grant
    const bool full = all_true(x, rs_valid, d.S) ||
                      all_true(x, x.B(K_trk_valid), d.T);
    const bool capped = pid_capped(x, pid_here);
    if (is_task && (full || capped)) act = false;
  }
  if (__any_sync(FULL, act)) return 1;

  // the nearest event: a unit finishing, the memory read, a CDB entry
  // becoming ready, a decode window closing, a stream arriving
  int m = INT_MAX;
  for (int u = L; u < d.NFU; u += 32)
    m = min(m, (fu_busy[u] && __ldg(exists + u)) ? x.I(K_fu_rem)[u] : BIG);
  const unsigned* cv = x.W(K_cdb_valid);
  const int* crd = x.I(K_cdb_ready);
  for (int k = L; k < (d.C + 31) >> 5; k += 32) {
    unsigned v = cv[k];
    if (~v & slot_mask(d.C, k)) m = min(m, BIG);
    while (v) {
      const int s = k * 32 + __ffs(v) - 1;
      v &= v - 1;
      m = min(m, max(wsub(crd[s], sc.cycle), 1));
    }
  }
  if (sr.is) {
    const int fw = x.I(K_fe_wait)[L];
    m = min(m, fw > 0 ? fw : BIG);
    m = min(m, (sr.active && !drained && sr.arr > sc.cycle)
                   ? wsub(sr.arr, sc.cycle) : BIG);
  }
  m = warp_min(m);
  m = min(m, sc.mr_active ? sc.mr_rem : BIG);
  return clampi(m, 1, BIG);
}

// step_bottom: halt a lane whose streams are drained and whose machine is
// empty; advance the clock by next_dt
__device__ void step_bottom(const Lane& x, Sc& sc, const Strm& sr) {
  const Dims& d = x.d;
  const bool empty = machine_empty(x, sc);
  const bool drained = !sr.is || x.I(K_pc)[x.L] >= sr.end;
  const bool waiting = sr.is && x.I(K_fe_wait)[x.L] != 0;
  const bool done = __all_sync(FULL, drained) && empty &&
                    !__any_sync(FULL, waiting);
  const int dt = d.event_skip ? next_dt(x, sc, sr, empty) : 1;
  sc.cycle = wadd(sc.cycle, done ? 1 : dt);
  sc.dt = dt;
  if (done) sc.halted = 1;
}

// ---------------------------------------------------------------------------
// the kernel: a CTA a lane
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
hts_run_kernel(const __grid_constant__ Dims d, void* const* __restrict__ g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long row = blockIdx.x;
  move_state(d, g, row, smem, true);
  __syncthreads();
  if (threadIdx.x < 32) {
    const Lane x{d, smem, g, row, (int)threadIdx.x};
    Sc sc;
#define HTS_LOAD(k) sc.k = *reinterpret_cast<const int*>(smem + d.off[K_##k]);
    HTS_SCALARS(HTS_LOAD)
#undef HTS_LOAD
    Strm sr{0, 0, 0, 0, false, x.L < d.NS};
    if (sr.is) {
      const int* st = x.arg<int>(A_streams, d.NS * 4) + x.L * 4;
      sr.start = __ldg(st);
      sr.end = __ldg(st + 1);
      sr.arr = __ldg(st + 2);
      sr.w = clampi(__ldg(st + 3), 0, PRIO_CAP);
      sr.active = sr.end > sr.start;
    }
    const int limit = wadd(sc.steps, d.budget);
    while (!sc.halted && !sc.overflow && sc.cycle < d.max_cycles &&
           sc.steps < limit) {
      step_top(x, sc, sr);
      fu_exec_enqueue(x, sc);
      bool br_ready = memread_tick(sc);
      grant(x, sc, br_ready);
      branch_core(x, sc, br_ready);
      if (d.S <= 32) issue<1>(x, sc);
      else issue<2>(x, sc);
      frontend(x, sc, sr);
      step_bottom(x, sc, sr);
    }
    if (x.L == 0) {
#define HTS_STORE(k) *reinterpret_cast<int*>(smem + d.off[K_##k]) = sc.k;
      HTS_SCALARS(HTS_STORE)
#undef HTS_STORE
    }
  }
  __syncthreads();
  move_state(d, g, row, smem, false);
}

}  // namespace

extern "C" {

// One launch: dims as cuda_run.dims() packs them (host memory), ptrs a
// device array of the carry's and the arguments' pointers.
int hts_run(const int* dims, int ndims, void* ptrs, void* stream) {
  if (ndims != (int)(sizeof(Dims) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  if (d.n <= 0) return (int)cudaGetLastError();
  if (d.smem_bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        hts_run_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        d.smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  hts_run_kernel<<<d.n, THREADS, d.smem_bytes, (cudaStream_t)stream>>>(
      d, (void* const*)ptrs);
  return (int)cudaGetLastError();
}

// What the card makes of the kernel at these dims: out[0] CTAs an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[1] registers a
// thread, out[2] local (spill) bytes a thread, out[3] threads a CTA.
int hts_run_occupancy(const int* dims, int ndims, int* out) {
  if (ndims != (int)(sizeof(Dims) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  cudaError_t e = cudaSuccess;
  if (d.smem_bytes > 48 * 1024)
    e = cudaFuncSetAttribute(hts_run_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             d.smem_bytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[0], hts_run_kernel, THREADS, d.smem_bytes);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, hts_run_kernel);
  if (e == cudaSuccess) {
    out[1] = attr.numRegs;
    out[2] = (int)attr.localSizeBytes;
    out[3] = THREADS;
  }
  return (int)e;
}

}  // extern "C"
