"""Golden cycle-accurate HTS simulator (pure Python oracle).

This module pins down the *exact* cycle-level semantics of the Hardware Task
Scheduler; ``machine.py`` re-implements the same semantics as a population
machine in torch (its step kernels in CUDA), held to this oracle by
``api.compare`` and to the JAX reference machine by the port's tests.

Within-cycle phase order (both simulators MUST follow it exactly):

  1. FU tick            — busy accelerators count down; on reaching 0 the task's
                          result is written to memory and a completion record is
                          queued for the CDB (ticket = completion order), the
                          accelerator is freed (ASR busy bit cleared).
  2. memread tick       — the pseudo-unit spawned by an MR branch counts down.
  3. CDB grant          — up to ``cdb_width`` queued completions whose
                          ``ready_cycle`` has arrived broadcast in ticket order:
                          RS dependencies wake, Memory-Tracker entries retire,
                          a BR branch waiting on this uid becomes resolvable.
  4. branch resolve     — evaluate condition; on speculation: commit (retain TLB
                          mappings) or squash (discard TLB, abort speculative
                          tasks, redirect PC).  Non-speculative stalls unblock.
  5. RS issue           — ready reservation-station entries issue to idle
                          accelerators of their class, up to ``issue_width``
                          per cycle.  Order is the policy's issue key:
                          priority class first (per-pid weight, higher wins),
                          age within a class; a pid at its per-class FU quota
                          is masked out without consuming the unit
                          (``policy.SchedPolicy``; all-default = pure age
                          order, the paper's arbiter).  Unit selection
                          within the class: greedy = lowest free index;
                          ``issue_mode="eft"`` = earliest predicted finish
                          under the per-(class, unit) cost tables
                          (``HtsParams.fu_cost``), ties to lowest index.
  6. frontend           — the frontend *arbiter* grants one eligible dispatch
                          stream (per-tenant frontends, ``frontend.py``) and
                          fetch/decode/dispatches its next instruction (tasks
                          allocate RS + tracker + optionally TLB/TM; control
                          instructions execute on the scheduler's GPRs).  A
                          stream is eligible when it has arrived (``cycle >=
                          arrival``), is not drained, its decode window is
                          free, it is not stalled on its own unresolved
                          branch, and its next instruction can act — a TASK
                          blocked on a full RS / full tracker / its pid's RS
                          admission cap (``policy.rs_caps``) makes the stream
                          ineligible, so the arbiter skips it and the stall
                          backpressures *that tenant only*.  Arbitration is
                          round-robin over eligible streams; with
                          ``SchedPolicy(fe_mode="weighted")`` a stream's pid
                          weight ranks first (round-robin within a class).
                          One branch unit and one speculation domain are
                          shared: while a speculation is open only the
                          speculating stream is granted.  The default single
                          stream covering the whole program reproduces the
                          historical merged in-order frontend bit-for-bit.
  7. halt check / cycle++

Memory-value semantics: the simulator tracks *scheduling*, not DSP math — as in
the paper's Python model.  Task outputs take their values from a benchmark-
provided ``effects`` image: completing a task copies
``effect_mem[orig_out + i] → mem[phys_out + i]``.  Branch conditions read
``mem`` (TLB-remapped), so benchmarks control taken/not-taken outcomes by
seeding ``mem_init`` / ``effects``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import isa
from .costs import (FUNC_CYCLES, MEM_READ_CYCLES, NUM_FUNCS, SchedulerCosts,
                    norm_fu_cost)
from .policy import AGE_SPAN, NUM_PIDS, PRIO_CAP, SchedPolicy

# ---------------------------------------------------------------------------
# Capacities (design-time parameters of the HTS, paper §IV-C)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class HtsParams:
    num_regs: int = 32          # GPR bank size
    mem_words: int = 1024       # main memory image (region address space used)
    rs_entries: int = 32        # reservation-station capacity (instruction window)
    tracker_entries: int = 64   # Memory Tracker capacity
    tlb_entries: int = 16       # Task Lookup Buffer capacity
    tm_slots: int = 16          # Transactional Memory slots
    tm_slot_words: int = 16     # words per TM slot
    tlb_drain_cycles: int = 20  # cost to drain one committed TLB entry (TM→mem)
    mem_read_cycles: int = MEM_READ_CYCLES
    max_tasks: int = 1024       # schedule-trace capacity
    #: CDB completion-queue capacity.  ``None`` = ``max_tasks`` (can never
    #: bind).  The golden oracle's queue is unbounded either way; in the
    #: compiled machine an exceeded capacity raises the ``overflow`` flag
    #: (a loud refusal, like a uid overflow), and a right-sized value
    #: shrinks the per-step state the population batch pays for.
    cdb_entries: Optional[int] = None
    n_fu: tuple[int, ...] = (1,) * NUM_FUNCS   # units per function class
    policy: SchedPolicy = SchedPolicy()        # per-pid weights + FU quotas
    #: per-(class, unit) execution-latency multipliers — heterogeneous FU
    #: instances within a class.  Hashable tuple-of-rows form (build with
    #: ``costs.fu_cost_tuple``); ``None`` = every unit identical (cost 1),
    #: the paper's machine.  Unit ``u`` of class ``c`` executes a task in
    #: ``FUNC_CYCLES[c] * fu_cost[c][u]`` cycles.
    fu_cost: Optional[tuple] = None

    @property
    def tm_base(self) -> int:
        return self.mem_words

    @property
    def total_mem(self) -> int:
        return self.mem_words + self.tm_slots * self.tm_slot_words


@dataclasses.dataclass
class TaskRecord:
    uid: int
    func: int
    dispatch_cycle: int
    issue_cycle: int = -1
    complete_cycle: int = -1
    broadcast_cycle: int = -1
    dep_uid: int = 0
    is_spec: bool = False
    aborted: bool = False
    pid: int = 0                # owning process (ISA pid field, multi-tenant)
    #: flattened FU-pool index the task executed on (-1 = never issued).
    #: Oracle-only instrumentation for the EFT invariant tests — NOT part
    #: of ``schedule_tuple`` (the machine does not record it).
    unit: int = -1


@dataclasses.dataclass
class Result:
    cycles: int
    tasks: list[TaskRecord]
    mem: np.ndarray
    regs: np.ndarray
    fu_busy_cycles: np.ndarray          # (total_fus,)
    spec_aborted: int
    stall_cycles: int
    halted: bool                        # False ⇒ hit max_cycles (bug or livelock)
    #: per-stream dispatch-stall cycles: cycles a stream had arrived and
    #: still held undispatched instructions but was not granted the
    #: frontend (single merged stream ⇒ one entry).
    fe_stall: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(1, dtype=np.int64))

    def schedule_tuple(self):
        """Canonical tuple for equivalence testing against the JAX machine."""
        return [(t.uid, t.func, t.dispatch_cycle, t.issue_cycle,
                 t.complete_cycle, t.broadcast_cycle, t.aborted, t.pid)
                for t in self.tasks]


class _RS:
    __slots__ = ("uid", "func", "dep_uid", "age", "out_s", "out_e", "src_s",
                 "exec_cycles", "is_spec", "pid")

    def __init__(self, uid, func, dep_uid, age, out_s, out_e, src_s,
                 exec_cycles, is_spec, pid=0):
        self.uid, self.func, self.dep_uid, self.age = uid, func, dep_uid, age
        self.out_s, self.out_e, self.src_s = out_s, out_e, src_s
        self.exec_cycles, self.is_spec, self.pid = exec_cycles, is_spec, pid


def run(code: np.ndarray,
        costs: SchedulerCosts,
        params: HtsParams = HtsParams(),
        mem_init: Optional[dict[int, int]] = None,
        effects: Optional[dict[int, int]] = None,
        max_cycles: int = 5_000_000,
        streams: Optional[np.ndarray] = None) -> Result:
    """Execute ``code`` under scheduler cost model ``costs``; return the schedule.

    ``streams`` is the per-tenant frontend table — (n_streams, 4) int32 rows
    of ``frontend.STREAM_FIELDS`` (start, end, arrival, weight).  ``None``
    (the default) is the historical single merged in-order frontend covering
    the whole program.
    """
    tbl = isa.decode_table(code)
    P = len(tbl)
    p = params

    if streams is None:
        streams = np.asarray([[0, P, 0, 0]], dtype=np.int64)
    else:
        streams = np.asarray(streams, dtype=np.int64)
    NS = len(streams)
    s_start = [int(x) for x in streams[:, 0]]
    s_end = [int(x) for x in streams[:, 1]]
    s_arr = [int(x) for x in streams[:, 2]]
    s_w = [min(max(int(x), 0), PRIO_CAP) for x in streams[:, 3]]
    s_active = [s_end[i] > s_start[i] for i in range(NS)]

    regs = np.zeros(p.num_regs, dtype=np.int64)
    mem = np.zeros(p.total_mem, dtype=np.int64)
    effect_mem = np.zeros(p.total_mem, dtype=np.int64)
    for k, v in (mem_init or {}).items():
        mem[k] = v
    for k, v in (effects or {}).items():
        effect_mem[k] = v

    pcs = list(s_start)                # per-stream program counters
    fe_waits = [0] * NS                # per-stream decode windows
    fe_ptr = 0                         # frontend round-robin pointer
    fe_stall = np.zeros(NS, dtype=np.int64)
    cycle = 0
    next_uid = 1
    age_ctr = 0
    ticket_ctr = 0
    stall_cycles = 0
    spec_aborted = 0

    rs: list[_RS] = []
    # FU pool: flattened (class, unit) with existence from n_fu.  Each unit
    # carries its latency multiplier from the per-(class, unit) cost table
    # (all ones unless params.fu_cost makes the pool heterogeneous).
    _ct = norm_fu_cost(p.fu_cost, width=max((16,) + tuple(p.n_fu)))
    fu_cls: list[int] = []
    fu_cost: list[int] = []
    for c in range(NUM_FUNCS):
        fu_cls.extend([c] * p.n_fu[c])
        fu_cost.extend(int(_ct[c, u]) for u in range(p.n_fu[c]))
    n_total_fu = len(fu_cls)
    fu_busy = [False] * n_total_fu
    fu_uid = [0] * n_total_fu
    fu_rem = [0] * n_total_fu
    fu_pid = [0] * n_total_fu          # owning pid while busy (quota accounting)
    fu_meta: list[Optional[tuple]] = [None] * n_total_fu  # (out_s,out_e,src_s,is_spec)
    fu_busy_cycles = np.zeros(n_total_fu, dtype=np.int64)

    # scheduling policy: per-pid priority weights and per-class FU quotas.
    # The arbiter orders ready RS entries by the scalar issue key
    # (priority class first, age within class) — see policy.SchedPolicy.
    _wt = p.policy.weight_array(NUM_PIDS).astype(np.int64)
    _qt = p.policy.quota_array(NUM_PIDS).astype(np.int64)
    _rc = p.policy.rs_cap_array(NUM_PIDS).astype(np.int64)
    _eft = p.policy.issue_mode == "eft"

    tracker: list[dict] = []          # {s, e, uid, is_spec}
    tlb: list[dict] = []              # {os, oe, tm_s, spec, committed, seq}
    tlb_seq = 0
    tm_free = list(range(p.tm_slots))
    cdb: list[dict] = []              # {uid, ticket, ready, is_spec}
    memread_active = False
    memread_rem = 0

    # branch bookkeeping (one shared branch unit; ``stream`` owns it)
    br: Optional[dict] = None         # {kind, pc, off, cond, thr, addr, wait_uid,
    #                                    speculating, stream}
    spec_active = False
    spec_regs_ckpt: Optional[np.ndarray] = None   # GPR checkpoint at spec entry

    tasks: list[TaskRecord] = []
    by_uid: dict[int, TaskRecord] = {}

    def remap(addr: int) -> int:
        """TLB remap of a physical read address (latest matching entry wins)."""
        best = None
        for e in tlb:
            if e["os"] <= addr < e["oe"]:
                if best is None or e["seq"] > best["seq"]:
                    best = e
        if best is None:
            return addr
        return p.tm_base + best["tm_s"] * p.tm_slot_words + (addr - best["os"])

    def tracker_lookup(s: int, e: int) -> int:
        """Latest in-flight producer overlapping [s, e); 0 if none."""
        best = 0
        for t in tracker:
            if t["s"] < e and s < t["e"]:
                best = max(best, t["uid"])
        return best

    def eval_cond(cond: int, v: int, thr: int) -> bool:
        if cond == isa.CND_EQ:
            return v == thr
        if cond == isa.CND_NEQ:
            return v != thr
        if cond == isa.CND_GE:
            return v >= thr
        return v <= thr

    def machine_empty() -> bool:
        return (not rs and not any(fu_busy) and not cdb
                and not memread_active and br is None)

    while cycle < max_cycles:
        # ---- 1. FU tick ------------------------------------------------
        for i in range(n_total_fu):
            if fu_busy[i]:
                fu_busy_cycles[i] += 1
                fu_rem[i] -= 1
                if fu_rem[i] == 0:
                    out_s, out_e, src_s, is_spec = fu_meta[i]
                    for j in range(out_e - out_s):
                        mem[out_s + j] = effect_mem[src_s + j]
                    cdb.append({"uid": fu_uid[i], "ticket": ticket_ctr,
                                "ready": cycle + costs.completion_extra,
                                "is_spec": is_spec})
                    ticket_ctr += 1
                    by_uid[fu_uid[i]].complete_cycle = cycle
                    fu_busy[i] = False
                    fu_uid[i] = 0

        # ---- 2. memread tick -------------------------------------------
        br_value_ready = False
        if memread_active:
            memread_rem -= 1
            if memread_rem == 0:
                memread_active = False
                br_value_ready = True

        # ---- 3. CDB grant ----------------------------------------------
        granted = 0
        while granted < costs.cdb_width:
            ready = [e for e in cdb if e["ready"] <= cycle]
            if not ready:
                break
            e = min(ready, key=lambda x: x["ticket"])
            cdb.remove(e)
            granted += 1
            uid = e["uid"]
            by_uid[uid].broadcast_cycle = cycle
            for r in rs:
                if r.dep_uid == uid:
                    r.dep_uid = 0
            tracker[:] = [t for t in tracker if t["uid"] != uid]
            if br is not None and br["kind"] == isa.BR_BR and br["wait_uid"] == uid:
                br_value_ready = True

        # ---- 4. branch resolve -------------------------------------------
        if br is not None and br_value_ready:
            value = int(mem[remap(br["addr"])])
            taken = eval_cond(br["cond"], value, br["thr"])
            target = br["pc"] + (br["off"] if taken else 1)
            if br["speculating"]:
                if not taken:          # predicted not-taken → correct
                    for t in tlb:
                        if not t["committed"]:
                            t["committed"] = True
                    for t in tracker:
                        t["is_spec"] = False
                    for r in rs:
                        r.is_spec = False
                    for i in range(n_total_fu):
                        if fu_busy[i] and fu_meta[i][3]:
                            fu_meta[i] = fu_meta[i][:3] + (False,)
                    for e in cdb:
                        e["is_spec"] = False
                else:                  # mis-speculation → squash
                    for t in tlb:
                        if not t["committed"]:
                            tm_free.append(t["tm_s"])
                    tlb[:] = [t for t in tlb if t["committed"]]
                    tracker[:] = [t for t in tracker if not t["is_spec"]]
                    for r in rs:
                        if r.is_spec:
                            by_uid[r.uid].aborted = True
                            spec_aborted += 1
                    rs[:] = [r for r in rs if not r.is_spec]
                    for i in range(n_total_fu):
                        if fu_busy[i] and fu_meta[i][3]:
                            by_uid[fu_uid[i]].aborted = True
                            spec_aborted += 1
                            fu_busy[i] = False
                            fu_uid[i] = 0
                    cdb[:] = [e for e in cdb if not e["is_spec"]]
                    if spec_regs_ckpt is not None:
                        regs[:] = spec_regs_ckpt   # roll back GPR side effects
                    pcs[br["stream"]] = target
                    fe_waits[br["stream"]] = 0
                spec_active = False
                spec_regs_ckpt = None
            else:
                pcs[br["stream"]] = target
            br = None

        # ---- 5. RS issue --------------------------------------------------
        # Weighted arbiter: ready entries considered priority-class first
        # (higher weight wins), age order within a class; a pid at its
        # per-class in-flight quota is skipped without consuming the unit
        # (work-conserving — the unit falls to the next eligible entry).
        issued = 0
        inflight: dict[tuple[int, int], int] = {}
        for i in range(n_total_fu):
            if fu_busy[i]:
                k = (fu_pid[i], fu_cls[i])
                inflight[k] = inflight.get(k, 0) + 1
        for r in sorted(rs, key=lambda x:
                        (PRIO_CAP - _wt[x.pid]) * AGE_SPAN + x.age):
            if issued >= costs.issue_width:
                break
            if r.dep_uid != 0:
                continue
            free_slots = [i for i in range(n_total_fu)
                          if fu_cls[i] == r.func and not fu_busy[i]]
            if not free_slots:
                continue
            if inflight.get((r.pid, r.func), 0) >= _qt[r.pid]:
                continue                   # quota mask: pid at its class cap
            if _eft:
                # EFT unit selection: grant the free unit with the earliest
                # predicted finish (busy units are not candidates, so the
                # busy-horizon term is 0 and finish = base cycles × unit
                # cost); ties break to the lowest index.  Uniform costs
                # reduce this to the greedy lowest-index rule exactly.
                slot = min(free_slots,
                           key=lambda i: (r.exec_cycles * fu_cost[i], i))
            else:
                slot = free_slots[0]
            fu_busy[slot] = True
            fu_uid[slot] = r.uid
            fu_rem[slot] = r.exec_cycles * fu_cost[slot]
            fu_pid[slot] = r.pid
            fu_meta[slot] = (r.out_s, r.out_e, r.src_s, r.is_spec)
            inflight[(r.pid, r.func)] = inflight.get((r.pid, r.func), 0) + 1
            by_uid[r.uid].issue_cycle = cycle
            by_uid[r.uid].unit = slot
            rs.remove(r)
            issued += 1

        # ---- 6. frontend (arbitrated per-tenant streams) -------------------
        # Eligibility snapshot: arrived, undrained streams whose decode
        # window is free, not stalled on their own branch, and whose next
        # instruction can act this cycle.  A structurally-stalled TASK
        # (full RS / full tracker / pid at its rs_cap) makes the stream
        # ineligible — the arbiter skips it, so admission caps backpressure
        # one tenant instead of head-of-line blocking everyone.
        drained_pre = [pcs[i] >= s_end[i] for i in range(NS)]
        arrived = [cycle >= s_arr[i] for i in range(NS)]
        elig = []
        for i in range(NS):
            ok = (s_active[i] and arrived[i] and not drained_pre[i]
                  and fe_waits[i] == 0)
            if ok and br is not None:
                # one shared branch unit / speculation domain: while a
                # speculation is open only the speculating stream runs;
                # a non-speculative branch stalls only its own stream
                ok = ((i == br["stream"]) if br["speculating"]
                      else (i != br["stream"]))
            if ok:
                op_i = int(tbl[pcs[i]][0])
                if op_i == isa.OP_TASK:
                    pid_i = int(tbl[pcs[i]][7])
                    if costs.in_order and not machine_empty():
                        ok = False
                    elif (len(rs) >= p.rs_entries
                          or len(tracker) >= p.tracker_entries
                          or sum(1 for r in rs if r.pid == pid_i)
                          >= _rc[pid_i]):
                        ok = False   # structural stall (incl. RS admission
                        #              cap: this pid is at its RS quota)
                    elif spec_active:
                        if not tm_free:
                            # drainable only if a committed victim exists
                            ok = any(t["committed"] for t in tlb)
                        elif len(tlb) >= p.tlb_entries:
                            ok = False
                elif op_i == isa.OP_IF:
                    if br is not None:
                        # depth-1 speculation: the one branch unit is busy
                        ok = False
                    elif ((int(tbl[pcs[i]][8]) & 0x3) != isa.BR_RR
                          and costs.in_order and not machine_empty()):
                        ok = False
            elig.append(ok)

        granted = None
        if any(elig):
            # round-robin over eligible streams; fe_mode="weighted" ranks
            # a stream's pid priority weight first (policy.fe_mode is
            # lowered into the table's weight column by the caller)
            granted = min((i for i in range(NS) if elig[i]),
                          key=lambda i: ((PRIO_CAP - s_w[i]) * NS
                                         + (i - fe_ptr) % NS))
            fe_ptr = (granted + 1) % NS
        for i in range(NS):
            # dispatch-stall accounting (per-stream head-of-line metric)
            if (s_active[i] and arrived[i] and not drained_pre[i]
                    and i != granted):
                fe_stall[i] += 1
            if fe_waits[i] > 0:        # decode windows tick every cycle
                fe_waits[i] -= 1

        progressed = granted is not None
        if granted is not None:
            g = granted
            pc = pcs[g]
            op, acc, a, asz, b, bsz, tid, pid_, ctl, meta = (int(x) for x in tbl[pc])
            if op == isa.OP_TASK:
                in_s = int(regs[a]) if ctl & isa.CTL_IN_INDIRECT else a
                out_s = int(regs[b]) if ctl & isa.CTL_OUT_INDIRECT else b
                in_e, out_e = in_s + asz, out_s + bsz
                phys_in = remap(in_s)
                dep = tracker_lookup(phys_in, phys_in + (in_e - in_s))
                if spec_active:
                    if not tm_free:
                        # TLB/TM full: drain the oldest committed entry
                        # (eligibility guaranteed one exists).  Structural
                        # work, not a dispatch — the cycle still stalls.
                        committed = [t for t in tlb if t["committed"]]
                        victim = min(committed, key=lambda t: t["seq"])
                        base = (p.tm_base
                                + victim["tm_s"] * p.tm_slot_words)
                        for j in range(victim["oe"] - victim["os"]):
                            mem[victim["os"] + j] = mem[base + j]
                        tm_free.append(victim["tm_s"])
                        tlb.remove(victim)
                        fe_waits[g] = p.tlb_drain_cycles
                        progressed = False
                    else:
                        slot_id = min(tm_free)   # lowest-index slot (matches machine)
                        tm_free.remove(slot_id)
                        tlb.append({"os": out_s, "oe": out_e, "tm_s": slot_id,
                                    "committed": False, "seq": tlb_seq})
                        tlb_seq += 1
                        phys_out = p.tm_base + slot_id * p.tm_slot_words
                        self_spec = True
                        _dispatch_task(rs, tracker, by_uid, tasks, acc, dep,
                                       phys_out, phys_out + (out_e - out_s),
                                       out_s, next_uid, age_ctr, cycle,
                                       self_spec, pid_)
                        next_uid += 1
                        age_ctr += 1
                        fe_waits[g] = costs.dispatch_serial_cost - 1
                        pcs[g] = pc + 1
                else:
                    _dispatch_task(rs, tracker, by_uid, tasks, acc, dep,
                                   out_s, out_e, out_s, next_uid, age_ctr,
                                   cycle, False, pid_)
                    next_uid += 1
                    age_ctr += 1
                    fe_waits[g] = costs.dispatch_serial_cost - 1
                    pcs[g] = pc + 1
            elif op == isa.OP_ADD:
                regs[b] = regs[a] + regs[asz]
                pcs[g] = pc + 1
            elif op == isa.OP_MUL:
                regs[b] = regs[a] * regs[asz]
                pcs[g] = pc + 1
            elif op == isa.OP_MOV:
                regs[b] = a if ctl & isa.CTL_IMM else regs[a]
                pcs[g] = pc + 1
            elif op == isa.OP_JUMP:
                pcs[g] = a                # absolute (stream-relocated at build)
            elif op == isa.OP_LBEG:
                regs[asz] = int(regs[a]) if ctl & 1 else a
                pcs[g] = pc + 1
            elif op == isa.OP_LEND:
                regs[asz] -= 1
                pcs[g] = pc - b if regs[asz] > 0 else pc + 1
            elif op == isa.OP_IF:
                kind = ctl & 0x3
                cond = (ctl >> 2) & 0x3
                thr = int(regs[asz])
                if kind == isa.BR_RR:
                    taken = eval_cond(cond, int(regs[a]), thr)
                    pcs[g] = pc + b if taken else pc + 1
                    fe_waits[g] = 1  # single-cycle bubble (paper §IV-C3)
                else:
                    phys = remap(a)
                    wait_uid = tracker_lookup(phys, phys + 1)
                    eff_kind = kind
                    if kind == isa.BR_BR and wait_uid == 0:
                        eff_kind = isa.BR_MR   # producer already done
                    speculate = costs.speculation and not spec_active
                    br = {"kind": eff_kind, "pc": pc, "off": b, "cond": cond,
                          "thr": thr, "addr": a, "wait_uid": wait_uid,
                          "speculating": speculate, "stream": g}
                    if eff_kind == isa.BR_MR:
                        memread_active = True
                        memread_rem = p.mem_read_cycles
                    if speculate:
                        spec_active = True
                        spec_regs_ckpt = regs.copy()
                        pcs[g] = pc + 1    # predicted not-taken
            else:   # OP_NOP
                pcs[g] = pc + 1

        if not progressed:
            stall_cycles += 1

        cycle += 1

        # ---- 7. halt check ----------------------------------------------
        if (all(pcs[i] >= s_end[i] for i in range(NS))
                and not rs and not any(fu_busy) and not cdb
                and br is None and not memread_active
                and all(w == 0 for w in fe_waits)):
            return Result(cycles=cycle, tasks=tasks, mem=mem, regs=regs,
                          fu_busy_cycles=fu_busy_cycles,
                          spec_aborted=spec_aborted, stall_cycles=stall_cycles,
                          halted=True, fe_stall=fe_stall)

    return Result(cycles=cycle, tasks=tasks, mem=mem, regs=regs,
                  fu_busy_cycles=fu_busy_cycles, spec_aborted=spec_aborted,
                  stall_cycles=stall_cycles, halted=False, fe_stall=fe_stall)


def _dispatch_task(rs, tracker, by_uid, tasks, acc, dep, out_s, out_e, src_s,
                   uid, age, cycle, is_spec, pid=0):
    """Shared dispatch bookkeeping (RS + tracker + trace)."""
    # WAW replacement: a new producer of an overlapping range supersedes
    # older tracker entries (strict paper mode would skip this; see DESIGN.md).
    tracker[:] = [t for t in tracker
                  if not (t["s"] < out_e and out_s < t["e"])]
    tracker.append({"s": out_s, "e": out_e, "uid": uid, "is_spec": is_spec})
    rs.append(_RS(uid, acc, dep, age, out_s, out_e, src_s,
                  FUNC_CYCLES[acc], is_spec, pid))
    rec = TaskRecord(uid=uid, func=acc, dispatch_cycle=cycle, dep_uid=dep,
                     is_spec=is_spec, pid=pid)
    tasks.append(rec)
    by_uid[uid] = rec
