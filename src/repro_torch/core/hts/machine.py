"""The cycle-level HTS population machine in PyTorch.

Same semantics as :mod:`golden` (see its docstring for the within-cycle
phase order): fixed-capacity state tensors, one state row per *lane*, and a
loop that steps every lane.  A lane is one scenario; a single run is a
population of one.  Everything is int32 or bool, so the machine is
bit-identical to the JAX reference machine on every output array.

The step is a sequence of phase functions, module-level over a
:class:`Machine` (the frozen spec plus its device constants), in the
phase order of the reference's ``"pallas"`` population step:

    step_top → fu_exec → cdb_enqueue (K1) → memread_tick → cdb_grant (K2)
    → branch_core → rs_issue (K3) → frontend_core → dispatch_traces (K4,
    which also writes the branch squash's ``tr_aborted`` traces — the
    reference's ``abort_traces``) → step_bottom (with next_dt)

:meth:`Machine.run` and :meth:`Machine.run_slice` advance a carry by a
route that follows the carry's device (:func:`_advance`):

* on the card, one launch of the persistent kernel ``hts_run``
  (:func:`cuda_run.run_slice`, ``csrc/hts_run.cu``): a CTA per lane runs
  all of the step's phases in a loop until its lane halts, overflows,
  reaches ``max_cycles`` or its step limit;
* on the CPU, its plain version, the per-phase host loop :func:`_loop`:
  :func:`step` over every lane at once, K1–K4 through :mod:`cuda_step`'s
  plain torch versions and the other phases in plain torch.

The per-phase loop also runs on the card (:func:`step`, :func:`_loop`),
with :mod:`cuda_step`'s four CUDA kernels, as the yardstick ``hts_run`` is
held against; no entry point takes it.  It checks "any lane alive" only
every :data:`CHECK_EVERY` trips, which is exact: a halted lane, and a lane
at its step limit, is a fixed point of the step.

JAX semantics that plain torch does not share are reproduced explicitly:
a data-dependent gather clamps its index the way JAX does (:func:`take`),
scatters with the "no write" index drop (in :mod:`cuda_step`), ties in
argmin/argmax go to the first index, and every count is cast back to
int32.

GPR side effects on a squashed speculative path are rolled back from a
checkpoint taken at speculation entry.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ... import _build
from . import cuda_run, cuda_step, isa
from .costs import FUNC_CYCLES, NUM_FUNCS, SchedulerCosts, norm_fu_cost
from .golden import HtsParams
from .policy import AGE_SPAN, NUM_PIDS, PRIO_CAP, SchedPolicy

I32 = torch.int32
BOOL = torch.bool
NEG = -1
BIG = 2**30
#: the per-phase loop (:func:`_loop`) reads "any lane alive" back from the
#: device once per this many trips (extra trips are exact: dead and paused
#: lanes are fixed points); ``hts_run`` checks each lane every step
CHECK_EVERY = 16


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one, only an explicit CPU request
    runs: the machine never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False (no CUDA device here); pass device='cpu' to run the plain "
            "torch version on the CPU")
    return dev


@dataclasses.dataclass(frozen=True)
class MachineSpec:
    """Static configuration of one machine (the reference's compile key)."""
    params: HtsParams = HtsParams()
    costs: SchedulerCosts = None
    max_fu_per_class: int = 16     # FU pool width (n_fu may be ≤ this)
    event_skip: bool = True
    max_cycles: int = 5_000_000
    #: widest task output (words) the completion datapath writes back in one
    #: cycle; a dispatch with a wider output raises ``overflow``
    max_out_words: int = 16


@dataclasses.dataclass(frozen=True, eq=False)
class Machine:
    """A :class:`MachineSpec` bound to a program-table size and a device.

    ``init(*args)`` builds the carry (one state row per lane),
    ``run_slice(carry, *args, budget)`` advances every alive lane by at
    most ``budget`` steps and returns a new carry, ``collect(carry)`` maps a
    carry to the output dict, and ``run(*args)`` runs to completion.
    ``args`` are the 11 population arrays of
    ``batch.PackedPopulation.machine_args()`` (numpy or tensors).
    ``stats["trips"]`` adds up, over the calls, the largest number of steps
    any lane advanced in each.
    """
    spec: MachineSpec
    max_prog: int
    device: torch.device
    stats: dict = dataclasses.field(default_factory=lambda: {"trips": 0})

    # ---- static sizes (the reference's make_machine locals)
    @property
    def p(self) -> HtsParams:
        return self.spec.params

    @property
    def c(self) -> SchedulerCosts:
        return self.spec.costs

    @property
    def Wc(self) -> int:
        return self.spec.max_fu_per_class

    @property
    def NFU(self) -> int:
        return NUM_FUNCS * self.spec.max_fu_per_class

    @property
    def U(self) -> int:
        return self.p.max_tasks + 1    # uid-indexed trace arrays (uid 0 unused)

    @property
    def C(self) -> int:
        return self.p.cdb_entries or self.p.max_tasks

    @property
    def M(self) -> int:
        return self.p.total_mem

    @property
    def W(self) -> int:
        return self.spec.max_out_words

    def iota(self, n: int) -> torch.Tensor:
        return torch.arange(n, dtype=I32, device=self.device)

    @property
    def fu_cls(self) -> torch.Tensor:
        return torch.arange(NUM_FUNCS, dtype=I32, device=self.device
                            ).repeat_interleave(self.Wc)

    # ---- the resumable trio + run to completion
    def init(self, *args) -> dict[str, torch.Tensor]:
        a = norm_args(self, *args)
        return init_state(self, a.mem_init, a.streams)

    def run_slice(self, carry: dict, *args, budget: int) -> dict:
        """Advance every alive lane by at most ``budget`` steps.  Per-lane
        limits are ``steps + budget`` at entry, so each lane pauses exactly
        at its ceiling and the returned carry feeds straight back in.  The
        kernels update state in place, so the carry is copied first: the
        argument is left as it was.  One ``hts_run`` launch on the card."""
        a = norm_args(self, *args)
        st = {k: v.clone() for k, v in carry.items()}
        return _advance(self, st, a, budget)

    def collect(self, carry: dict) -> dict[str, torch.Tensor]:
        return collect(carry)

    def run(self, *args) -> dict[str, torch.Tensor]:
        a = norm_args(self, *args)
        st = init_state(self, a.mem_init, a.streams)
        return collect(_advance(self, st, a, BIG))

    def carry_spec(self, NS: int) -> dict:
        """Each carry key's (dtype, shape a lane) with ``NS`` frontend
        streams: what :func:`init_state` builds (one lane, on the CPU)."""
        st = init_state(self, torch.zeros((1, self.M), dtype=I32),
                        torch.zeros((1, NS, 4), dtype=I32))
        return {k: (v.dtype, tuple(v.shape[1:])) for k, v in st.items()}


def make_machine(spec: MachineSpec, max_prog: int = 256,
                 device=None) -> Machine:
    """The population machine under ``spec`` on ``device`` (None = CUDA)."""
    p = spec.params
    if p.max_tasks > AGE_SPAN:
        raise ValueError(
            f"max_tasks {p.max_tasks} exceeds the issue-key age span "
            f"{AGE_SPAN} (policy.AGE_SPAN); the int32 weighted-arbiter key "
            "would overflow")
    return Machine(spec=spec, max_prog=max_prog,
                   device=resolve_device(device))


# ---------------------------------------------------------------------------
# arguments and state
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Args:
    """The machine's 11 population arguments, normalised to tensors."""
    F: dict[str, torch.Tensor]     # per-field (N, P) program tables
    exists: torch.Tensor           # (N, NFU) bool: unit exists under n_fu
    mem_init: torch.Tensor
    effects: torch.Tensor
    prio: torch.Tensor
    quota: torch.Tensor
    rs_cap: torch.Tensor
    cost: torch.Tensor             # (N, NFU) per-unit latency multipliers
    eft: torch.Tensor
    streams: torch.Tensor          # (N, NS, 4)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           device=device).to(I32).contiguous()


def norm_args(m: Machine, ftab, p_len, n_fu, mem_init, effects, prio=None,
              quota=None, rs_cap=None, fu_cost=None, eft=None,
              streams=None) -> Args:
    dev = m.device
    ftab = _i32(ftab, dev)
    n = ftab.shape[0]
    F = {name: ftab[..., i].contiguous() for i, name in enumerate(isa.FIELDS)}
    p_len = _i32(p_len, dev)
    n_fu = _i32(n_fu, dev)
    exists = (torch.arange(m.Wc, dtype=I32, device=dev).repeat(NUM_FUNCS)
              < n_fu[:, m.fu_cls.long()])
    prio = (torch.zeros((n, NUM_PIDS), dtype=I32, device=dev) if prio is None
            else _i32(prio, dev))
    quota = (torch.full((n, NUM_PIDS), BIG, dtype=I32, device=dev)
             if quota is None else _i32(quota, dev))
    rs_cap = (torch.full((n, NUM_PIDS), BIG, dtype=I32, device=dev)
              if rs_cap is None else _i32(rs_cap, dev))
    if fu_cost is None:
        cost = torch.ones((n, m.NFU), dtype=I32, device=dev)
    else:
        fu_cost = _i32(fu_cost, dev)
        w = fu_cost.shape[-1]
        if w > m.Wc:       # tables pack at costs.FU_COST_WIDTH: use the prefix
            fu_cost = fu_cost[..., :m.Wc]
        elif w < m.Wc:
            fu_cost = torch.cat([fu_cost, torch.ones(
                fu_cost.shape[:-1] + (m.Wc - w,), dtype=I32, device=dev)], -1)
        # (NF, Wc) → (NFU,) row-major: class-major like fu_cls
        cost = fu_cost.reshape(n, m.NFU).contiguous()
    eft = (torch.zeros((n,), dtype=I32, device=dev) if eft is None
           else _i32(eft, dev))
    if streams is None:
        # one merged frontend stream covering [0, p_len), arrival 0
        streams = torch.zeros((n, 1, 4), dtype=I32, device=dev)
        streams[:, 0, 1] = p_len
    else:
        streams = _i32(streams, dev)
    return Args(F=F, exists=exists.contiguous(),
                mem_init=_i32(mem_init, dev), effects=_i32(effects, dev),
                prio=prio, quota=quota, rs_cap=rs_cap, cost=cost, eft=eft,
                streams=streams)


def init_state(m: Machine, mem_init: torch.Tensor,
               streams: torch.Tensor) -> dict[str, torch.Tensor]:
    """A fresh carry on ``mem_init``'s device: the reference's
    ``init_state`` with a lane axis.  Only ``pc`` and ``mem`` depend on the
    arguments."""
    p, dev = m.p, mem_init.device
    n, NS = streams.shape[0], streams.shape[1]
    S, T, L, C, U, NFU = (p.rs_entries, p.tracker_entries, p.tlb_entries,
                          m.C, m.U, m.NFU)

    def z(*shape):
        return torch.zeros((n,) + shape, dtype=I32, device=dev)

    def zb(*shape):
        return torch.zeros((n,) + shape, dtype=BOOL, device=dev)

    def neg(*shape):
        return torch.full((n,) + shape, NEG, dtype=I32, device=dev)

    return dict(
        pc=streams[:, :, 0].clone().contiguous(), cycle=z(),
        dt=torch.ones((n,), dtype=I32, device=dev),
        fe_wait=z(NS), fe_ptr=z(), fe_stall=z(NS),
        next_uid=torch.ones((n,), dtype=I32, device=dev), age=z(), ticket=z(),
        regs=z(p.num_regs), mem=mem_init.clone(),
        rs_valid=zb(S), rs_uid=z(S), rs_func=z(S), rs_dep=z(S),
        rs_age=z(S), rs_out_s=z(S), rs_out_e=z(S), rs_src=z(S),
        rs_exec=z(S), rs_spec=zb(S), rs_pid=z(S),
        fu_busy=zb(NFU), fu_uid=z(NFU), fu_rem=z(NFU),
        fu_out_s=z(NFU), fu_out_e=z(NFU), fu_src=z(NFU), fu_spec=zb(NFU),
        fu_busy_cycles=z(NFU), fu_pid=z(NFU),
        trk_valid=zb(T), trk_s=z(T), trk_e=z(T), trk_uid=z(T),
        trk_spec=zb(T),
        tlb_valid=zb(L), tlb_os=z(L), tlb_oe=z(L), tlb_slot=z(L),
        tlb_seq=z(L), tlb_com=zb(L), tlb_seq_ctr=z(),
        cdb_valid=zb(C), cdb_uid=z(C), cdb_ticket=z(C), cdb_ready=z(C),
        cdb_spec=zb(C),
        br_active=zb(), br_kind=z(), br_pc=z(), br_off=z(), br_cond=z(),
        br_thr=z(), br_addr=z(), br_wait=z(), br_speculating=zb(),
        br_stream=z(),
        spec_active=zb(), spec_ckpt=z(p.num_regs),
        mr_active=zb(), mr_rem=z(),
        halted=zb(), overflow=zb(),
        stall_cycles=z(), spec_aborted=z(), steps=z(),
        # uid-indexed trace
        tr_func=neg(U), tr_dispatch=neg(U), tr_issue=neg(U),
        tr_complete=neg(U), tr_broadcast=neg(U), tr_dep=z(U),
        tr_aborted=zb(U), tr_pid=z(U),
    )


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def take(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``arr[lane, idx[lane, ...]]`` with JAX's gather semantics: a negative
    index wraps once, then any index is clamped into range (torch would
    raise).  ``idx`` is (N,) or (N, K)."""
    n = arr.shape[1]
    i = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1).long()
    if i.dim() == 1:
        return arr.gather(1, i[:, None])[:, 0]
    return arr.gather(1, i)


def col(x: torch.Tensor) -> torch.Tensor:
    """A per-lane scalar as a column, to broadcast against a lane's rows."""
    return x[:, None]


def remap(m: Machine, st, addr):
    match = (st["tlb_valid"] & (st["tlb_os"] <= col(addr))
             & (col(addr) < st["tlb_oe"]))
    seq = torch.where(match, st["tlb_seq"], -1)
    best = seq.argmax(1)                          # first maximal index
    slot = st["tlb_slot"].gather(1, best[:, None])[:, 0]
    os_ = st["tlb_os"].gather(1, best[:, None])[:, 0]
    phys = m.p.tm_base + slot * m.p.tm_slot_words + (addr - os_)
    return torch.where(match.any(1), phys, addr)


def tracker_lookup(st, s, e):
    ov = st["trk_valid"] & (st["trk_s"] < col(e)) & (col(s) < st["trk_e"])
    return torch.where(ov, st["trk_uid"], 0).amax(1)


def eval_cond(cond, v, thr):
    return torch.where(cond == isa.CND_EQ, v == thr,
                       torch.where(cond == isa.CND_NEQ, v != thr,
                                   torch.where(cond == isa.CND_GE, v >= thr,
                                               v <= thr)))


def machine_empty(st):
    return (~st["rs_valid"].any(1) & ~st["fu_busy"].any(1)
            & ~st["cdb_valid"].any(1) & ~st["mr_active"] & ~st["br_active"])


def alive_of(m: Machine, st):
    return ~st["halted"] & ~st["overflow"] & (st["cycle"] < m.spec.max_cycles)


def first_index(mask: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """``jnp.argmin`` of a bool array: the first False (0 if none).  torch
    refuses bool input to argmin, so compare as int32."""
    return mask.to(I32).argmin(dim)


def copy_window(m: Machine, dst_arr, src_arr, dst, src, n, enable):
    """``dst_arr[dst:dst+n] = src_arr[src:src+n]`` per lane, through one
    W-wide window (the reference's dynamic-slice form, same clamps)."""
    W, M = m.W, m.M
    w_iota = m.iota(W)
    dst_c = dst.clamp(0, M - W)
    off = dst - dst_c
    pos = (col(dst_c) + w_iota).long()
    cur = dst_arr.gather(1, pos)
    vals = src_arr.gather(1, (w_iota - col(off) + col(src)).clamp(0, M - 1)
                          .long())
    mask = col(enable) & (w_iota >= col(off)) & (w_iota < col(off + n))
    return dst_arr.scatter(1, pos, torch.where(mask, vals, cur))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------
def step_top(m: Machine, st, streams, limit):
    """``alive`` gates every phase, so a halted, overflowed or paused lane
    is a fixed point of the step.  ``limit`` is each lane's step ceiling."""
    alive = alive_of(m, st) & (st["steps"] < limit)
    st["steps"] = st["steps"] + alive.to(I32)
    # dispatch-stall accounting for the event-skipped window behind this
    # step, from pre-phase state
    w_stalled = ((streams[:, :, 1] > streams[:, :, 0])
                 & (st["pc"] < streams[:, :, 1])
                 & (streams[:, :, 2] <= col(st["cycle"] - st["dt"])))
    st["fe_stall"] = st["fe_stall"] + torch.where(
        col(alive) & w_stalled, col(st["dt"] - 1), 0)
    return alive


def fu_exec(m: Machine, st, exists, effects, alive):
    """Per-unit execution tick and completion memory writes; returns the
    ``done`` mask for the CDB enqueue."""
    busy = st["fu_busy"] & exists & col(alive)
    dt = col(st["dt"])
    st["fu_busy_cycles"] = st["fu_busy_cycles"] + torch.where(busy, dt, 0)
    rem = torch.where(busy, st["fu_rem"] - dt, st["fu_rem"])
    done = busy & (rem <= 0)
    st["fu_rem"] = rem

    # memory writes in FU-index order, later units overwrite: every unit's
    # W-wide window is computed at once (sources are the read-only effects
    # image), then written unit by unit into a copy of memory with one
    # spare column that takes the masked-off words
    W, M, NFU = m.W, m.M, m.NFU
    w_iota = m.iota(W)
    dst = st["fu_out_s"]
    dst_c = dst.clamp(0, M - W)
    off = dst - dst_c
    n = st["fu_out_e"] - dst
    src = (w_iota - off[..., None] + st["fu_src"][..., None]).clamp(0, M - 1)
    vals = effects.gather(1, src.long().view(-1, NFU * W)).view(-1, NFU, W)
    mask = (done[..., None] & (w_iota >= off[..., None])
            & (w_iota < (off + n)[..., None]))
    pos = torch.where(mask, dst_c[..., None] + w_iota, M).long()
    mem = torch.cat([st["mem"], st["mem"][:, :1]], 1)
    for i in range(NFU):
        mem.scatter_(1, pos[:, i], vals[:, i])
    st["mem"] = mem[:, :M].contiguous()
    return done


def cdb_enqueue(m: Machine, st, done, ops=cuda_step):
    """K1: the k-th done unit (FU-index order) takes the k-th free CDB slot
    and ticket ``ticket + k``; trace ``tr_complete``; free the units."""
    ops.enqueue(st, done, m.c.completion_extra)


def memread_tick(m: Machine, st, alive):
    ticking = st["mr_active"] & alive
    rem = torch.where(ticking, st["mr_rem"] - st["dt"], st["mr_rem"])
    fired = ticking & (rem <= 0)
    st["mr_rem"] = rem
    st["mr_active"] = st["mr_active"] & ~fired
    return fired


def cdb_grant(m: Machine, st, br_ready, alive, ops=cuda_step):
    """K2: ``cdb_width`` broadcasts, each of the ready entry with the
    smallest ticket.  ``br_ready`` (the memory-read firings) is raised in
    place for a bus branch waiting on a broadcast uid; returned."""
    ops.grant(st, br_ready, alive, m.c.cdb_width)
    return br_ready


def branch_core(m: Machine, st, br_ready):
    """Branch resolution; returns the kill masks and the uid arrays as of
    the squash, for the ``tr_aborted`` traces that K4 writes."""
    p = m.p
    fire = st["br_active"] & br_ready
    value = take(st["mem"], remap(m, st, st["br_addr"]))
    taken = eval_cond(st["br_cond"], value, st["br_thr"])
    target = st["br_pc"] + torch.where(taken, st["br_off"], 1)
    spec = st["br_speculating"]

    commit = fire & spec & ~taken
    squash = fire & spec & taken
    plain = fire & ~spec

    # --- commit: speculative state becomes architectural
    st["tlb_com"] = st["tlb_com"] | (col(commit) & st["tlb_valid"])
    for k in ("trk_spec", "rs_spec", "fu_spec", "cdb_spec"):
        st[k] = st[k] & ~col(commit)

    # --- squash: discard speculative state, roll back, redirect.  The
    # updates below build new tensors, so the uid arrays kept here are the
    # values as of the squash even though K1/K3 later write in place.
    rs_kill = col(squash) & st["rs_valid"] & st["rs_spec"]
    fu_kill = col(squash) & st["fu_busy"] & st["fu_spec"]
    rs_uid_k, fu_uid_k = st["rs_uid"], st["fu_uid"]
    st["spec_aborted"] = (st["spec_aborted"] + rs_kill.sum(1, dtype=I32)
                          + fu_kill.sum(1, dtype=I32))
    st["rs_valid"] = st["rs_valid"] & ~rs_kill
    st["fu_busy"] = st["fu_busy"] & ~fu_kill
    st["fu_uid"] = torch.where(fu_kill, 0, st["fu_uid"])
    st["trk_valid"] = st["trk_valid"] & ~(col(squash) & st["trk_spec"])
    st["tlb_valid"] = st["tlb_valid"] & ~(col(squash) & ~st["tlb_com"])
    st["cdb_valid"] = st["cdb_valid"] & ~(col(squash) & st["cdb_spec"])
    st["regs"] = torch.where(col(squash), st["spec_ckpt"], st["regs"])
    # the redirect (and the squash's decode-window reset) lands on the
    # branch-owning stream only
    mine = m.iota(st["pc"].shape[1]) == col(st["br_stream"])
    st["pc"] = torch.where(col(squash | plain) & mine, col(target), st["pc"])
    st["fe_wait"] = torch.where(col(squash) & mine, 0, st["fe_wait"])

    st["spec_active"] = st["spec_active"] & ~(commit | squash)
    st["br_active"] = st["br_active"] & ~fire
    return rs_uid_k, rs_kill, fu_uid_k, fu_kill


def rs_issue(m: Machine, st, exists, prio, quota, cost, eft, alive,
             ops=cuda_step):
    """K3: the weighted RS arbiter (the reference's ``rs_issue_fast`` and
    ``_issue_apply``)."""
    ops.issue(st, exists, prio, quota, cost, eft, alive, m.c.issue_width)


def frontend_core(m: Machine, st, F, rs_cap, streams, alive):
    """N per-tenant streams, one arbitrated dispatch per cycle (weight class
    first, round-robin within a class).  Returns the dispatch record that
    K4 writes into the trace."""
    p, c = m.p, m.c
    P = m.max_prog
    NS = streams.shape[1]
    ns_iota = m.iota(NS)
    s_start, s_end, s_arr = streams[:, :, 0], streams[:, :, 1], streams[:, :, 2]
    s_w = streams[:, :, 3].clamp(0, PRIO_CAP)
    s_active = s_end > s_start
    pcs = st["pc"]
    drained_pre = pcs >= s_end
    arrived = col(st["cycle"]) >= s_arr
    fe_free = st["fe_wait"] == 0

    # one shared branch unit: while a speculation is open only the
    # speculating stream runs; a non-speculative branch stalls its own
    br_mine = ns_iota == col(st["br_stream"])
    br_ok = torch.where(col(st["br_active"]),
                        torch.where(col(st["br_speculating"]), br_mine,
                                    ~br_mine), True)
    base_elig = (s_active & arrived & ~drained_pre & fe_free & br_ok
                 & col(alive))

    pccs = pcs.clamp(0, max(P - 1, 0))
    ops_s = take(F["op"], pccs)
    pids_s = take(F["pid"], pccs)
    kinds_s = take(F["ctl"], pccs) & 0x3

    # TASK-instruction gates (structural stalls + speculative TLB/TM)
    rs_full = st["rs_valid"].all(1)
    trk_full = st["trk_valid"].all(1)
    rs_of_pid = (st["rs_valid"][:, None, :]
                 & (st["rs_pid"][:, None, :] == pids_s[:, :, None])
                 ).sum(2, dtype=I32)
    pid_capped_s = rs_of_pid >= take(rs_cap, pids_s)
    empty_req = bool(c.in_order) & ~machine_empty(st)
    spec = st["spec_active"]
    slot_used = (st["tlb_valid"][:, None, :]
                 & (st["tlb_slot"][:, None, :]
                    == m.iota(p.tm_slots)[None, :, None])).any(2)
    tm_slot = first_index(slot_used)
    tm_avail = ~slot_used.all(1)
    tlb_full = st["tlb_valid"].all(1)
    committed_seq = torch.where(st["tlb_valid"] & st["tlb_com"],
                                st["tlb_seq"], BIG)
    victim = committed_seq.argmin(1)
    has_victim = committed_seq.gather(1, victim[:, None])[:, 0] < BIG
    spec_gate = torch.where(tm_avail, ~tlb_full, has_victim)
    task_ok = (col(~rs_full & ~trk_full & ~empty_req & (~spec | spec_gate))
               & ~pid_capped_s)
    if_ok = col(~st["br_active"]) & ((kinds_s == isa.BR_RR)
                                     | col(~empty_req))
    elig = base_elig & torch.where(ops_s == isa.OP_TASK, task_ok,
                                   torch.where(ops_s == isa.OP_IF, if_ok,
                                               True))

    # the arbiter: weight class first, round-robin within a class (torch %
    # is floor-mod like jnp's)
    key = torch.where(elig, (PRIO_CAP - s_w) * NS
                      + (ns_iota - col(st["fe_ptr"])) % NS, BIG)
    gidx = key.argmin(1)
    has = elig.any(1)
    gmask = col(has) & (ns_iota == col(gidx))
    gidx = gidx.to(I32)
    st["fe_ptr"] = torch.where(has, (gidx + 1) % NS, st["fe_ptr"])

    # decode windows tick every cycle on every stream
    st["fe_wait"] = torch.where(col(alive),
                                (st["fe_wait"] - col(st["dt"])).clamp(min=0),
                                st["fe_wait"])
    stalled_now = s_active & arrived & ~drained_pre & ~gmask
    st["fe_stall"] = st["fe_stall"] + (col(alive) & stalled_now).to(I32)

    # scalar fetch of the granted stream's instruction
    pcc = take(pccs, gidx)
    pc_g = take(pcs, gidx)
    op = take(ops_s, gidx)
    a, asz, b, bsz = (take(F[k], pcc) for k in ("a", "asz", "b", "bsz"))
    ctl = take(F["ctl"], pcc)
    acc = take(F["acc"], pcc)
    active = has

    # ---- control ops (1 cycle each)
    is_add = active & (op == isa.OP_ADD)
    is_mul = active & (op == isa.OP_MUL)
    is_mov = active & (op == isa.OP_MOV)
    is_jmp = active & (op == isa.OP_JUMP)
    is_lbeg = active & (op == isa.OP_LBEG)
    is_lend = active & (op == isa.OP_LEND)
    is_nop = active & (op == isa.OP_NOP)

    regs = st["regs"]
    r_a, r_asz = take(regs, a), take(regs, asz)
    val = torch.where(is_add, r_a + r_asz, torch.where(
        is_mul, r_a * r_asz, torch.where(
            is_mov, torch.where((ctl & isa.CTL_IMM) != 0, a, r_a),
            torch.where(is_lbeg, torch.where((ctl & 1) != 0, r_a, a), 0))))
    writes = is_add | is_mul | is_mov
    wr_reg = torch.where(writes, b, torch.where(is_lbeg, asz, -1))
    lend_val = r_asz - 1
    r_iota = m.iota(p.num_regs)
    regs = torch.where((r_iota == col(wr_reg)) & col(writes | is_lbeg),
                       col(val), regs)
    regs = torch.where((r_iota == col(asz)) & col(is_lend), col(lend_val),
                       regs)
    st["regs"] = regs

    pc_next = torch.where(writes | is_lbeg | is_nop, pc_g + 1, pc_g)
    pc_next = torch.where(is_jmp, a, pc_next)
    pc_next = torch.where(is_lend,
                          torch.where(lend_val > 0, pc_g - b, pc_g + 1),
                          pc_next)
    progressed = writes | is_jmp | is_lbeg | is_lend | is_nop

    # ---- task dispatch: eligibility already cleared the structural and
    # speculative gates, so a granted TASK either dispatches or drains
    is_task = active & (op == isa.OP_TASK)
    in_s = torch.where((ctl & isa.CTL_IN_INDIRECT) != 0, take(regs, a), a)
    out_s = torch.where((ctl & isa.CTL_OUT_INDIRECT) != 0, take(regs, b), b)
    in_e, out_e = in_s + asz, out_s + bsz
    phys_in = remap(m, st, in_s)
    dep = tracker_lookup(st, phys_in, phys_in + (in_e - in_s))

    # drain path: TM full and a committed victim exists
    do_drain = is_task & spec & ~tm_avail
    vic = victim[:, None]
    vic_os = st["tlb_os"].gather(1, vic)[:, 0]
    vic_base = (p.tm_base + st["tlb_slot"].gather(1, vic)[:, 0]
                * p.tm_slot_words)
    st["mem"] = copy_window(m, st["mem"], st["mem"], vic_os, vic_base,
                            st["tlb_oe"].gather(1, vic)[:, 0] - vic_os,
                            do_drain)
    l_iota = m.iota(p.tlb_entries)
    st["tlb_valid"] = st["tlb_valid"] & ~(col(do_drain)
                                          & (l_iota == col(victim)))
    st["fe_wait"] = torch.where(gmask & col(do_drain), p.tlb_drain_cycles,
                                st["fe_wait"])

    dispatch = is_task & ~do_drain
    phys_out = torch.where(spec, p.tm_base + tm_slot.to(I32)
                           * p.tm_slot_words, out_s)
    phys_oe = phys_out + (out_e - out_s)

    # TLB insert for speculative dispatch
    tlb_new = first_index(st["tlb_valid"])
    ins_tlb = dispatch & spec
    tlb_sel = col(ins_tlb) & (l_iota == col(tlb_new))
    st["tlb_valid"] = st["tlb_valid"] | tlb_sel
    st["tlb_os"] = torch.where(tlb_sel, col(out_s), st["tlb_os"])
    st["tlb_oe"] = torch.where(tlb_sel, col(out_e), st["tlb_oe"])
    st["tlb_slot"] = torch.where(tlb_sel, col(tm_slot.to(I32)),
                                 st["tlb_slot"])
    st["tlb_seq"] = torch.where(tlb_sel, col(st["tlb_seq_ctr"]),
                                st["tlb_seq"])
    st["tlb_com"] = st["tlb_com"] & ~tlb_sel
    st["tlb_seq_ctr"] = st["tlb_seq_ctr"] + ins_tlb.to(I32)

    # WAW replacement + tracker insert
    waw = (col(dispatch) & st["trk_valid"] & (st["trk_s"] < col(phys_oe))
           & (col(phys_out) < st["trk_e"]))
    st["trk_valid"] = st["trk_valid"] & ~waw
    trk_new = first_index(st["trk_valid"])
    trk_sel = col(dispatch) & (m.iota(p.tracker_entries) == col(trk_new))
    st["trk_valid"] = st["trk_valid"] | trk_sel
    st["trk_s"] = torch.where(trk_sel, col(phys_out), st["trk_s"])
    st["trk_e"] = torch.where(trk_sel, col(phys_oe), st["trk_e"])
    st["trk_uid"] = torch.where(trk_sel, col(st["next_uid"]), st["trk_uid"])
    st["trk_spec"] = torch.where(trk_sel, col(spec), st["trk_spec"])

    # RS insert
    rs_new = first_index(st["rs_valid"])
    uid = st["next_uid"]
    st["overflow"] = (st["overflow"] | (dispatch & (uid >= m.U))
                      | (dispatch & (out_e - out_s > m.W)))
    uidc = uid.clamp(0, m.U - 1)
    pidv = take(F["pid"], pcc)
    rs_sel = col(dispatch) & (m.iota(p.rs_entries) == col(rs_new))
    st["rs_valid"] = st["rs_valid"] | rs_sel
    func_cycles = torch.tensor(FUNC_CYCLES, dtype=I32, device=m.device)
    for k, v in (("rs_uid", uid), ("rs_func", acc), ("rs_dep", dep),
                 ("rs_age", st["age"]), ("rs_out_s", phys_out),
                 ("rs_out_e", phys_oe), ("rs_src", out_s),
                 ("rs_exec", func_cycles[acc.clamp(0, NUM_FUNCS - 1).long()]),
                 ("rs_pid", pidv), ("rs_spec", spec)):
        st[k] = torch.where(rs_sel, col(v), st[k])
    st["next_uid"] = st["next_uid"] + dispatch.to(I32)
    st["age"] = st["age"] + dispatch.to(I32)
    st["fe_wait"] = torch.where(gmask & col(dispatch),
                                c.dispatch_serial_cost - 1, st["fe_wait"])
    pc_next = torch.where(dispatch, pc_g + 1, pc_next)
    progressed = progressed | dispatch

    # ---- if / branches
    is_if = active & (op == isa.OP_IF) & ~st["br_active"]
    kind = ctl & 0x3
    cond = (ctl >> 2) & 0x3
    thr = take(regs, asz)
    # RR: resolve inline with a 1-cycle bubble
    rr = is_if & (kind == isa.BR_RR)
    rr_taken = eval_cond(cond, take(regs, a), thr)
    pc_next = torch.where(rr, torch.where(rr_taken, pc_g + b, pc_g + 1),
                          pc_next)
    st["fe_wait"] = torch.where(gmask & col(rr), 1, st["fe_wait"])
    # MR/BR (eligibility already cleared the in-order empty-machine
    # requirement and the branch unit being free)
    mrbr = is_if & (kind != isa.BR_RR)
    phys_a = remap(m, st, a)
    wait_uid = tracker_lookup(st, phys_a, phys_a + 1)
    eff_kind = torch.where((kind == isa.BR_BR) & (wait_uid == 0),
                           isa.BR_MR, kind)
    speculate = bool(c.speculation) & ~st["spec_active"]
    st["br_active"] = st["br_active"] | mrbr
    for k, v in (("br_kind", eff_kind), ("br_pc", pc_g), ("br_off", b),
                 ("br_cond", cond), ("br_thr", thr), ("br_addr", a),
                 ("br_wait", wait_uid), ("br_stream", gidx),
                 ("br_speculating", speculate)):
        st[k] = torch.where(mrbr, v, st[k])
    start_mr = mrbr & (eff_kind == isa.BR_MR)
    st["mr_active"] = st["mr_active"] | start_mr
    st["mr_rem"] = torch.where(start_mr, p.mem_read_cycles, st["mr_rem"])
    enter_spec = mrbr & speculate
    st["spec_active"] = st["spec_active"] | enter_spec
    st["spec_ckpt"] = torch.where(col(enter_spec), regs, st["spec_ckpt"])
    pc_next = torch.where(enter_spec, pc_g + 1, pc_next)
    progressed = progressed | rr | mrbr

    st["pc"] = torch.where(gmask, col(pc_next), pcs)
    st["stall_cycles"] = st["stall_cycles"] + (~(progressed | ~alive)
                                               ).to(I32)
    return dict(uid=uidc, acc=acc, dep=dep, pid=pidv, dispatch=dispatch)


def dispatch_traces(m: Machine, st, fe, kills, ops=cuda_step):
    """K4: ``tr_aborted`` for this trip's RS/FU kills (the reference's
    ``abort_traces``), then ``tr_func/tr_dispatch/tr_dep/tr_pid`` at the
    dispatched uid."""
    ops.traces(st, *kills, fe["uid"], fe["acc"], fe["dep"], fe["pid"],
               fe["dispatch"])


def next_dt(m: Machine, st, exists, F, rs_cap, streams):
    """Event-skip: time to the next scheduler event (1 without it)."""
    n = st["cycle"].shape[0]
    if not m.spec.event_skip:
        return torch.ones((n,), dtype=I32, device=m.device)
    c, P = m.c, m.max_prog
    cycle = st["cycle"]
    busy = st["fu_busy"] & exists
    dt = torch.where(busy, st["fu_rem"], BIG).amin(1)
    dt = torch.minimum(dt, torch.where(st["mr_active"], st["mr_rem"], BIG))
    cdb_dt = torch.where(st["cdb_valid"],
                         (st["cdb_ready"] - col(cycle)).clamp(min=1), BIG)
    dt = torch.minimum(dt, cdb_dt.amin(1))
    dt = torch.minimum(dt, torch.where(st["fe_wait"] > 0, st["fe_wait"],
                                       BIG).amin(1))
    # any stream's frontend can act next cycle → no skipping
    NS = streams.shape[1]
    s_end, s_arr = streams[:, :, 1], streams[:, :, 2]
    s_active = s_end > streams[:, :, 0]
    drained = st["pc"] >= s_end
    pccs = st["pc"].clamp(0, max(P - 1, 0))
    at_op = take(F["op"], pccs)
    is_task = at_op == isa.OP_TASK
    in_order_block = (col(bool(c.in_order) & ~machine_empty(st))
                      & (is_task | (at_op == isa.OP_IF)))
    # a structural stall unblocks only via an issue or a grant — skippable
    pid_here = take(F["pid"], pccs)
    pid_capped = ((st["rs_valid"][:, None, :]
                   & (st["rs_pid"][:, None, :] == pid_here[:, :, None]))
                  .sum(2, dtype=I32) >= take(rs_cap, pid_here))
    struct_block = is_task & (col(st["rs_valid"].all(1)
                                  | st["trk_valid"].all(1)) | pid_capped)
    br_mine = m.iota(NS) == col(st["br_stream"])
    br_ok = torch.where(col(st["br_active"]),
                        torch.where(col(st["br_speculating"]), br_mine,
                                    ~br_mine), True)
    fe_act = ((st["fe_wait"] == 0) & br_ok & s_active & ~drained
              & (s_arr <= col(cycle + 1)) & ~in_order_block & ~struct_block)
    dt = torch.where(fe_act.any(1), 1, dt)
    # never skip across a stream arrival
    arr_dt = torch.where(s_active & ~drained & (s_arr > col(cycle)),
                         s_arr - col(cycle), BIG)
    dt = torch.minimum(dt, arr_dt.amin(1))
    # a ready RS entry with a free unit issues next cycle
    free = exists & ~st["fu_busy"]
    n_free = free.view(n, NUM_FUNCS, m.Wc).sum(2, dtype=I32)
    ready = st["rs_valid"] & (st["rs_dep"] == 0)
    issue_now = (ready & (take(n_free, st["rs_func"]) > 0)).any(1)
    dt = torch.where(issue_now, 1, dt)
    return dt.clamp(1, BIG)


def step_bottom(m: Machine, st, exists, F, rs_cap, streams, alive):
    done = ((st["pc"] >= streams[:, :, 1]).all(1) & machine_empty(st)
            & (st["fe_wait"] == 0).all(1))
    dt = next_dt(m, st, exists, F, rs_cap, streams)
    st["cycle"] = st["cycle"] + torch.where(alive, torch.where(done, 1, dt),
                                            0)
    st["dt"] = torch.where(alive, dt, st["dt"])
    st["halted"] = st["halted"] | (alive & done)


def step(m: Machine, st: dict, a: Args, limit, ops=cuda_step) -> None:
    """One machine step of every lane, in place on ``st``.  ``ops``
    supplies K1–K4 (:mod:`cuda_step` unless a caller wraps them)."""
    alive = step_top(m, st, a.streams, limit)
    done = fu_exec(m, st, a.exists, a.effects, alive)
    cdb_enqueue(m, st, done, ops)
    fired = memread_tick(m, st, alive)
    br_ready = cdb_grant(m, st, fired, alive, ops)
    kills = branch_core(m, st, br_ready)
    rs_issue(m, st, a.exists, a.prio, a.quota, a.cost, a.eft, alive, ops)
    fe = frontend_core(m, st, a.F, a.rs_cap, a.streams, alive)
    dispatch_traces(m, st, fe, kills, ops)
    step_bottom(m, st, a.exists, a.F, a.rs_cap, a.streams, alive)


def _advance(m: Machine, st: dict, a: Args, budget: int) -> dict:
    """Advance carry ``st`` in place by at most ``budget`` steps a lane:
    one ``hts_run`` launch for a carry on the card, the per-phase loop with
    the plain K1–K4 for one on the CPU."""
    if _build.on_card(st["cycle"].device):
        return cuda_run.run_slice(m, st, a, budget)
    return _loop(m, st, a, budget)


def _loop(m: Machine, st: dict, a: Args, budget: int, ops=cuda_step) -> dict:
    """The per-phase host loop, in place on ``st``: trips in chunks of
    :data:`CHECK_EVERY` (never more than ``budget``, since no lane can
    advance further), one device read of "any lane alive and under its
    limit" per chunk.  Adds the largest number of steps any lane advanced
    to ``stats["trips"]``, as ``hts_run`` does."""
    budget = int(min(budget, BIG))
    steps0 = st["steps"].clone()
    limit = steps0 + budget
    trips = 0
    while trips < budget:
        chunk = min(CHECK_EVERY, budget - trips)
        for _ in range(chunk):
            step(m, st, a, limit, ops)
        trips += chunk
        if not bool((alive_of(m, st) & (st["steps"] < limit)).any()):
            break
    if steps0.numel():
        m.stats["trips"] += int((st["steps"] - steps0).max())
    return st


def collect(st: dict) -> dict[str, torch.Tensor]:
    return dict(
        cycles=st["cycle"], halted=st["halted"], overflow=st["overflow"],
        n_tasks=st["next_uid"] - 1, spec_aborted=st["spec_aborted"],
        stall_cycles=st["stall_cycles"], steps=st["steps"],
        fe_stall=st["fe_stall"], fu_busy_cycles=st["fu_busy_cycles"],
        mem=st["mem"], regs=st["regs"],
        tr_func=st["tr_func"], tr_dispatch=st["tr_dispatch"],
        tr_issue=st["tr_issue"], tr_complete=st["tr_complete"],
        tr_broadcast=st["tr_broadcast"], tr_dep=st["tr_dep"],
        tr_aborted=st["tr_aborted"], tr_pid=st["tr_pid"],
    )


# ---------------------------------------------------------------------------
# moving state between the reference and the port
# ---------------------------------------------------------------------------
def carry_from_reference(carry: dict[str, np.ndarray],
                         device=None) -> dict[str, torch.Tensor]:
    """The JAX machine's carry (numpy arrays, same keys, shapes and int32 /
    bool dtypes) as the port's carry on ``device``."""
    dev = resolve_device(device)
    out = {}
    for k, v in carry.items():
        v = np.asarray(v)
        if v.dtype not in (np.int32, np.bool_):
            raise TypeError(f"carry[{k!r}] has dtype {v.dtype}; the machine "
                            "state is int32 or bool")
        out[k] = torch.from_numpy(np.array(v, copy=True)).to(dev)
    return out


def args_from_reference(machine_args, device=None) -> tuple:
    """``PackedPopulation.machine_args()`` (11 numpy arrays, reference run
    order) as int32 tensors on ``device``."""
    dev = resolve_device(device)
    if len(machine_args) != 11:
        raise ValueError(f"expected the 11 machine arguments, got "
                         f"{len(machine_args)}")
    return tuple(None if a is None else _i32(a, dev) for a in machine_args)


def carry_to_numpy(carry: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() for k, v in carry.items()}


# ---------------------------------------------------------------------------
# numpy helpers (as in the reference)
# ---------------------------------------------------------------------------
def pack_program(code: np.ndarray, max_prog: int) -> tuple[np.ndarray, int]:
    """Decode + zero-pad a program to the machine's static table shape."""
    tbl = isa.decode_table(code)
    p_len = len(tbl)
    if p_len > max_prog:
        raise ValueError(f"program length {p_len} > max_prog {max_prog}")
    pad = np.zeros((max_prog, tbl.shape[1]), np.int32)
    pad[:p_len] = tbl
    # padding rows decode as acc-id 0 tasks but are never fetched (pc >= p_len)
    return pad, p_len


def images(params: HtsParams, mem_init=None, effects=None):
    mem = np.zeros((params.total_mem,), np.int32)
    eff = np.zeros((params.total_mem,), np.int32)
    for k, v in (mem_init or {}).items():
        mem[k] = v
    for k, v in (effects or {}).items():
        eff[k] = v
    return mem, eff


def simulate(code: np.ndarray, costs: SchedulerCosts,
             params: HtsParams = HtsParams(),
             n_fu=None, mem_init=None, effects=None,
             event_skip: bool = True, max_cycles: int = 5_000_000,
             max_fu_per_class: int = 16, max_prog: int = 256,
             policy: SchedPolicy | None = None, fu_cost=None,
             streams=None, device=None) -> dict[str, Any]:
    """One program as a population of one; returns numpy outputs with the
    lane axis dropped (the reference ``machine.simulate``'s dict)."""
    pol = policy if policy is not None else params.policy
    cost = fu_cost if fu_cost is not None else params.fu_cost
    ms = MachineSpec(params=dataclasses.replace(params, policy=SchedPolicy(),
                                                fu_cost=None),
                     costs=costs, event_skip=event_skip,
                     max_cycles=max_cycles, max_fu_per_class=max_fu_per_class)
    m = make_machine(ms, max_prog, device)
    ftab, p_len = pack_program(code, max_prog)
    mem, eff = images(params, mem_init, effects)
    n_fu = np.asarray(n_fu if n_fu is not None else params.n_fu, np.int32)
    args = (ftab[None], np.asarray([p_len], np.int32), n_fu[None], mem[None],
            eff[None], pol.weight_array()[None], pol.quota_array()[None],
            pol.rs_cap_array()[None], norm_fu_cost(cost)[None],
            np.asarray([1 if pol.issue_mode == "eft" else 0], np.int32),
            None if streams is None else np.asarray(streams, np.int32)[None])
    out = carry_to_numpy(m.run(*args))
    return {k: v[0] for k, v in out.items()}


def schedule_tuple(out: dict[str, Any]) -> list[tuple]:
    """Match golden.Result.schedule_tuple() for equivalence tests."""
    n = int(out["n_tasks"])
    rows = []
    for uid in range(1, n + 1):
        rows.append((uid, int(out["tr_func"][uid]), int(out["tr_dispatch"][uid]),
                     int(out["tr_issue"][uid]), int(out["tr_complete"][uid]),
                     int(out["tr_broadcast"][uid]), bool(out["tr_aborted"][uid]),
                     int(out["tr_pid"][uid])))
    return rows
