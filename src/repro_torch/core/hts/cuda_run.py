"""The population machine's step loop as one persistent CUDA kernel.

``csrc/hts_run.cu`` runs a slice of the machine on the card: one CTA per
lane, each looping over the step's phases (K1–K4's work and the plain
phases between them) until its lane halts, overflows, reaches
``max_cycles`` or its step limit.  It is bit-identical to the per-phase
loop (:func:`machine._loop`) on every carry array.  Here:

* :func:`run_slice` — the wrapper: for a carry on the card it checks every
  carry and argument tensor (device, dtype, per-lane shape, contiguity),
  packs the launch's sizes and shared-memory layout (:func:`dims`) and one
  device array of the tensors' pointers (:data:`CARRY_KEYS`, then
  :data:`ARG_KEYS`), launches once and counts it (:data:`launches`).  It
  raises for a carry anywhere else: ``machine`` routes a CPU carry to the
  plain version, the per-phase loop with ``cuda_step``'s plain K1–K4;
* :func:`layout` — where each hot array lives in the CTA's shared memory;
  :func:`fits` says whether the kernel takes a spec (within
  :data:`SMEM_LIMIT` and the kernel's other limits), and :func:`check_fits`
  raises ``ValueError`` before any launch for one it does not.

The library is built at first use with ``nvcc`` (``-gencode
arch=compute_90a,code=sm_90a``) into ``build/repro_torch/`` and loaded with
``ctypes`` (:mod:`repro_torch._build`); nothing is compiled at import.
"""
from __future__ import annotations

import ctypes

import torch

from ... import _build
from . import cuda_step
from .costs import FUNC_CYCLES, NUM_FUNCS
from .isa import FIELDS
from .policy import NUM_PIDS

I32 = torch.int32
BOOL = torch.bool
BIG = 2**30
INT_MAX = 2**31 - 1

#: the carry's keys in ``machine.init_state``'s order, the order of the
#: kernel's ``enum Key``; their dtypes and shapes come from the machine
#: (``Machine.carry_spec``)
CARRY_KEYS = (
    "pc", "cycle", "dt", "fe_wait", "fe_ptr", "fe_stall", "next_uid", "age",
    "ticket", "regs", "mem", "rs_valid", "rs_uid", "rs_func", "rs_dep",
    "rs_age", "rs_out_s", "rs_out_e", "rs_src", "rs_exec", "rs_spec",
    "rs_pid", "fu_busy", "fu_uid", "fu_rem", "fu_out_s", "fu_out_e",
    "fu_src", "fu_spec", "fu_busy_cycles", "fu_pid", "trk_valid", "trk_s",
    "trk_e", "trk_uid", "trk_spec", "tlb_valid", "tlb_os", "tlb_oe",
    "tlb_slot", "tlb_seq", "tlb_com", "tlb_seq_ctr", "cdb_valid", "cdb_uid",
    "cdb_ticket", "cdb_ready", "cdb_spec", "br_active", "br_kind", "br_pc",
    "br_off", "br_cond", "br_thr", "br_addr", "br_wait", "br_speculating",
    "br_stream", "spec_active", "spec_ckpt", "mr_active", "mr_rem",
    "halted", "overflow", "stall_cycles", "spec_aborted", "steps",
    "tr_func", "tr_dispatch", "tr_issue", "tr_complete", "tr_broadcast",
    "tr_dep", "tr_aborted", "tr_pid")
#: the read-only arguments after them (``enum Arg``): the program-table
#: fields the step reads, then ``machine.Args``
ARG_KEYS = ("op", "acc", "a", "asz", "b", "bsz", "pid", "ctl", "exists",
            "effects", "prio", "quota", "rs_cap", "cost", "eft", "streams")
#: ``struct Dims``'s leading ints, in order; then MAX_FUNCS function
#: latencies and, per carry key, its offset, kind and length a lane
HEADER = ("n", "S", "T", "L", "C", "U", "NFU", "NF", "Wc", "M", "W", "R",
          "NS", "P", "NP", "TMS", "tm_base", "tm_slot_words",
          "tlb_drain_cycles", "mem_read_cycles", "max_cycles", "budget",
          "event_skip", "in_order", "dispatch_serial_cost",
          "completion_extra", "speculation", "issue_width", "cdb_width",
          "scratch", "smem_bytes")
MAX_FUNCS = 32
#: where a carry array lives (``enum Kind``): an int32 row, a bool row (a
#: byte an element) or a bool row as a bitmap in shared memory; an int32 or
#: bool scalar (an int in shared memory); an int32 or bool row left in
#: device memory (the uid-indexed traces)
ROW32, ROW8, BITS, SC32, SC8, TRACE32, TRACE8 = range(7)
#: the CDB's valid and speculative bits are bitmaps (K1's free-slot scan)
BITMAPS = ("cdb_valid", "cdb_spec")
#: shared memory a CTA can have on Hopper (227 KB)
SMEM_LIMIT = 232448
#: the kernel's limits: entry e of the RS sits in lane e % 32 of warp 0 in
#: one of two slots; a stream and an output word a lane; the TM slots in
#: one bitmap word; a done-unit word a lane
MAX_S, MAX_NS, MAX_W, MAX_TMS, MAX_NFU = 64, 32, 32, 32, 1024

_P, _I = _build.P, _build.I
#: ``csrc/hts_run.cu``: ``LIB.build()`` compiles it, ``LIB.info`` holds the
#: last build's report (seconds, command, ptxas's -Xptxas -v)
LIB = _build.Library("hts_run.cu", {
    "hts_run": [_P, _I, _P, _P],            # dims, ndims, pointers, stream
    "hts_run_occupancy": [_P, _I, _P],      # dims, ndims, out[4]
}, ("run",))
SOURCE = LIB.source
#: kernel launches (plain-version calls are not counted)
launches, reset_launches = LIB.launches, LIB.reset_launches


def _kind(key: str, dtype, shape) -> int:
    if key.startswith("tr_"):
        return TRACE8 if dtype == BOOL else TRACE32
    if not shape:
        return SC8 if dtype == BOOL else SC32
    if key in BITMAPS:
        return BITS
    return ROW8 if dtype == BOOL else ROW32


def layout(m, NS: int) -> tuple[dict, int, int]:
    """The CTA's shared memory: ``({key: (byte offset, kind, elements a
    lane)}, scratch offset, total bytes)``.  4-byte arrays first (int32
    rows, scalars, bitmaps), then the scratch (``NFU`` ints: K1's done
    units by rank, K3's entry for each unit), then the bool rows (a byte an
    element); the total rounds up to 16.  Traces have offset -1."""
    spec = m.carry_spec(NS)
    out, off = {}, 0
    for k in CARRY_KEYS:
        dtype, shape = spec[k]
        kind, n = _kind(k, dtype, shape), (shape[0] if shape else 1)
        if kind in (ROW32, SC32, SC8, BITS):
            out[k] = (off, kind, n)
            off += 4 * (-(-n // 32) if kind == BITS else n)
    scratch = off
    off += 4 * m.NFU
    for k in CARRY_KEYS:
        dtype, shape = spec[k]
        kind = _kind(k, dtype, shape)
        if kind == ROW8:
            out[k] = (off, kind, shape[0])
            off += shape[0]
        elif kind in (TRACE32, TRACE8):
            out[k] = (-1, kind, shape[0])
    return out, scratch, -(-off // 16) * 16


def _misfit(m, NS: int) -> str | None:
    """Why the kernel cannot take this machine (with ``NS`` frontend
    streams), or None where it can."""
    p = m.p
    limits = (("rs_entries", p.rs_entries, MAX_S),
              ("frontend streams", NS, MAX_NS),
              ("max_out_words", m.W, MAX_W), ("tm_slots", p.tm_slots,
                                                MAX_TMS),
              ("units", m.NFU, MAX_NFU), ("function classes", NUM_FUNCS,
                                           MAX_FUNCS))
    for what, v, cap in limits:
        if v > cap:
            return f"hts_run takes at most {cap} {what}, got {v}"
    if m.W > m.M:
        return f"max_out_words {m.W} exceeds memory {m.M}"
    smem = layout(m, NS)[2]
    if smem > SMEM_LIMIT:
        return (f"hts_run needs {smem} bytes of shared memory a CTA for "
                f"this spec (M={m.M}, C={m.C}, NFU={m.NFU}, "
                f"S={p.rs_entries}, T={p.tracker_entries}); the card has "
                f"{SMEM_LIMIT}")
    return None


def fits(m, NS: int) -> bool:
    """Whether ``hts_run`` takes machine ``m`` with ``NS`` frontend
    streams: ``machine._advance`` chooses its route by this before any
    launch."""
    return _misfit(m, NS) is None


def check_fits(m, NS: int) -> int:
    """Raise ``ValueError`` where the kernel cannot take this machine;
    return its shared bytes a CTA."""
    why = _misfit(m, NS)
    if why is not None:
        raise ValueError(why)
    return layout(m, NS)[2]


def dims(m, n: int, NS: int, budget: int) -> torch.Tensor:
    """The launch's ``struct Dims`` as a host int32 tensor."""
    p, c = m.p, m.c
    lay, scratch, smem = layout(m, NS)
    head = dict(
        n=n, S=p.rs_entries, T=p.tracker_entries, L=p.tlb_entries, C=m.C,
        U=m.U, NFU=m.NFU, NF=NUM_FUNCS, Wc=m.Wc, M=m.M, W=m.W,
        R=p.num_regs, NS=NS, P=m.max_prog, NP=NUM_PIDS, TMS=p.tm_slots,
        tm_base=p.tm_base, tm_slot_words=p.tm_slot_words,
        tlb_drain_cycles=p.tlb_drain_cycles,
        mem_read_cycles=p.mem_read_cycles,
        max_cycles=min(int(m.spec.max_cycles), INT_MAX),
        budget=int(min(budget, BIG)), event_skip=int(m.spec.event_skip),
        in_order=int(c.in_order),
        dispatch_serial_cost=c.dispatch_serial_cost,
        completion_extra=c.completion_extra,
        speculation=int(c.speculation), issue_width=c.issue_width,
        cdb_width=c.cdb_width, scratch=scratch, smem_bytes=smem)
    vals = [head[k] for k in HEADER]
    vals += list(FUNC_CYCLES) + [0] * (MAX_FUNCS - len(FUNC_CYCLES))
    for field in range(3):
        vals += [lay[k][field] for k in CARRY_KEYS]
    return torch.tensor(vals, dtype=I32)


def _arg_tensors(a) -> dict:
    """``machine.Args`` by :data:`ARG_KEYS`."""
    out = {k: a.F[k] for k in ARG_KEYS if k in FIELDS}
    out.update(exists=a.exists, effects=a.effects, prio=a.prio,
               quota=a.quota, rs_cap=a.rs_cap, cost=a.cost, eft=a.eft,
               streams=a.streams)
    return out


def _check_all(m, st: dict, a) -> tuple[int, int]:
    """Every carry and argument tensor against the machine's shapes
    (``cuda_step._check``); returns (lanes, streams)."""
    n, NS = a.streams.shape[0], a.streams.shape[1]
    dev = st["cycle"].device
    spec = m.carry_spec(NS)
    if set(st) != set(CARRY_KEYS):
        raise ValueError(f"carry keys {sorted(set(st) ^ set(CARRY_KEYS))} "
                         "differ from machine.init_state's")
    cuda_step._check(n, dev, [(k, st[k], *spec[k]) for k in CARRY_KEYS])
    args = _arg_tensors(a)
    shapes = dict(exists=(BOOL, (m.NFU,)), effects=(I32, (m.M,)),
                  prio=(I32, (NUM_PIDS,)), quota=(I32, (NUM_PIDS,)),
                  rs_cap=(I32, (NUM_PIDS,)), cost=(I32, (m.NFU,)),
                  eft=(I32, ()), streams=(I32, (NS, 4)))
    cuda_step._check(n, dev, [(k, args[k], *shapes.get(k, (I32,
                                                            (m.max_prog,))))
                              for k in ARG_KEYS])
    return n, NS


def pointers(st: dict, a, device) -> torch.Tensor:
    """The carry's and the arguments' data pointers, in kernel order, as
    one int64 tensor on ``device``."""
    args = _arg_tensors(a)
    ptrs = [st[k].data_ptr() for k in CARRY_KEYS]
    ptrs += [args[k].data_ptr() for k in ARG_KEYS]
    return torch.tensor(ptrs, dtype=torch.int64, device=device)


def run_slice(m, st: dict, a, budget: int) -> dict:
    """Advance every alive lane of carry ``st``, on the card, by at most
    ``budget`` steps in one ``hts_run`` launch, in place (per-lane limit
    ``steps + budget`` at entry), and add the largest number of steps any
    lane advanced to ``m.stats["trips"]``."""
    dev = st["cycle"].device
    if not _build.on_card(dev):
        raise ValueError(f"hts_run runs on the card; the carry is on {dev}")
    n, NS = _check_all(m, st, a)
    check_fits(m, NS)
    if n == 0:
        return st
    steps0 = st["steps"].clone()
    d = dims(m, n, NS, budget)
    LIB.launch("hts_run", "run", d, d.numel(), pointers(st, a, dev))
    m.stats["trips"] += int((st["steps"] - steps0).max())
    return st


def occupancy(m, NS: int) -> dict:
    """What the card makes of ``hts_run`` for machine ``m``: CTAs an SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local (spill) bytes a thread, threads and shared bytes a CTA."""
    smem = check_fits(m, NS)
    d = dims(m, 1, NS, 1)
    out = (ctypes.c_int * 4)()
    rc = LIB.load().hts_run_occupancy(d.data_ptr(), d.numel(),
                                      ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"hts_run_occupancy: CUDA error {rc}")
    return dict(ctas_per_sm=out[0], registers=out[1], local_bytes=out[2],
                threads=out[3], shared_bytes=smem)
