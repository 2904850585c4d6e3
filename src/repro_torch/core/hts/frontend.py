"""Per-tenant frontends: N independent dispatch streams into one HTS.

The paper's system model (Fig. 1) has N general-purpose CPUs, *each*
pushing its own task stream into the shared scheduler.  The repo's
original multi-tenant model collapsed that to ONE merged in-order stream
(``Program.merge`` round-robin splices the tenants' instructions), and the
``rs_admission`` study in ``BENCH_priority.json`` measured the
consequence: with a single frontend, dispatch order IS stream order, so a
blocking admission stall on a greedy tenant also stalls every tenant
behind it — no admission policy can help a late arrival
(head-of-line blocking at the frontend, not the RS, binds).

This module is the mechanism that closes that bound.  A
:class:`MultiProgram` keeps the tenants' instruction streams *separate*
inside one code image: stream ``i`` owns the half-open PC range
``[start_i, end_i)`` and has its own program counter, decode/serial-cost
window (``fe_wait``) and **arrival offset** (the cycle its CPU starts
pushing).  Each cycle a *frontend arbiter* picks one eligible stream and
dispatches its next instruction into the shared reservation station:

* **eligible** — arrived (``cycle >= arrival``), not drained, decode
  window free, not stalled on its own unresolved branch, and its next
  instruction can actually act (a TASK blocked on a full RS / full
  tracker / its pid's ``rs_caps`` admission cap is *skipped*, not
  waited on — that skip is precisely what turns ``SchedPolicy.rs_caps``
  from a structural stall of everyone into per-stream backpressure);
* **arbitration** — round-robin over eligible streams by default;
  ``SchedPolicy(fe_mode="weighted")`` orders streams by their pid's
  priority weight first (round-robin within a weight class), echoing the
  per-queue decoupled dispatch of hardware-HEFT (Fusco et al. 2022).

One branch unit and one speculation domain are shared: a stream whose
MR/BR branch is unresolved stalls only *itself*; while a speculation is
open the arbiter grants only the speculating stream (its GPR checkpoint
and the TLB/TM speculative state belong to that path alone).

Both simulators implement the identical arbitration — ``golden.py``
scalar-wise, ``machine.py`` as a vectorised argmin over a traced
``(n_streams, 4)`` stream table that rides the same shape buckets as the
program table — and ``hts.compare`` proves them schedule-equivalent
across event-skip modes, including batched populations.

A single stream covering the whole program (the default built by
``api``/``batch`` when a program has no stream table) degrades
bit-for-bit to the historical merged-frontend model; the degradation is
pinned by ``tests/test_hts_frontend.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from . import isa
from .builder import BuilderError, Program, _collect_pids
from .policy import PRIO_CAP, SchedPolicy

#: columns of the machine-facing stream table (int32, one row per stream).
#: ``weight`` is the *frontend* arbitration weight — resolved from the run's
#: :class:`SchedPolicy` at call time (``fe_mode="weighted"`` maps a stream to
#: its pid's priority weight; the default round-robin mode zeroes the
#: column), so the compiled machine never needs the policy object itself.
STREAM_FIELDS = ("start", "end", "arrival", "weight")

#: streams are tenant CPUs; the 4-bit ISA pid field bounds useful counts.
MAX_STREAMS = 16


@dataclasses.dataclass(frozen=True)
class Stream:
    """One tenant frontend: a PC range of the shared code image + arrival."""
    start: int                  # first instruction (absolute PC)
    end: int                    # one past the last instruction
    arrival: int = 0            # cycle this CPU starts pushing
    pid: int = 0                # owning process (weight lookup + metrics)
    name: str = ""

    def __post_init__(self):
        if self.start < 0 or self.end < self.start:
            raise BuilderError(f"stream {self.name!r}: bad PC range "
                               f"[{self.start}, {self.end})")
        if self.arrival < 0:
            raise BuilderError(f"stream {self.name!r}: arrival offset must "
                               f"be >= 0, got {self.arrival}")

    def __len__(self) -> int:
        return self.end - self.start


@dataclasses.dataclass(frozen=True)
class StreamSet:
    """The per-tenant frontends of one program (ordered, immutable).

    The machine-facing form is :meth:`table` — a ``(n_streams, 4)`` int32
    array in :data:`STREAM_FIELDS` order, a *runtime input* of the
    compiled machine exactly like the policy tables (sweeping arrivals or
    frontend weights never recompiles).
    """
    streams: tuple[Stream, ...]

    def __post_init__(self):
        if not self.streams:
            raise BuilderError("a StreamSet needs at least one stream")
        if len(self.streams) > MAX_STREAMS:
            raise BuilderError(f"{len(self.streams)} streams exceed "
                               f"MAX_STREAMS={MAX_STREAMS}")

    def __len__(self) -> int:
        return len(self.streams)

    def __iter__(self):
        return iter(self.streams)

    @property
    def pids(self) -> tuple[int, ...]:
        return tuple(s.pid for s in self.streams)

    @property
    def arrivals(self) -> tuple[int, ...]:
        return tuple(s.arrival for s in self.streams)

    def arrival_of(self, pid: int) -> int:
        """Earliest arrival among the streams owned by ``pid`` (0 if none)."""
        arr = [s.arrival for s in self.streams if s.pid == pid]
        return min(arr) if arr else 0

    @classmethod
    def single(cls, length: int, pid: int = 0) -> "StreamSet":
        """The degenerate one-stream set: the historical merged frontend."""
        return cls((Stream(0, int(length), 0, pid, "merged"),))

    def table(self, policy: Optional[SchedPolicy] = None) -> np.ndarray:
        """(n_streams, 4) int32 machine table; frontend weights resolved
        from ``policy`` (zero — pure round-robin — unless the policy's
        ``fe_mode`` is ``"weighted"``)."""
        pol = policy or SchedPolicy()
        weighted = pol.fe_mode == "weighted"
        out = np.zeros((len(self.streams), len(STREAM_FIELDS)), np.int32)
        for i, s in enumerate(self.streams):
            w = pol.weight_of(s.pid) if weighted else 0
            out[i] = (s.start, s.end, s.arrival,
                      min(max(int(w), 0), PRIO_CAP))
        return out


@dataclasses.dataclass(frozen=True)
class MultiProgram:
    """A built multi-stream program: one code image, N dispatch streams.

    Accepted everywhere a program is (``hts.run``/``run_many``/``sweep``/
    ``compare``, ``pack_population``); :mod:`batch` lowers it to the code
    array plus the :class:`StreamSet` stream table.
    """
    name: str
    code: np.ndarray
    streams: StreamSet
    mem_init: dict[int, int]
    effects: dict[int, int]
    keynames: dict[str, int]
    policy: Optional[SchedPolicy] = None

    @property
    def n_streams(self) -> int:
        return len(self.streams)

    @property
    def asm(self) -> str:
        """Disassembly of the shared code image (stream ranges in order)."""
        names = {v: k for k, v in self.keynames.items()}
        return isa.disassemble(self.code, names)

    def with_arrivals(self, arrivals: Sequence[int]) -> "MultiProgram":
        """The same program with per-stream arrival offsets replaced."""
        if len(arrivals) != len(self.streams):
            raise BuilderError(f"got {len(arrivals)} arrivals for "
                               f"{len(self.streams)} streams")
        new = StreamSet(tuple(
            dataclasses.replace(s, arrival=int(a))
            for s, a in zip(self.streams, arrivals)))
        return dataclasses.replace(self, streams=new)


def _stream_pid(prog: Program) -> int:
    """The owning pid of a tenant program (its tasks' unique pid; 0 when
    the program emits no tasks or mixes pids)."""
    pids = _collect_pids(prog._nodes)
    return pids.pop() if len(pids) == 1 else 0


def build_frontends(programs: Sequence[Program], name: str = "shared", *,
                    arrivals: Optional[Sequence[int]] = None,
                    require_distinct_pids: bool = True,
                    priorities: Optional[dict[int, int]] = None,
                    quotas: Optional[dict[int, int]] = None,
                    rs_caps: Optional[dict[int, int]] = None,
                    fe_mode: Optional[str] = None) -> MultiProgram:
    """Lower N tenant :class:`Program`\\ s to one :class:`MultiProgram`.

    The tenants' isolation invariants (disjoint written regions, disjoint
    register sets, optionally distinct pids) and policy/image unioning are
    exactly :meth:`Program.merge`'s — the same checks run here — but the
    instruction streams stay **separate**: stream ``i`` occupies the code
    range ``[start_i, end_i)``, registers are numbered jointly across the
    streams (they share the scheduler's one GPR bank), and absolute
    ``jump`` targets are relocated by each stream's base.

    ``arrivals`` (cycles, one per program, default all-0) stagger the
    tenants' CPUs.  ``priorities``/``quotas``/``rs_caps`` attach a
    :class:`SchedPolicy` exactly as in ``merge``; ``fe_mode`` ("rr" or
    "weighted") selects the frontend arbitration of that policy.
    """
    programs = list(programs)
    if not programs:
        raise BuilderError("build_frontends needs at least one program")
    if arrivals is not None and len(arrivals) != len(programs):
        raise BuilderError(f"got {len(arrivals)} arrivals for "
                           f"{len(programs)} programs")
    # one merge runs every isolation check and unions images/keynames/policy
    merged = Program.merge(programs, name,
                           require_distinct_pids=require_distinct_pids,
                           priorities=priorities, quotas=quotas,
                           rs_caps=rs_caps)
    policy = merged.policy
    if fe_mode is not None:
        policy = dataclasses.replace(policy or SchedPolicy(),
                                     fe_mode=SchedPolicy._norm_fe_mode(fe_mode))

    # flatten each tenant separately: stream boundaries are just the
    # cumulative flat lengths, independent of register numbering
    flats: list[list] = []
    for p in programs:
        flat: list = []
        p._flatten(p._nodes, flat)
        flats.append(flat)
    regmap = merged._resolve_regs([op for f in flats for op in f])

    def rr(x):
        return regmap[x] if not isinstance(x, int) else int(x)

    instrs: list[isa.Instr] = []
    rows: list[Stream] = []
    start = 0
    for i, (p, flat) in enumerate(zip(programs, flats)):
        for o in flat:
            a = rr(o.a)
            if o.op == isa.OP_JUMP:
                a += start          # relocate absolute jump targets
            instrs.append(isa.Instr(op=o.op, acc=o.acc, a=a, asz=rr(o.asz),
                                    b=rr(o.b), bsz=o.bsz, tid=o.tid,
                                    pid=o.pid, ctl=o.ctl, meta=o.meta))
        end = start + len(flat)
        rows.append(Stream(start, end,
                           int(arrivals[i]) if arrivals is not None else 0,
                           _stream_pid(p), p.name))
        start = end
    return MultiProgram(name=name, code=isa.encode_program(instrs),
                        streams=StreamSet(tuple(rows)),
                        mem_init=dict(merged.mem_init),
                        effects=dict(merged.effects),
                        keynames=dict(merged.keynames), policy=policy)


__all__ = ["MAX_STREAMS", "STREAM_FIELDS", "Stream", "StreamSet",
           "MultiProgram", "build_frontends"]
