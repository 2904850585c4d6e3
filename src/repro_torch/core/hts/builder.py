"""Typed Program Builder for the HTS dataflow ISA (paper §V, Table I).

Assembly vs builder
-------------------
The paper describes programs the way its compiler would emit them — one
128-bit instruction per line, eight hex operand fields in Table-I order
(``assembler.py`` accepts exactly that text).  Hand-writing those lines means
hand-managing three machine resources at once:

* **memory regions** — every task's ``<in_region> <in_size> <out_region>
  <out_size>`` operands are raw addresses, so callers must do the
  ``OUT_BASE + i * RSTRIDE`` arithmetic themselves and nothing checks two
  live regions against overlapping by accident;
* **GPRs** — loops and indirect addressing need scratch registers, picked
  by hand and silently clobbered on reuse;
* **control-flow offsets** — ``if`` takes a *forward PC delta* and ``lend``
  a *backward body length* (Table I / Fig 6), which go stale on every edit.

This module is the embedded-Python front-end that owns those resources:

* :class:`Program` records a structured instruction stream;
* :meth:`Program.region` bump-allocates non-overlapping memory regions
  (:class:`Region`), with ``mem_init``/``effects`` images attached via
  :meth:`Region.init` / :meth:`Region.effect`;
* :meth:`Program.task` emits a typed task call (``p.task("fft_256",
  in_=x, out=4)``) and returns a handle whose output region feeds the next
  task — the dataflow graph reads like a dataflow graph;
* ``with p.loop(n):`` / ``p.branch(...)`` / ``with p.process(pid):`` are
  structured contexts lowered to ``lbeg``/``lend``/``if``/``jump`` with the
  offsets computed for you; :class:`Walker` reproduces the paper's
  walking-pointer idiom (a base register advanced by a stride each
  iteration, §V-B's loop example);
* registers are symbolic (:class:`Reg`) and numbered only at
  :meth:`Program.build`, so two programs can be merged
  (:meth:`Program.interleave`) without clobbering each other's GPRs;
* :meth:`Program.merge` is the N-way tenant merge (region/register/pid
  isolation checked up front) and the natural place to decide QoS:
  ``merge(priorities={pid: weight}, quotas={pid: cap})`` attaches a
  :class:`~repro_torch.core.hts.policy.SchedPolicy` that ``hts.run`` /
  ``hts.compare`` then apply by default.

``build()`` lowers to the exact 128-bit encoding of ``isa.py`` and can also
emit paper-style assembly text (``BuiltProgram.asm`` — byte-for-byte
reassemblable, used by the round-trip property tests), so paper-fidelity
assembly listings remain available for inspection and tests.
"""
from __future__ import annotations

import dataclasses
import itertools
from contextlib import contextmanager
from typing import Iterator, Optional, Sequence, Union

import numpy as np

from . import isa
from .costs import FUNC_IDS
from .policy import SchedPolicy

#: default start of the auto-allocated output-region space (matches the old
#: hand-written ``OUT_BASE``) and its default alignment (old ``RSTRIDE``).
REGION_BASE = 0x100
REGION_ALIGN = 0x8

_CONDS = {"==": isa.CND_EQ, "!=": isa.CND_NEQ, ">=": isa.CND_GE,
          "<=": isa.CND_LE}
_KINDS = {"reg": isa.BR_RR, "mem": isa.BR_MR, "bus": isa.BR_BR}


class BuilderError(ValueError):
    """Raised on malformed Program-Builder usage (bad operand, overlap...)."""


# ---------------------------------------------------------------------------
# operands
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Region:
    """A contiguous span of task memory: ``[addr, addr + size)``."""
    addr: int
    size: int
    name: str = ""
    _prog: Optional["Program"] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def end(self) -> int:
        return self.addr + self.size

    def sub(self, offset: int, size: int, name: str = "") -> "Region":
        """A sub-region view (no new reservation)."""
        if offset < 0 or offset + size > self.size:
            raise BuilderError(
                f"sub-region [{offset}, {offset + size}) outside region "
                f"{self.name or hex(self.addr)} of size {self.size}")
        return Region(self.addr + offset, size, name or self.name,
                      self._prog)

    def init(self, values: Union[int, Sequence[int]], offset: int = 0):
        """Attach initial memory contents (``mem_init`` image) to the region."""
        self._attach("mem_init", values, offset)
        return self

    def effect(self, values: Union[int, Sequence[int]], offset: int = 0):
        """Attach the values a producer task writes here on completion
        (the simulator's ``effects`` image, golden.py docstring)."""
        self._attach("effects", values, offset)
        return self

    def _attach(self, which: str, values, offset: int) -> None:
        if self._prog is None:
            raise BuilderError("region is not attached to a Program")
        vals = [values] if isinstance(values, int) else list(values)
        if offset + len(vals) > self.size:
            raise BuilderError(
                f"{which} image of {len(vals)} words at +{offset} exceeds "
                f"region size {self.size}")
        img = getattr(self._prog, which)
        for i, v in enumerate(vals):
            img[self.addr + offset + i] = int(v)


@dataclasses.dataclass(eq=False)
class Reg:
    """A symbolic GPR; numbered at :meth:`Program.build` in first-use order."""
    name: str = ""

    def __repr__(self) -> str:
        return f"Reg({self.name or hex(id(self))})"


@dataclasses.dataclass(frozen=True)
class TaskHandle:
    """Returned by :meth:`Program.task`; chains the task's output region."""
    index: int
    func: str
    out: Optional[Region]


# ---------------------------------------------------------------------------
# recorded nodes (internal)
# ---------------------------------------------------------------------------
def _walk_nodes(nodes):
    """Yield every node in a block list, descending into loops/branches."""
    for node in nodes:
        yield node
        if isinstance(node, _Loop):
            yield from _walk_nodes(node.body)
        elif isinstance(node, _Branch):
            yield from _walk_nodes(node.taken)
            yield from _walk_nodes(node.not_taken)


def _collect_regs(nodes) -> set:
    """All symbolic Reg objects referenced anywhere in a block tree."""
    regs: set = set()
    for node in _walk_nodes(nodes):
        if isinstance(node, _Op):
            for field in (node.a, node.asz, node.b):
                if isinstance(field, Reg):
                    regs.add(field)
        elif isinstance(node, _Loop):
            regs.add(node.counter)
            if isinstance(node.count, Reg):
                regs.add(node.count)
        elif isinstance(node, _Branch):
            regs.add(node.thr)
            if isinstance(node.on, Reg):
                regs.add(node.on)
    return regs


def _collect_pids(nodes) -> set:
    """Process ids of every task emitted in a block tree."""
    return {node.pid for node in _walk_nodes(nodes)
            if isinstance(node, _Op) and node.op == isa.OP_TASK}



@dataclasses.dataclass
class _Op:
    """One flat instruction with possibly-symbolic (Reg) operands."""
    op: int
    acc: int = 0
    a: object = 0            # int | Reg
    asz: object = 0          # int | Reg
    b: object = 0            # int | Reg
    bsz: int = 0
    tid: int = 0
    pid: int = 0
    ctl: int = 0
    meta: int = 0


@dataclasses.dataclass
class _Loop:
    count: object            # int | Reg
    counter: Reg
    body: list


@dataclasses.dataclass
class _Branch:
    kind: int
    cond: int
    on: object               # int address | Reg
    thr: Reg
    taken: list
    not_taken: list


# ---------------------------------------------------------------------------
# walker
# ---------------------------------------------------------------------------
class Walker:
    """The paper's loop idiom: a base register stepped by a stride register.

    ``w.offset(k)`` materialises a register holding ``base + k`` at the
    current point in the instruction stream; ``w.advance()`` steps the base.
    Used as a task operand, a Walker is its (indirect) base register.
    """

    def __init__(self, prog: "Program", start: int, stride: int,
                 name: str = "walker"):
        self._prog = prog
        self.start = start
        self.stride = stride
        self.name = name
        self.base = Reg(f"{name}.base")
        self._stride_reg = Reg(f"{name}.stride")
        prog.mov(self.base, start)
        prog.mov(self._stride_reg, stride)

    def offset(self, k: int, name: str = "") -> Reg:
        r = self._prog.mov(Reg(name or f"{self.name}+{k:#x}"), self.base)
        if k:
            scratch = self._prog._scratch_reg()
            self._prog.mov(scratch, k)
            self._prog.add(r, r, scratch)
        return r

    def advance(self) -> None:
        self._prog.add(self.base, self.base, self._stride_reg)


# ---------------------------------------------------------------------------
# the builder
# ---------------------------------------------------------------------------
class Program:
    """An HTS dataflow program under construction.

    >>> p = Program("quickstart")
    >>> x = p.input(0x10, 4)
    >>> fft = p.task("fft_256", in_=x, out=4)
    >>> dot = p.task("vector_dot", in_=fft, out=1)
    >>> built = p.build()          # .code (P,4) uint32, .asm, .mem_init, ...
    """

    def __init__(self, name: str = "program", *,
                 keynames: Optional[dict[str, int]] = None,
                 region_base: int = REGION_BASE,
                 region_align: int = REGION_ALIGN,
                 num_regs: int = 32,
                 policy: Optional[SchedPolicy] = None):
        self.name = name
        self.keynames = dict(FUNC_IDS if keynames is None else keynames)
        self.num_regs = num_regs
        #: scheduling policy attached to the program (``hts.run`` applies it
        #: by default; see :meth:`merge`'s ``priorities``/``quotas``)
        self.policy: Optional[SchedPolicy] = policy
        self.mem_init: dict[int, int] = {}
        self.effects: dict[int, int] = {}
        self._nodes: list = []
        self._blocks: list[list] = [self._nodes]
        self._pids: list[int] = [0]
        # (start, end, name, written): written=False marks external inputs,
        # which two interleaved programs may legitimately share
        self._reserved: list[tuple[int, int, str, bool]] = []
        self._alloc_ptr = region_base
        self._align = region_align
        self._scratch: Optional[Reg] = None
        self._n_tasks = 0
        self._in_loop_or_branch = 0

    # -------------------------------------------------------------- regions
    def _overlap(self, s: int, e: int):
        for entry in self._reserved:
            if entry[0] < e and s < entry[1]:
                return entry
        return None

    def _reserve(self, s: int, e: int, name: str, written: bool = True) -> None:
        hit = self._overlap(s, e)
        if hit is not None:
            raise BuilderError(
                f"region {name!r} [{s:#x}, {e:#x}) overlaps live region "
                f"{hit[2]!r} [{hit[0]:#x}, {hit[1]:#x})")
        self._reserved.append((s, e, name, written))

    def region(self, size: int, *, at: Optional[int] = None,
               align: Optional[int] = None, name: str = "") -> Region:
        """Reserve a ``size``-word region; auto-placed unless ``at`` given."""
        if size <= 0:
            raise BuilderError(f"region size must be positive, got {size}")
        if at is not None:
            self._reserve(at, at + size, name or f"r@{at:#x}")
            return Region(at, size, name, self)
        align = self._align if align is None else align
        addr = -(-self._alloc_ptr // align) * align
        while True:
            hit = self._overlap(addr, addr + size)
            if hit is None:
                break
            addr = -(-hit[1] // align) * align
        self._reserve(addr, addr + size, name or f"r{len(self._reserved)}")
        self._alloc_ptr = addr + size
        return Region(addr, size, name, self)

    def input(self, addr: int, size: int, name: str = "") -> Region:
        """Name an externally-provided input span (reserved like any region;
        interleaved programs may share an identical input span)."""
        self._reserve(addr, addr + size, name or f"in@{addr:#x}",
                      written=False)
        return Region(addr, size, name, self)

    # ------------------------------------------------------------ registers
    def reg(self, name: str = "") -> Reg:
        return Reg(name)

    def _scratch_reg(self) -> Reg:
        if self._scratch is None:
            self._scratch = Reg("scratch")
        return self._scratch

    # -------------------------------------------------------------- low-level
    def _emit(self, node) -> None:
        self._blocks[-1].append(node)

    def mov(self, dst: Reg, src: Union[int, Reg]) -> Reg:
        """``dst = src`` (immediate or register copy)."""
        if isinstance(src, Reg):
            self._emit(_Op(isa.OP_MOV, a=src, b=dst))
        else:
            self._emit(_Op(isa.OP_MOV, a=int(src), b=dst, ctl=isa.CTL_IMM))
        return dst

    def add(self, dst: Reg, x: Reg, y: Reg) -> Reg:
        """``dst = x + y`` (register-register)."""
        self._emit(_Op(isa.OP_ADD, a=x, asz=y, b=dst))
        return dst

    def mul(self, dst: Reg, x: Reg, y: Reg) -> Reg:
        self._emit(_Op(isa.OP_MUL, a=x, asz=y, b=dst))
        return dst

    def let(self, value: int, name: str = "") -> Reg:
        """Allocate a register and load an immediate into it."""
        return self.mov(Reg(name or f"#{value:#x}"), value)

    def nop(self) -> None:
        self._emit(_Op(isa.OP_NOP))

    # ----------------------------------------------------------------- tasks
    def _in_operand(self, x, size) -> tuple[object, int, int]:
        """→ (a_field, asz, ctl_bits) for a task input."""
        if isinstance(x, TaskHandle):
            if x.out is None:
                raise BuilderError(
                    f"task {x.func!r} has an indirect output; pass the "
                    "region or register explicitly")
            x = x.out
        if isinstance(x, Region):
            return x.addr, int(size if size is not None else x.size), 0
        if isinstance(x, Walker):
            x = x.base
        if isinstance(x, Reg):
            if size is None:
                raise BuilderError(
                    "indirect (register) operands need an explicit size")
            return x, int(size), isa.CTL_IN_INDIRECT
        raise BuilderError(f"bad task input operand: {x!r}")

    def _out_operand(self, x, size) -> tuple[object, int, int, Optional[Region]]:
        if isinstance(x, int):
            x = self.region(x)
        if isinstance(x, Region):
            return x.addr, int(size if size is not None else x.size), 0, x
        if isinstance(x, Walker):
            x = x.base
        if isinstance(x, Reg):
            if size is None:
                raise BuilderError(
                    "indirect (register) outputs need an explicit size")
            return x, int(size), isa.CTL_OUT_INDIRECT, None
        raise BuilderError(f"bad task output operand: {x!r}")

    def task(self, func: str, *, in_, out, in_size: Optional[int] = None,
             out_size: Optional[int] = None, tid: int = 0,
             pid: Optional[int] = None, meta: int = 0) -> TaskHandle:
        """Emit a task call on accelerator ``func``.

        ``in_``/``out`` accept a :class:`Region`, a :class:`TaskHandle`
        (its output region — dataflow chaining), a :class:`Reg`/:class:`Walker`
        (indirect addressing, ``in_size``/``out_size`` then required), or for
        ``out`` an ``int`` size to auto-allocate a fresh region.
        """
        if func not in self.keynames:
            raise BuilderError(f"unknown accelerator keyname {func!r} "
                               f"(known: {sorted(self.keynames)})")
        a, asz, ctl_in = self._in_operand(in_, in_size)
        b, bsz, ctl_out, out_region = self._out_operand(out, out_size)
        self._emit(_Op(isa.OP_TASK, acc=self.keynames[func], a=a, asz=asz,
                       b=b, bsz=bsz, tid=tid & 0xF,
                       pid=(self._pids[-1] if pid is None else pid) & 0xF,
                       ctl=ctl_in | ctl_out, meta=meta))
        if not self._in_loop_or_branch:
            self._n_tasks += 1
        return TaskHandle(len(self._blocks[-1]) - 1, func, out_region)

    # ------------------------------------------------------- structured flow
    @contextmanager
    def loop(self, count: Union[int, Reg], counter: Optional[Reg] = None
             ) -> Iterator[Reg]:
        """``with p.loop(n):`` — body repeats ``n`` times (lbeg/lend)."""
        counter = counter or Reg("loopctr")
        body: list = []
        self._blocks.append(body)
        self._in_loop_or_branch += 1
        try:
            yield counter
        finally:
            self._in_loop_or_branch -= 1
            self._blocks.pop()
            self._emit(_Loop(count, counter, body))

    def walker(self, *, stride: int, start: Optional[int] = None,
               count: Optional[int] = None, name: str = "walker") -> Walker:
        """A walking output pointer.  Auto-reserves ``count * stride`` words
        when ``start`` is omitted; an explicit ``start`` reserves nothing
        (e.g. both arms of a branch walking the same shared span)."""
        if start is None:
            if count is None:
                raise BuilderError("walker needs either start= or count=")
            start = self.region(count * stride, name=name).addr
        return Walker(self, start, stride, name)

    def branch(self, *, on: Union[Region, Reg], cond: str,
               thr: Union[int, Reg], kind: str = "mem") -> "BranchCtx":
        """Emit an ``if`` (paper §IV-C3).  ``kind``: ``"reg"`` (RR, inline),
        ``"mem"`` (MR, spawned memory read), ``"bus"`` (BR, waits on the CDB
        broadcast of the in-flight producer of ``on``).  The fall-through
        block (``.not_taken()``) is the speculated path."""
        if cond not in _CONDS:
            raise BuilderError(f"bad condition {cond!r}; one of {list(_CONDS)}")
        if kind not in _KINDS:
            raise BuilderError(f"bad branch kind {kind!r}; one of {list(_KINDS)}")
        k = _KINDS[kind]
        if isinstance(on, Region):
            if k == isa.BR_RR:
                raise BuilderError('kind="reg" branches test a Reg, not a Region')
            addr: object = on.addr
        elif isinstance(on, Reg):
            if k != isa.BR_RR:
                raise BuilderError(f'kind={kind!r} branches test a Region')
            addr = on
        else:
            raise BuilderError(f"bad branch operand: {on!r}")
        if not isinstance(thr, Reg):
            thr = self.let(int(thr), "thr")
        node = _Branch(kind=k, cond=_CONDS[cond], on=addr, thr=thr,
                       taken=[], not_taken=[])
        self._emit(node)
        return BranchCtx(self, node)

    @contextmanager
    def process(self, pid: int) -> Iterator[None]:
        """Tag tasks emitted inside with process id ``pid`` (multi-app)."""
        self._pids.append(pid & 0xF)
        try:
            yield
        finally:
            self._pids.pop()

    # -------------------------------------------------------------- lowering
    def _resolve_regs(self, flat_ops: list[_Op]) -> dict[Reg, int]:
        """Number symbolic registers 1..num_regs-1 in first-use order."""
        mapping: dict[Reg, int] = {}
        ids = itertools.count(1)
        for op in flat_ops:
            for field in (op.a, op.asz, op.b):
                if isinstance(field, Reg) and field not in mapping:
                    mapping[field] = next(ids)
        if mapping and max(mapping.values()) >= self.num_regs:
            raise BuilderError(
                f"program uses {len(mapping)} registers; only "
                f"{self.num_regs - 1} available")
        return mapping

    def _flatten(self, nodes: list, out: list[_Op]) -> None:
        for node in nodes:
            if isinstance(node, _Op):
                out.append(node)
            elif isinstance(node, _Loop):
                if isinstance(node.count, Reg):
                    out.append(_Op(isa.OP_LBEG, a=node.count,
                                   asz=node.counter, ctl=1))
                else:
                    out.append(_Op(isa.OP_LBEG, a=int(node.count),
                                   asz=node.counter))
                start = len(out)
                self._flatten(node.body, out)
                out.append(_Op(isa.OP_LEND, asz=node.counter,
                               b=len(out) - start))
            elif isinstance(node, _Branch):
                if_op = _Op(isa.OP_IF, a=node.on, asz=node.thr,
                            ctl=node.kind | (node.cond << 2))
                out.append(if_op)
                if_pc = len(out) - 1
                self._flatten(node.not_taken, out)
                if node.taken:
                    jump_op = _Op(isa.OP_JUMP)
                    out.append(jump_op)
                    if_op.b = len(out) - if_pc
                    self._flatten(node.taken, out)
                    jump_op.a = len(out)
                else:
                    if_op.b = len(out) - if_pc
            else:  # pragma: no cover - defensive
                raise BuilderError(f"unknown node {node!r}")

    def build(self) -> "BuiltProgram":
        if len(self._blocks) != 1:
            raise BuilderError("build() inside an open loop/branch/process "
                               "context")
        flat: list[_Op] = []
        self._flatten(self._nodes, flat)
        regmap = self._resolve_regs(flat)

        def rr(x):
            return regmap[x] if isinstance(x, Reg) else int(x)

        instrs = [isa.Instr(op=o.op, acc=o.acc, a=rr(o.a), asz=rr(o.asz),
                            b=rr(o.b), bsz=o.bsz, tid=o.tid, pid=o.pid,
                            ctl=o.ctl, meta=o.meta) for o in flat]
        return BuiltProgram(
            name=self.name,
            instrs=tuple(instrs),
            code=isa.encode_program(instrs),
            mem_init=dict(self.mem_init),
            effects=dict(self.effects),
            keynames=dict(self.keynames),
            n_tasks_hint=self._n_tasks if self._n_tasks == sum(
                1 for i in instrs if i.op == isa.OP_TASK) else 0,
            policy=self.policy,
        )

    # --------------------------------------------------------------- merge
    @classmethod
    def merge(cls, programs: Sequence["Program"], name: str = "shared", *,
              require_distinct_pids: bool = False,
              priorities: Optional[dict[int, int]] = None,
              quotas: Optional[dict[int, int]] = None,
              rs_caps: Optional[dict[int, int]] = None,
              frontends: bool = False,
              arrivals: Optional[Sequence[int]] = None,
              fe_mode: Optional[str] = None):
        """N-way graph-level round-robin merge: N CPUs pushing their task
        streams into the one Task Queue (pids mark the owners) — the paper's
        multi-application sharing scenario, for any tenant count.

        With ``frontends=True`` the tenants' instruction streams stay
        **separate** — the paper's actual system model, N CPUs each pushing
        independently — and the result is a
        :class:`~repro_torch.core.hts.frontend.MultiProgram`: one code image with
        a per-tenant dispatch stream each (own program counter, decode
        window and optional ``arrivals`` offset), arbitrated per cycle into
        the shared reservation station (see ``frontend.py``).  ``fe_mode``
        ("rr"/"weighted") selects that arbitration on the attached policy.
        ``arrivals``/``fe_mode`` are only meaningful with
        ``frontends=True``.

        ``priorities`` (``{pid: weight}``), ``quotas`` (``{pid: max
        in-flight units per accelerator class}``) and ``rs_caps`` (``{pid:
        max reservation-station entries}`` — RS admission control) attach a
        :class:`~repro_torch.core.hts.policy.SchedPolicy` to the merged program;
        ``hts.run``/``hts.compare`` apply it by default, so a merge-time QoS
        decision follows the program everywhere.  When omitted, the source
        programs' own policies are unioned (conflicting entries for a pid
        are a :class:`BuilderError`).

        Structured nodes (a whole loop or branch) interleave atomically, so
        labels/offsets can never be torn apart — unlike merging assembly
        text line-by-line.  Three per-process isolation properties are
        checked up front:

        * **memory regions** — every pair of written regions must be
          disjoint; only *identical read-only input spans* (``Program.input``)
          may be shared between tenants;
        * **register spaces** — registers are symbolic until ``build()``, so
          they cannot clobber each other; a :class:`Reg` object appearing in
          two source programs (a truly shared register) is rejected, and the
          combined register demand is checked against the GPR bank here
          instead of failing late at ``build()``;
        * **process ids** — with ``require_distinct_pids=True``, two tenants
          emitting tasks under the same pid is an error (multi-tenant
          accounting would silently merge their schedules).
        """
        if frontends:
            from .frontend import build_frontends
            return build_frontends(
                programs, name, arrivals=arrivals,
                require_distinct_pids=require_distinct_pids,
                priorities=priorities, quotas=quotas, rs_caps=rs_caps,
                fe_mode=fe_mode)
        if arrivals is not None or fe_mode is not None:
            raise BuilderError("arrivals=/fe_mode= require frontends=True "
                               "(a merged single stream has no per-tenant "
                               "frontends)")
        programs = list(programs)
        if not programs:
            raise BuilderError("merge needs at least one program")
        keynames: dict[str, int] = {}
        for p in programs:
            keynames.update(p.keynames)
        merged = cls(name, keynames=keynames,
                     num_regs=max(p.num_regs for p in programs))

        # --- region isolation (identical read-only inputs may be shared)
        for p in programs:
            for (s, e, rn, wr) in p._reserved:
                hit = merged._overlap(s, e)
                shared_input = (hit is not None and not wr and not hit[3]
                                and (hit[0], hit[1]) == (s, e))
                if hit is not None and not shared_input:
                    raise BuilderError(
                        f"merge: region {rn!r} [{s:#x}, {e:#x}) of program "
                        f"{p.name!r} overlaps {hit[2]!r} "
                        f"[{hit[0]:#x}, {hit[1]:#x}) of another tenant")
                if hit is None:
                    merged._reserved.append((s, e, rn, wr))

        # --- register isolation: no Reg object may span two tenants, and
        # the union must fit the GPR bank (fail here, not at build())
        seen: dict = {}
        total_regs = 0
        for p in programs:
            regs = _collect_regs(p._nodes)
            for r in regs:
                if r in seen and seen[r] is not p:
                    raise BuilderError(
                        f"merge: register {r!r} is used by both "
                        f"{seen[r].name!r} and {p.name!r} — tenants must "
                        "own disjoint register sets")
                seen[r] = p
            total_regs += len(regs)
        if total_regs >= merged.num_regs:
            raise BuilderError(
                f"merge: tenants need {total_regs} registers combined; only "
                f"{merged.num_regs - 1} available")

        # --- pid isolation (optional: multi-tenant accounting)
        if require_distinct_pids:
            owner: dict[int, "Program"] = {}
            for p in programs:
                for pid in _collect_pids(p._nodes):
                    if pid in owner and owner[pid] is not p:
                        raise BuilderError(
                            f"merge: pid {pid} is used by both "
                            f"{owner[pid].name!r} and {p.name!r}")
                    owner[pid] = p

        # --- round-robin splice of top-level nodes (structured nodes atomic)
        streams = [p._nodes for p in programs]
        for i in range(max(len(s) for s in streams)):
            for s in streams:
                if i < len(s):
                    merged._nodes.append(s[i])
        # image union: regions are disjoint except identical shared inputs,
        # so a key conflict means two tenants seeded the shared span with
        # different data — reject instead of silent last-writer-wins
        for p in programs:
            for which in ("mem_init", "effects"):
                dst = getattr(merged, which)
                for k, v in getattr(p, which).items():
                    if k in dst and dst[k] != v:
                        raise BuilderError(
                            f"merge: conflicting {which} values at address "
                            f"{k:#x} ({dst[k]} vs {v}, program {p.name!r}) "
                            "— tenants sharing an input span must agree on "
                            "its contents")
                    dst[k] = v
        merged._n_tasks = sum(p._n_tasks for p in programs)
        merged._scratch = None   # distinct Reg objects per source program

        # --- scheduling policy: explicit args win; else union the tenants'
        if priorities is not None or quotas is not None or rs_caps is not None:
            merged.policy = SchedPolicy.of(weights=priorities, quotas=quotas,
                                           rs_caps=rs_caps)
        else:
            pol: Optional[SchedPolicy] = None
            for p in programs:
                if p.policy is None:
                    continue
                try:
                    pol = p.policy if pol is None else pol.merge_with(p.policy)
                except ValueError as e:
                    raise BuilderError(f"merge: {e} (program {p.name!r})")
            merged.policy = pol
        return merged

    def interleave(self, other: "Program", name: str = "shared") -> "Program":
        """Two-way :meth:`merge` (kept for the original pairwise API)."""
        return Program.merge([self, other], name)


class BranchCtx:
    """Handle returned by :meth:`Program.branch`; records the two arms."""

    def __init__(self, prog: Program, node: _Branch):
        self._prog = prog
        self._node = node

    @contextmanager
    def _arm(self, block: list) -> Iterator[None]:
        self._prog._blocks.append(block)
        self._prog._in_loop_or_branch += 1
        try:
            yield
        finally:
            self._prog._in_loop_or_branch -= 1
            self._prog._blocks.pop()

    def taken(self):
        """The branch-taken arm (jumped to; *not* speculated)."""
        return self._arm(self._node.taken)

    def not_taken(self):
        """The fall-through arm — the path HTS speculates down (§IV-C3)."""
        return self._arm(self._node.not_taken)


@dataclasses.dataclass(frozen=True)
class BuiltProgram:
    """Immutable lowering result: machine code + images + asm text."""
    name: str
    instrs: tuple
    code: np.ndarray
    mem_init: dict[int, int]
    effects: dict[int, int]
    keynames: dict[str, int]
    n_tasks_hint: int = 0
    policy: Optional[SchedPolicy] = None    # scheduling policy (hts.run default)

    @property
    def asm(self) -> str:
        """Paper-style assembly text; reassembles to exactly ``self.code``."""
        names = {v: k for k, v in self.keynames.items()}
        return isa.disassemble(self.code, names)

    def __len__(self) -> int:
        return len(self.instrs)
