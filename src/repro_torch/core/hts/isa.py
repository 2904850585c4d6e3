"""Instruction Set Architecture of the Hardware Task Scheduler (paper §V, Table I).

Instructions are 128 bits wide. Field breakdown (Table I of the paper):

    [7:0]     accelerator id            (``acc``)
    [23:8]    input memory region       (``a``)
    [31:24]   input memory size         (``asz``)
    [47:32]   output memory region      (``b``)
    [55:48]   output memory size        (``bsz``)
    [59:56]   task id                   (``tid``)
    [63:60]   process id                (``pid``)
    [67:64]   control                   (``ctl``)
    [127:68]  metadata (accelerator)    (``meta`` — we keep the low 32 bits)

Accelerator ids below ``CTRL_BASE`` (0xF0) name *task* instructions (the function
accelerator to run).  Ids at/above ``CTRL_BASE`` encode the control instructions of
Figure 6 (``add``/``mul``/``mov``/``jump``/``if``/``lbeg``/``lend``).

Operand conventions (the paper's examples fix most of these; where the text is
ambiguous our choice is documented in DESIGN.md §3):

``task``   in-region = [a, a+asz), out-region = [b, b+bsz).
           ctl bit0: input region is *indirect* — taken from register R[a]
           ctl bit1: output region is indirect — taken from register R[b]
``add``    R[b] = R[a] + R[asz]
``mul``    R[b] = R[a] * R[asz]
``mov``    ctl bit0 ? R[b] = a (immediate) : R[b] = R[a]
``jump``   PC = a (absolute index into the dataflow program)
``if``     branch.  ctl bits [1:0]: 0 = RR, 1 = MR, 2 = BR   (paper §IV-C3)
           ctl bits [3:2]: condition 0 = EQ, 1 = NEQ, 2 = GE, 3 = LE
           value source: RR → R[a]; MR → mem[a]; BR → mem[a] once the in-flight
           producer of region ``a`` completes.  Compared against R[asz].
           Taken → PC += b (forward jump by ``b``), else fall through.
``lbeg``   R[asz] = (ctl bit0 ? R[a] : a)   — loop counter into register R[asz]
``lend``   R[asz] -= 1 ; if R[asz] > 0: PC -= b  (jump back over the loop body)
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

# ---------------------------------------------------------------------------
# Opcodes
# ---------------------------------------------------------------------------
CTRL_BASE = 0xF0

OP_TASK = 0
OP_ADD = 1
OP_MUL = 2
OP_MOV = 3
OP_JUMP = 4
OP_IF = 5
OP_LBEG = 6
OP_LEND = 7
OP_NOP = 8

_CTRL_OPS = {
    0xF1: OP_ADD,
    0xF2: OP_MUL,
    0xF3: OP_MOV,
    0xF4: OP_JUMP,
    0xF5: OP_IF,
    0xF6: OP_LBEG,
    0xF7: OP_LEND,
    0xF0: OP_NOP,
}
_CTRL_ACC = {v: k for k, v in _CTRL_OPS.items()}

OP_NAMES = {
    OP_TASK: "task", OP_ADD: "add", OP_MUL: "mul", OP_MOV: "mov",
    OP_JUMP: "jump", OP_IF: "if", OP_LBEG: "lbeg", OP_LEND: "lend",
    OP_NOP: "nop",
}

# Branch kinds (paper §IV-C3)
BR_RR = 0   # register-read: resolved inline, 1-cycle bubble, never speculated
BR_MR = 1   # memory-read: resolved by a spawned memory-read, speculated
BR_BR = 2   # bus-read: resolved by a pending task's CDB broadcast, speculated

# Branch conditions
CND_EQ, CND_NEQ, CND_GE, CND_LE = 0, 1, 2, 3

# Control-field bits for task instructions
CTL_IN_INDIRECT = 1   # input region index comes from a register
CTL_OUT_INDIRECT = 2  # output region index comes from a register
CTL_IMM = 1           # for mov/lbeg: operand ``a`` is an immediate


@dataclasses.dataclass(frozen=True)
class Instr:
    """One decoded 128-bit HTS instruction."""
    op: int
    acc: int = 0      # accelerator/function id for OP_TASK
    a: int = 0        # input memory region / src1 reg / immediate
    asz: int = 0      # input size / src2 reg / loop reg / threshold reg
    b: int = 0        # output memory region / dst reg / branch offset
    bsz: int = 0      # output size
    tid: int = 0      # task id (4 bits, program-level tag)
    pid: int = 0      # process id
    ctl: int = 0      # control nibble
    meta: int = 0     # accelerator metadata (low 32 bits retained)

    def __str__(self) -> str:
        """One assembler-compatible source line (see :func:`format_instr`)."""
        return format_instr(self)

    def encode(self) -> np.ndarray:
        """Pack into 4 little-endian uint32 lanes (128 bits)."""
        acc = self.acc if self.op == OP_TASK else _CTRL_ACC[self.op]
        w = int(acc) & 0xFF
        w |= (int(self.a) & 0xFFFF) << 8
        w |= (int(self.asz) & 0xFF) << 24
        w1 = int(self.b) & 0xFFFF
        w1 |= (int(self.bsz) & 0xFF) << 16
        w1 |= (int(self.tid) & 0xF) << 24
        w1 |= (int(self.pid) & 0xF) << 28
        w2 = int(self.ctl) & 0xF
        w2 |= (int(self.meta) & 0x0FFFFFFF) << 4
        w3 = (int(self.meta) >> 28) & 0xFFFFFFFF
        return np.array([w, w1, w2, w3], dtype=np.uint32)


def decode_word(words: Sequence[int]) -> Instr:
    """Inverse of :meth:`Instr.encode`."""
    w0, w1, w2, w3 = (int(w) for w in words)
    acc = w0 & 0xFF
    op = _CTRL_OPS.get(acc, OP_TASK)
    return Instr(
        op=op,
        acc=acc if op == OP_TASK else 0,
        a=(w0 >> 8) & 0xFFFF,
        asz=(w0 >> 24) & 0xFF,
        b=w1 & 0xFFFF,
        bsz=(w1 >> 16) & 0xFF,
        tid=(w1 >> 24) & 0xF,
        pid=(w1 >> 28) & 0xF,
        ctl=w2 & 0xF,
        meta=((w2 >> 4) & 0x0FFFFFFF) | ((w3 & 0xFFFFFFFF) << 28),
    )


def encode_program(instrs: Sequence[Instr]) -> np.ndarray:
    """Program → (P, 4) uint32 machine-code array."""
    if not instrs:
        return np.zeros((0, 4), dtype=np.uint32)
    return np.stack([i.encode() for i in instrs])


def decode_program(code: np.ndarray) -> list[Instr]:
    return [decode_word(row) for row in np.asarray(code)]


def format_instr(ins: Instr, names: dict[int, str] | None = None) -> str:
    """Disassemble one instruction to an assembler-compatible source line.

    ``names`` maps accelerator id → keyname; defaults to the Table-II DSP
    function set.  Unknown accelerator ids render as ``acc_<hex>`` (which
    does *not* reassemble — pass the right ``names`` for round-trips).
    """
    if names is None:
        from .costs import FUNC_NAMES
        names = FUNC_NAMES
    mnem = (names.get(ins.acc, f"acc_{ins.acc:x}") if ins.op == OP_TASK
            else OP_NAMES[ins.op])
    return (f"{mnem} {ins.a:x} {ins.asz:x} {ins.b:x} {ins.bsz:x} "
            f"{ins.tid:x} {ins.pid:x} {ins.ctl:x} {ins.meta:04x}")


def disassemble(code: np.ndarray, names: dict[int, str] | None = None) -> str:
    """Machine code → assembly text, one line per instruction.

    Inverse of ``assembler.assemble`` (for label-free numeric form):
    ``assemble(disassemble(code))`` is the identity, property-tested in
    tests/test_hts_builder.py.
    """
    return "\n".join(format_instr(i, names) for i in decode_program(code))


#: Column layout of the pre-decoded field table used by both simulators.
FIELDS = ("op", "acc", "a", "asz", "b", "bsz", "tid", "pid", "ctl", "meta")


def decode_table(code: np.ndarray) -> np.ndarray:
    """Pre-decode machine code into a dense (P, len(FIELDS)) int32 table.

    This is the "Task Decode" stage of the HTS pipeline (paper Fig. 5) —
    performed once up front because the program is static.
    """
    instrs = decode_program(code)
    tbl = np.zeros((len(instrs), len(FIELDS)), dtype=np.int32)
    for i, ins in enumerate(instrs):
        tbl[i] = [ins.op, ins.acc, ins.a, ins.asz, ins.b, ins.bsz,
                  ins.tid, ins.pid, ins.ctl, ins.meta & 0x7FFFFFFF]
    return tbl
