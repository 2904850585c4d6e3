"""Assembler for the HTS dataflow-graph assembly language (paper §V-B).

Programs are described exactly as in the paper: one instruction per line, the
mnemonic is either a control instruction (``add``/``mul``/``mov``/``jump``/
``if``/``lbeg``/``lend``) or an accelerator *keyname* (e.g. ``fft_256``) which
the assembler resolves to an accelerator id at "compile" time.  The eight
operand fields are hexadecimal, in Table-I order::

    <mnemonic> <in_region> <in_size> <out_region> <out_size> <tid> <pid> <ctl> <meta>

e.g. (from the paper)::

    real_fir 10 2 13 2 0 0 0 0000
    if 93 a 12 0 1 0 d 0000

Extensions kept deliberately small (documented, not paper-visible):
  * ``#`` / ``;`` comments and blank lines;
  * trailing fields may be omitted (default 0);
  * ``@label`` definitions and ``jump @label`` / ``if ... @label`` targets,
    which the assembler lowers to the numeric PC/offset form above.
"""
from __future__ import annotations

import numpy as np

from . import isa
from .costs import FUNC_IDS

_CTRL_MNEMONICS = {
    "add": isa.OP_ADD, "mul": isa.OP_MUL, "mov": isa.OP_MOV,
    "jump": isa.OP_JUMP, "if": isa.OP_IF, "lbeg": isa.OP_LBEG,
    "lend": isa.OP_LEND, "nop": isa.OP_NOP,
}


class AsmError(ValueError):
    pass


def _strip(line: str) -> str:
    for marker in ("#", ";"):
        if marker in line:
            line = line[: line.index(marker)]
    return line.strip()


def assemble(text: str, keynames: dict[str, int] | None = None) -> np.ndarray:
    """Assemble ``text`` to a (P, 4) uint32 machine-code array.

    ``keynames`` maps accelerator keynames → accelerator ids; defaults to the
    Table-II DSP function set.
    """
    keynames = dict(FUNC_IDS if keynames is None else keynames)

    # Pass 1: collect labels and raw instruction tuples.
    raw: list[tuple[str, list[str], int]] = []   # (mnemonic, operands, line_no)
    labels: dict[str, int] = {}
    for ln, line in enumerate(text.splitlines(), start=1):
        line = _strip(line)
        if not line:
            continue
        if line.startswith("@"):
            label = line[1:].rstrip(":")
            if label in labels:
                raise AsmError(f"line {ln}: duplicate label @{label}")
            labels[label] = len(raw)
            continue
        parts = line.split()
        raw.append((parts[0], parts[1:], ln))

    # Pass 2: encode.
    instrs: list[isa.Instr] = []
    for pc, (mnem, ops, ln) in enumerate(raw):
        fields = [0] * 8  # a asz b bsz tid pid ctl meta
        label_slot = None
        for i, tok in enumerate(ops):
            if tok.startswith("@"):
                label = tok[1:]
                if label not in labels:
                    raise AsmError(f"line {ln}: unknown label @{label}")
                target = labels[label]
                # ``jump`` takes an absolute PC in field a; ``if`` takes a
                # forward offset in field b (paper: "PC jump by 18 if taken").
                if mnem == "jump":
                    fields[0] = target
                elif mnem == "if":
                    off = target - pc
                    if off < 0:
                        raise AsmError(f"line {ln}: if targets must be forward")
                    fields[2] = off
                else:
                    raise AsmError(f"line {ln}: labels only valid on jump/if")
                label_slot = i
                continue
            try:
                fields[i] = int(tok, 16)
            except ValueError as e:
                raise AsmError(f"line {ln}: bad hex operand {tok!r}") from e
        del label_slot

        a, asz, b, bsz, tid, pid, ctl, meta = fields
        if mnem in _CTRL_MNEMONICS:
            op = _CTRL_MNEMONICS[mnem]
            instrs.append(isa.Instr(op=op, a=a, asz=asz, b=b, bsz=bsz,
                                    tid=tid, pid=pid, ctl=ctl, meta=meta))
        else:
            if mnem not in keynames:
                raise AsmError(f"line {ln}: unknown accelerator keyname {mnem!r}")
            instrs.append(isa.Instr(op=isa.OP_TASK, acc=keynames[mnem], a=a,
                                    asz=asz, b=b, bsz=bsz, tid=tid, pid=pid,
                                    ctl=ctl, meta=meta))
    return isa.encode_program(instrs)


def disassemble(code: np.ndarray, keynames: dict[str, int] | None = None) -> str:
    """Machine code → assembly text (delegates to :func:`isa.disassemble`)."""
    keynames = dict(FUNC_IDS if keynames is None else keynames)
    return isa.disassemble(code, {v: k for k, v in keynames.items()})
