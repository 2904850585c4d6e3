"""Cost model constants: Table II accelerator cycles + scheduler cost models.

Table II of the paper enumerates the DSP Functions modeled as accelerators and
their calibrated cycle counts (benchmarked on a DSP by Lennartsson et al. [28]).

The Naive / Runtime(software) / HTS scheduling cost models follow §VI-C:

* Naive           — CPU schedules one task at a time, in-order; each task pays its
                    execution cycles plus one interrupt latency.
* Runtime (SW)    — the HTS design "manifested in software": out-of-order, but every
                    scheduling structure access is a memory access (assumed L2 hit)
                    and completions arrive via interrupts.
* HTS             — hardware scheduler: single-cycle dispatch, completion via a
                    physical signal on the CDB (no interrupt), optional speculation.

The paper cites ARM Cortex-A interrupt latency [29] and Cortex-A9 L2 hit
latency [30] without printing the numbers; we use 400 cycles and 20 cycles
respectively (worst-case order-of-magnitude from those sources) and treat the
number of scheduler-structure accesses per task (6: tracker lookup + insert, RS
alloc + wakeup, ASR check, CDB arbitration) as the software-overhead multiplier.
EXPERIMENTS.md §Paper-claims records the reproduced speedups under these
constants.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Table II — DSP Functions modeled as accelerators
# ---------------------------------------------------------------------------
#: function keyname -> (accelerator id, input dataframe size, execution cycles)
FUNCTIONS: dict[str, tuple[int, int, int]] = {
    "real_fir":     (0, 40, 921),
    "complex_fir":  (1, 40, 3696),
    "adaptive_fir": (2, 40, 4384),
    "iir":          (3, 40, 2450),
    "vector_dot":   (4, 40, 53),
    "vector_add":   (5, 40, 131),
    "vector_max":   (6, 40, 55),
    "fft_256":      (7, 256, 18673),
    "dct":          (8, 64, 874),
    "correlation":  (9, 40, 753),
}

NUM_FUNCS = len(FUNCTIONS)
FUNC_IDS = {name: fid for name, (fid, _, _) in FUNCTIONS.items()}
FUNC_NAMES = {fid: name for name, (fid, _, _) in FUNCTIONS.items()}
FUNC_CYCLES = [0] * NUM_FUNCS
FUNC_FRAME = [0] * NUM_FUNCS
for _name, (_fid, _frame, _cyc) in FUNCTIONS.items():
    FUNC_CYCLES[_fid] = _cyc
    FUNC_FRAME[_fid] = _frame

# Pseudo function used to model an MR branch's spawned memory read (§IV-C3:
# "requires spawning a new task to read memory which can potentially take a
# large number of cycles").  DRAM-read order of magnitude.
MEM_READ_CYCLES = 200

# Cited latencies (see module docstring).
INTERRUPT_LATENCY = 400      # ARM Cortex-A interrupt round-trip, cycles [29]
L2_HIT_LATENCY = 20          # ARM Cortex-A9 L2 hit, cycles [30]
SW_ACCESSES_PER_TASK = 6     # scheduler-structure touches per task in software


@dataclasses.dataclass(frozen=True)
class SchedulerCosts:
    """Per-scheduler cost parameters (one instance per §VI-C algorithm)."""
    name: str
    in_order: bool                 # naive: single outstanding task, program order
    dispatch_serial_cost: int      # extra frontend cycles consumed per *task* dispatch
    completion_extra: int          # latency between task finish and dep-clear broadcast
    speculation: bool              # speculate MR/BR branches (HTS w/ spec only)
    issue_width: int = 4           # RS → accelerator issues per cycle ("superscalar")
    cdb_width: int = 1             # completion broadcasts per cycle (ticket arbiter)


def naive_costs() -> SchedulerCosts:
    return SchedulerCosts(
        name="naive", in_order=True, dispatch_serial_cost=1,
        completion_extra=INTERRUPT_LATENCY, speculation=False, issue_width=1)


def software_costs() -> SchedulerCosts:
    return SchedulerCosts(
        name="software", in_order=False,
        dispatch_serial_cost=L2_HIT_LATENCY * SW_ACCESSES_PER_TASK,
        completion_extra=INTERRUPT_LATENCY, speculation=False)


def hts_costs(speculation: bool = True) -> SchedulerCosts:
    return SchedulerCosts(
        name="hts_spec" if speculation else "hts_nospec", in_order=False,
        dispatch_serial_cost=1, completion_extra=0, speculation=speculation)


ALL_SCHEDULERS = ("naive", "software", "hts_nospec", "hts_spec")


# ---------------------------------------------------------------------------
# Heterogeneous FU cost tables
# ---------------------------------------------------------------------------
#: canonical per-class width of a packed cost table — matches the widest
#: ``max_fu_per_class`` any machine variant uses; narrower machines slice,
#: and unit indices ≥ ``n_fu[c]`` are never granted so the padding is inert.
FU_COST_WIDTH = 16
#: cost multipliers live in [1, FU_COST_CAP]: a unit's execution latency is
#: ``FUNC_CYCLES[c] * fu_cost[c, u]``.  The cap keeps the machine's combined
#: free-unit ranking key and the cycle counter comfortably inside int32.
FU_COST_CAP = 1 << 10


def norm_fu_cost(fu_cost, width: int = FU_COST_WIDTH) -> np.ndarray:
    """Normalize a cost-table spec to a ``(NUM_FUNCS, width)`` int32 array.

    Accepts ``None`` (all ones — every unit identical, the paper's machine),
    a ``{class_id_or_keyname: row_or_scalar}`` mapping (unlisted classes stay
    uniform), or a full array-like of per-class rows.  Rows shorter than
    ``width`` are padded with 1 (extra units are vanilla); a scalar row means
    "every unit of that class costs this much".
    """
    out = np.ones((NUM_FUNCS, width), np.int32)
    if fu_cost is None:
        return out
    if isinstance(fu_cost, Mapping):
        items = []
        for key, row in fu_cost.items():
            fid = FUNC_IDS[key] if isinstance(key, str) else int(key)
            if not 0 <= fid < NUM_FUNCS:
                raise ValueError(f"unknown function class {key!r}")
            items.append((fid, row))
    else:
        rows = list(fu_cost)
        if len(rows) != NUM_FUNCS:
            raise ValueError(f"fu_cost must have {NUM_FUNCS} per-class rows, "
                             f"got {len(rows)}")
        items = list(enumerate(rows))
    for fid, row in items:
        vals = [int(row)] * width if np.ndim(row) == 0 else \
            [int(v) for v in row]
        if len(vals) > width:
            vals = vals[:width]
        for u, v in enumerate(vals):
            if not 1 <= v <= FU_COST_CAP:
                raise ValueError(f"fu_cost[{fid}][{u}] must be in "
                                 f"[1, {FU_COST_CAP}], got {v}")
            out[fid, u] = v
    return out


def fu_cost_tuple(fu_cost) -> Optional[tuple]:
    """Hashable tuple-of-rows form for ``HtsParams.fu_cost`` (None if the
    table is uniformly 1, so a vanilla machine keeps a vanilla params key)."""
    if fu_cost is None:
        return None
    arr = norm_fu_cost(fu_cost)
    if (arr == 1).all():
        return None
    return tuple(tuple(int(v) for v in row) for row in arr)


def costs_by_name(name: str) -> SchedulerCosts:
    return {
        "naive": naive_costs(),
        "software": software_costs(),
        "hts_nospec": hts_costs(False),
        "hts_spec": hts_costs(True),
    }[name]
