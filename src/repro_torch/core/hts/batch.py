"""Population packing: N scenarios as one lane axis.

The population machine (:mod:`machine`) takes *everything* as runtime inputs —
program table, program length, memory images, FU counts, policy tables — so
a **population of scenarios** is one leading lane axis of every argument.
What stands between "a list of programs" and one population call is shape
bookkeeping, and that lives here:

* :func:`prepare` normalises any program-ish object (``Program`` /
  ``BuiltProgram`` / ``Bench`` / assembly text / code array) to a
  :class:`Prepared` — the name, machine code, memory images and attached
  policy that every ``api`` entry point consumes;
* :func:`prog_bucket` rounds a program length up to a power-of-two table
  size, so one compilation serves every scenario in the same *shape
  bucket* instead of one compilation per program length;
* :func:`pack_population` pads N prepared programs into common-shape
  arrays — ``ftab`` (N, max_prog, fields), ``p_len`` (N,), per-scenario
  ``mem``/``eff`` images on the shared ``params.total_mem`` footprint, and
  per-scenario ``n_fu``/``prio``/``quota``/``rs_cap`` tables — returning a
  :class:`PackedPopulation` that ``api.run_many`` feeds straight into one
  population machine.

Padding is semantics-free: padded ``ftab`` rows are never fetched
(``pc >= p_len``), and a scenario's images only occupy the addresses its
program reserved.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

import numpy as np

from . import isa, machine
from .builder import BuiltProgram, Program
from .costs import NUM_FUNCS, norm_fu_cost
from .frontend import STREAM_FIELDS, MultiProgram, StreamSet
from .golden import HtsParams
from .policy import SchedPolicy

#: smallest program-table shape bucket (power-of-two buckets above it).
MIN_BUCKET = 32


# ---------------------------------------------------------------------------
# program normalisation (shared by every api entry point)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Prepared:
    """A program normalised to raw machine inputs."""
    name: str
    code: np.ndarray
    mem_init: dict[int, int]
    effects: dict[int, int]
    policy: Optional[SchedPolicy] = None    # attached by builder/merge
    #: per-tenant frontends (``frontend.MultiProgram``); ``None`` = the
    #: historical single merged in-order frontend
    streams: Optional[StreamSet] = None


def prepare(program) -> Prepared:
    """Accept Program | MultiProgram | BuiltProgram | Bench-like | asm text
    | code array."""
    if isinstance(program, Prepared):
        return program
    if isinstance(program, MultiProgram):
        return Prepared(program.name, program.code, program.mem_init,
                        program.effects, program.policy, program.streams)
    if isinstance(program, Program):
        program = program.build()
    if isinstance(program, BuiltProgram):
        return Prepared(program.name, program.code, program.mem_init,
                        program.effects, program.policy)
    if isinstance(program, str):                      # assembly text
        from . import assembler
        return Prepared("<asm>", assembler.assemble(program), {}, {})
    if isinstance(program, np.ndarray):               # raw machine code
        return Prepared("<code>", program, {}, {})
    if hasattr(program, "asm"):                       # programs.Bench (duck)
        from . import assembler
        return Prepared(getattr(program, "name", "<bench>"),
                        assembler.assemble(program.asm),
                        dict(getattr(program, "mem_init", {}) or {}),
                        dict(getattr(program, "effects", {}) or {}),
                        getattr(program, "policy", None))
    raise TypeError(f"cannot interpret {type(program).__name__} as an HTS "
                    "program")


def norm_n_fu(n_fu) -> tuple[int, ...]:
    """An int (uniform) or NUM_FUNCS per-class counts → per-class tuple."""
    if isinstance(n_fu, (int, np.integer)):
        return (int(n_fu),) * NUM_FUNCS
    t = tuple(int(k) for k in n_fu)
    if len(t) != NUM_FUNCS:
        raise ValueError(f"n_fu must be an int or {NUM_FUNCS} per-class "
                         f"counts, got {len(t)}")
    return t


def norm_policy(policy: Optional[SchedPolicy], prep: Prepared,
                params: HtsParams) -> SchedPolicy:
    """Effective policy: explicit arg > program-attached > params default."""
    if policy is not None:
        return policy
    if prep.policy is not None:
        return prep.policy
    return params.policy


# ---------------------------------------------------------------------------
# shape buckets
# ---------------------------------------------------------------------------
def work_estimate(program) -> int:
    """Static proxy for a scenario's batched-simulation *step count*.

    A batched while loop runs until its *slowest* lane halts, so a batch of
    wildly different scenario lengths wastes lane-steps on the short ones.
    Under event-skip, task execution cycles are skipped over — the steps
    that remain track the frontend's executed instructions and the
    scheduler events, so the instruction count is the proxy that actually
    predicts step counts (Spearman ≈ 0.9 on generated populations;
    cycle-weighted estimates sort *worse*, because long-latency kernels
    are exactly what event-skip elides).
    """
    return len(isa.decode_table(prepare(program).code))


def plan_chunks(programs: Sequence, max_chunk: int = 32,
                min_chunk: int = 8,
                profile=None) -> tuple[tuple[int, ...], ...]:
    """Scenario indices grouped into straggler-isolating vmap chunks.

    A chunk runs as long as its slowest lane, so one heavy scenario in a
    wide batch wastes every other lane's steps.  Scenarios are sorted by
    cost (ascending) and partitioned **geometrically**: the lightest half
    of the population rides in ``max_chunk``-wide batches, the next
    quarter in half-width ones, and so on down to ``min_chunk`` — so the
    heavy tail executes in narrow batches where it can only hold up a few
    lanes.  Widths are powers of two (times ``max_chunk``), so a plan
    compiles at most one machine per distinct width.  Each chunk packs
    (``pack_population``) and runs (``run_many``) as one batch.

    The cost key is :func:`work_estimate` (the static instruction-count
    proxy) unless ``profile`` supplies *measured* per-scenario step
    counts: either a length-N sequence/array of step counts, or anything
    with a ``.steps`` attribute — in particular a first run's
    :class:`~repro.core.hts.api.PopulationResult`, whose ``steps`` are
    the machine's own while-loop trip counts.  Profile-guided plans
    re-chunk long ``run_many`` sweeps from real costs, which is what
    closes the heterogeneous-population gap the proxy leaves open (the
    proxy tracks event counts, not their spread).
    """
    if not 0 < min_chunk <= max_chunk:
        raise ValueError("need 0 < min_chunk <= max_chunk")
    if profile is None:
        key = [work_estimate(p) for p in programs]
    else:
        key = np.asarray(getattr(profile, "steps", profile))
        if key is None or key.dtype == object or key.ndim != 1:
            raise ValueError("profile must be a 1-D sequence of per-"
                             "scenario step counts or expose .steps")
        if len(key) != len(programs):
            raise ValueError(f"profile has {len(key)} step counts for "
                             f"{len(programs)} programs")
        key = [int(x) for x in key]
    order = sorted(range(len(programs)), key=lambda i: key[i])
    chunks: list[tuple[int, ...]] = []
    k, n, width = 0, len(order), max_chunk
    while k < n:
        w = min(width, n - k)
        chunks.append(tuple(order[k:k + w]))
        k += w
        width = max(min_chunk, width // 2)   # narrower toward the tail
    return tuple(chunks)


def prog_bucket(length: int, floor: int = MIN_BUCKET) -> int:
    """Smallest power-of-two program-table size >= ``length`` (>= floor).

    Scenarios in the same bucket share one compiled machine; the bucket
    ladder keeps the number of distinct compilations logarithmic in the
    population's length spread instead of linear in its size.
    """
    if length > 0 and floor <= 0:
        raise ValueError("bucket floor must be positive")
    b = max(int(floor), 1)
    while b < length:
        b *= 2
    return b


# ---------------------------------------------------------------------------
# the packed batch
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class PackedPopulation:
    """N scenarios padded to common static shapes: one compile, one vmap.

    Array layout (scenario-major; every row feeds one machine instance):

    * ``ftab`` (N, max_prog, fields) — decoded program tables, zero-padded;
    * ``p_len`` (N,) — true program lengths (padding rows never fetch);
    * ``mem`` / ``eff`` (N, total_mem) — per-scenario memory/effects images
      on the shared ``params.total_mem`` footprint;
    * ``n_fu`` (N, NUM_FUNCS) — per-scenario accelerator counts;
    * ``prio`` / ``quota`` / ``rs_cap`` (N, NUM_PIDS) — per-scenario
      scheduling-policy tables;
    * ``fu_cost`` (N, NUM_FUNCS, FU_COST_WIDTH) — per-scenario
      per-(class, unit) execution-latency multipliers (all ones =
      homogeneous pool); ``eft`` (N,) — per-scenario EFT-issue flags
      (the lowered ``policy.issue_mode``);
    * ``streams`` (N, max_streams, 4) — per-scenario frontend stream
      tables (``frontend.STREAM_FIELDS``), padded with inactive rows
      (``end <= start`` — never fetched); single-frontend scenarios get
      the one merged stream, so multi-frontend populations ride the same
      shape buckets and batches as everything else.

    ``preps``/``policies`` retain the per-scenario sources so differential
    checks (``api.compare``) can drive the golden oracle scenario by
    scenario against the one batched machine run.
    """
    names: tuple[str, ...]
    preps: tuple[Prepared, ...]
    policies: tuple[SchedPolicy, ...]
    ftab: np.ndarray
    p_len: np.ndarray
    mem: np.ndarray
    eff: np.ndarray
    n_fu: np.ndarray
    prio: np.ndarray
    quota: np.ndarray
    rs_cap: np.ndarray
    fu_cost: np.ndarray
    eft: np.ndarray
    streams: np.ndarray
    max_prog: int
    params: HtsParams               # shared capacities (policy stripped)

    def __len__(self) -> int:
        return len(self.names)

    @property
    def widest_fu(self) -> int:
        """Largest per-class FU count in the batch (pool-width floor)."""
        return int(self.n_fu.max())

    def machine_args(self):
        """The 11 batched arrays in ``machine.make_machine`` run order."""
        return (self.ftab, self.p_len, self.n_fu, self.mem, self.eff,
                self.prio, self.quota, self.rs_cap, self.fu_cost,
                self.eft, self.streams)

    def stream_table(self, i: int) -> np.ndarray:
        """Scenario ``i``'s stream table without the batch padding rows
        (what the golden oracle consumes in differential checks)."""
        tab = self.streams[i]
        keep = tab[:, 1] > tab[:, 0]
        return tab[keep] if keep.any() else tab[:1]


def take_lanes(pop: PackedPopulation, idx,
               names: Sequence[str]) -> PackedPopulation:
    """The population whose lane ``j`` is ``pop``'s lane ``idx[j]`` (any
    order, repeats allowed), named ``names[j]``."""
    idx = np.asarray(idx)

    def take(a: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(np.asarray(a)[idx])

    return dataclasses.replace(
        pop, names=tuple(names),
        preps=tuple(pop.preps[i] for i in idx),
        policies=tuple(pop.policies[i] for i in idx),
        ftab=take(pop.ftab), p_len=take(pop.p_len), mem=take(pop.mem),
        eff=take(pop.eff), n_fu=take(pop.n_fu), prio=take(pop.prio),
        quota=take(pop.quota), rs_cap=take(pop.rs_cap),
        fu_cost=take(pop.fu_cost), eft=take(pop.eft),
        streams=take(pop.streams))


def replicate(pop: PackedPopulation, width: int) -> PackedPopulation:
    """A ``width``-lane population that tiles ``pop``'s lanes.

    Every batched array repeats lane-for-lane (lane ``i`` is source lane
    ``i % len(pop)``), so the replica exercises exactly the same step
    bodies at a different lane width — the controlled variable of the
    width-cost sweeps (``benchmarks/stepwidth.py``).  Names are suffixed
    with the replica index to stay unique.
    """
    n = len(pop)
    if width < 1:
        raise ValueError(f"width must be >= 1, got {width}")
    return take_lanes(pop, np.arange(width) % n,
                      [f"{pop.names[i % n]}#r{i // n}" for i in range(width)])


def _broadcast_n_fu(n_fu, n: int) -> np.ndarray:
    """One shared FU spec or a length-N per-scenario list → (N, NUM_FUNCS).

    A flat sequence of ints is always read as *per-class* counts (the
    established ``run``/``sweep`` meaning); per-scenario specs are a
    sequence of N ints or N per-class tuples.
    """
    if isinstance(n_fu, (int, np.integer)):
        return np.tile(np.asarray(norm_n_fu(n_fu), np.int32), (n, 1))
    seq = list(n_fu)
    flat = all(isinstance(x, (int, np.integer)) for x in seq)
    if flat and len(seq) == NUM_FUNCS:
        return np.tile(np.asarray(norm_n_fu(seq), np.int32), (n, 1))
    if len(seq) != n:
        raise ValueError(
            f"n_fu must be an int, {NUM_FUNCS} per-class counts, or one "
            f"entry per scenario ({n}); got a length-{len(seq)} sequence")
    return np.asarray([norm_n_fu(x) for x in seq], np.int32)


def _broadcast_policy(policy, preps: Sequence[Prepared],
                      params: HtsParams) -> tuple[SchedPolicy, ...]:
    """One shared policy, a per-scenario list, or None (per-program)."""
    if policy is None or isinstance(policy, SchedPolicy):
        return tuple(norm_policy(policy, p, params) for p in preps)
    pols = list(policy)
    if len(pols) != len(preps):
        raise ValueError(f"got {len(pols)} policies for {len(preps)} "
                         "scenarios")
    return tuple(norm_policy(pol, p, params)
                 for pol, p in zip(pols, preps))


def _broadcast_fu_cost(fu_cost, n: int, params: HtsParams) -> np.ndarray:
    """One shared cost-table spec or one per scenario → (N, NF, WIDTH).

    A ``None`` entry (or a ``None`` argument) falls back to
    ``params.fu_cost`` (all ones if that is unset too).  A single spec is
    anything ``costs.norm_fu_cost`` accepts — a mapping or a full table of
    per-class rows; per-scenario specs are a length-N sequence of those.
    """
    if fu_cost is None:
        return np.tile(norm_fu_cost(params.fu_cost), (n, 1, 1))
    if (isinstance(fu_cost, (list, tuple)) and len(fu_cost) == n
            and all(x is None or np.ndim(x) == 2
                    or isinstance(x, dict) for x in fu_cost)):
        return np.stack([norm_fu_cost(x if x is not None
                                      else params.fu_cost)
                         for x in fu_cost])
    return np.tile(norm_fu_cost(fu_cost), (n, 1, 1))


def pack_population(programs: Sequence,
                    *, params: HtsParams = HtsParams(),
                    n_fu: Union[int, Sequence] = 2,
                    policy=None,
                    fu_cost=None,
                    max_prog: Optional[int] = None,
                    max_streams: Optional[int] = None) -> PackedPopulation:
    """Pack N programs into one :class:`PackedPopulation`.

    ``programs`` — anything :func:`prepare` accepts, one per scenario.
    ``n_fu`` — shared spec (int / per-class tuple) or one entry per
    scenario.  ``policy`` — shared :class:`SchedPolicy`, one per scenario,
    or ``None`` (each program's attached policy, then ``params.policy``).
    ``fu_cost`` — shared per-(class, unit) cost-table spec
    (``costs.norm_fu_cost`` forms) or one per scenario; ``None`` falls
    back to ``params.fu_cost`` (all ones if unset — homogeneous pools).
    ``max_prog`` — the shared table shape; defaults to the population's
    :func:`prog_bucket`.  ``max_streams`` — the shared frontend-stream
    table width; defaults to the population's widest stream set.  The
    stream count is a compilation *shape* (like ``max_prog``), so callers
    that must keep one compiled machine across batches — the serving
    engine's bucket cache — pin it explicitly; extra rows are inactive
    padding (``end <= start``, never fetched).  All scenarios share
    ``params`` capacities (the machine is compiled once per
    ``(params, costs, shapes)``).
    """
    preps = tuple(prepare(p) for p in programs)
    if not preps:
        raise ValueError("pack_population needs at least one program")
    n = len(preps)

    tables = [isa.decode_table(p.code) for p in preps]
    longest = max(len(t) for t in tables)
    if max_prog is None:
        max_prog = prog_bucket(longest)
    elif longest > max_prog:
        which = preps[max(range(n), key=lambda i: len(tables[i]))].name
        raise ValueError(f"program {which!r} length {longest} > max_prog "
                         f"{max_prog}")

    ftab = np.zeros((n, max_prog, tables[0].shape[1]), np.int32)
    p_len = np.zeros((n,), np.int32)
    for i, t in enumerate(tables):
        ftab[i, :len(t)] = t
        p_len[i] = len(t)

    mem = np.zeros((n, params.total_mem), np.int32)
    eff = np.zeros((n, params.total_mem), np.int32)
    for i, p in enumerate(preps):
        mem[i], eff[i] = machine.images(params, p.mem_init, p.effects)

    pols = _broadcast_policy(policy, preps, params)
    prio = np.stack([pol.weight_array() for pol in pols]).astype(np.int32)
    quota = np.stack([pol.quota_array() for pol in pols]).astype(np.int32)
    rs_cap = np.stack([pol.rs_cap_array() for pol in pols]).astype(np.int32)
    eft = np.asarray([1 if pol.issue_mode == "eft" else 0 for pol in pols],
                     np.int32)

    # per-scenario frontend stream tables, padded to the batch's widest
    # stream count with inactive rows (end <= start: arrived-and-drained,
    # semantics-free like the ftab padding)
    tabs = [(p.streams.table(pol) if p.streams is not None
             else StreamSet.single(int(p_len[i])).table())
            for i, (p, pol) in enumerate(zip(preps, pols))]
    max_ns = max(len(t) for t in tabs)
    if max_streams is not None:
        if max_ns > max_streams:
            raise ValueError(f"population has a {max_ns}-stream scenario > "
                             f"max_streams {max_streams}")
        max_ns = int(max_streams)
    streams = np.zeros((n, max_ns, len(STREAM_FIELDS)), np.int32)
    for i, t in enumerate(tabs):
        streams[i, :len(t)] = t

    return PackedPopulation(
        names=tuple(p.name for p in preps), preps=preps, policies=pols,
        ftab=ftab, p_len=p_len, mem=mem, eff=eff,
        n_fu=_broadcast_n_fu(n_fu, n), prio=prio, quota=quota,
        rs_cap=rs_cap, fu_cost=_broadcast_fu_cost(fu_cost, n, params),
        eft=eft, streams=streams, max_prog=int(max_prog),
        # the policy/cost tables above are the runtime truth — strip the
        # params copies so one compiled machine serves every policy and
        # cost profile in the batch
        params=dataclasses.replace(params, policy=SchedPolicy(),
                                   fu_cost=None))
