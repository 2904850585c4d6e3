"""Seeded multi-tenant workload generator (the paper's headline claim,
driven at scale).

The abstract promises "an example heterogeneous system to enable multiple
applications to share the available accelerators", but the repo's original
evaluation exercised exactly two hand-written apps through a pairwise
interleave.  This module generates *scenarios*: N tenant programs (2–8
processes, distinct ISA pids) built on the Program Builder — random mixes of
FIR/FFT/DCT-class kernels, dependency chains, fan-outs, loops and
mem/bus-kind branches — merged N-way through :meth:`builder.Program.merge`.
Related hardware-scheduler evaluations (hardware-HEFT, priority-aware NoC
scheduling) use exactly this kind of generated heterogeneous DAG workload
with per-application slowdown metrics.

Every scenario is a pure function of its seed (``numpy`` Generator), so a
failing fuzz case is one integer away from a reproduction:

    >>> sc = generate_scenario(1234)
    >>> from repro_torch.core import hts
    >>> hts.compare(sc.merged)                  # golden ≡ machine, all modes
    >>> shared = hts.run(sc.merged, n_fu=2)
    >>> shared.fairness(solo_results(sc, n_fu=2)).max_slowdown

``mixed_priority=True`` scenarios additionally draw per-pid priority
weights (and sometimes a per-class FU quota and/or a per-pid RS admission
cap) into a :class:`~repro_torch.core.hts.policy.SchedPolicy` attached to the
merge, so the same differential fuzzing loop exercises the weighted/quota
arbiter and the RS admission stall — ``hts.compare`` picks the policy up
automatically.

Population batches
------------------
:func:`generate_population` is the scenario generator at population scale:
N seeded scenarios grouped into *shape buckets* (``batch.prog_bucket`` of
the merged program length), each bucket a :class:`Population` whose merged
programs pack into one ``hts.run_many`` vmap batch — the unit of work for
population-scale sweeps (``benchmarks/population.py``).

Resource rationing
------------------
One merged machine must hold every tenant at once, so the generator rations
the two global namespaces the ISA exposes:

* **task memory** — tenant ``i`` gets the span ``[base_i, base_i + span)``
  of the default 1024-word memory image (the shared read-only input frame at
  ``INPUT`` is the only span tenants may have in common), and the generator
  tracks its own words so the bump allocator can never cross into a
  neighbour;
* **GPRs** — loops (counter + walking base + stride) and branches
  (threshold) consume registers; each tenant's feature mix is gated on a
  ``31 // n_tenants`` register budget so ``merge`` always fits the bank.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from .builder import Program
from .costs import NUM_FUNCS, fu_cost_tuple
from .policy import SchedPolicy
from .programs import Bench, INPUT, INPUT_WORDS

#: first tenant region base (above the shared input frame) and the top of the
#: generator's address space (default ``HtsParams.mem_words``).
TENANT_BASE = 0x40
MEM_WORDS = 1024
_ALIGN = 0x8

#: kernel pools (Table II keynames) by execution-cycle weight.  The cheap mix
#: keeps golden/no-event-skip differential runs fast (every kernel < 1k
#: cycles); the full mix adds the long-latency FFT/FIR heavyweights.
CHEAP_MIX = ("vector_dot", "vector_add", "vector_max", "dct", "correlation")
DSP_MIX = CHEAP_MIX + ("real_fir", "iir")
FULL_MIX = DSP_MIX + ("complex_fir", "adaptive_fir", "fft_256")

_SHAPES = ("chain", "fanout", "mixed", "loop", "branch")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One generated multi-tenant workload: N solo programs + their merge."""
    name: str
    seed: int
    pids: tuple[int, ...]
    tenants: tuple[Bench, ...]          # builder-backed, one per pid
    merged: Bench                       # N-way Program.merge, distinct pids
    policy: Optional[SchedPolicy] = None  # mixed-priority scenarios only
    #: the same tenants as per-tenant frontend streams (``frontends=True``
    #: scenarios) — one MultiProgram, same pids, same policy
    multi: Optional[object] = None
    #: per-tenant arrival offsets (``arrivals=True``; index-aligned with
    #: ``pids``); () when arrivals were not drawn
    arrivals: tuple[int, ...] = ()
    #: heterogeneous per-(class, unit) cost table
    #: (``heterogeneous_fus=True``; the hashable
    #: :func:`~repro_torch.core.hts.costs.fu_cost_tuple` form — pass it as the
    #: ``fu_cost=`` of ``hts.run``/``hts.compare``); None = uniform units
    fu_cost: Optional[tuple] = None

    @property
    def n_tenants(self) -> int:
        return len(self.pids)

    def solo(self, pid: int) -> Bench:
        """The standalone program of tenant ``pid``."""
        return self.tenants[self.pids.index(pid)]


class _Tenant:
    """Generation state for one tenant: its Program plus resource budgets."""

    def __init__(self, pid: int, base: int, span: int, reg_budget: int):
        self.prog = Program(f"tenant{pid}", region_base=base)
        self.pid = pid
        self.words_left = span
        self.regs_left = reg_budget
        self.frame = self.prog.input(INPUT, INPUT_WORDS, "frame")

    def take(self, regs: int, words: int) -> bool:
        """Deduct both budgets atomically (no leak when one check fails)."""
        words = -(-words // _ALIGN) * _ALIGN    # the allocator aligns to 8
        if regs > self.regs_left or words > self.words_left:
            return False
        self.regs_left -= regs
        self.words_left -= words
        return True


def _emit_straight(rng: np.random.Generator, t: _Tenant, kernels, n: int,
                   chain: bool) -> None:
    """``n`` tasks reading the frame (fanout) or each other (chain)."""
    prev = t.frame
    for i in range(n):
        if not t.take(0, 4):
            return
        h = t.prog.task(str(rng.choice(kernels)), in_=prev, out=4,
                        in_size=4, tid=i & 0xF)
        if chain or (not chain and rng.random() < 0.2):
            prev = h                        # occasional dep even in fanout


def _emit_loop(rng: np.random.Generator, t: _Tenant, kernels) -> bool:
    """A 2–4 iteration loop walking a fresh output span (3 registers)."""
    iters = int(rng.integers(2, 5))
    stride = _ALIGN
    if not t.take(3, iters * stride):       # counter + walking base + stride
        return False
    w = t.prog.walker(stride=stride, count=iters, name=f"w{t.pid}")
    with t.prog.loop(iters):
        t.prog.task(str(rng.choice(kernels)), in_=t.frame, out=w,
                    out_size=4, tid=1)
        w.advance()
    return True


def _emit_branch(rng: np.random.Generator, t: _Tenant, kernels) -> bool:
    """A mem- or bus-kind branch with 1–2 tasks per arm (1 register)."""
    n_each = int(rng.integers(1, 3))
    # cond region + both arms' outs, each rounded up to the 8-word alignment
    if not t.take(1, _ALIGN + n_each * 2 * _ALIGN):     # 1 reg: threshold
        return False
    kind = str(rng.choice(("mem", "bus")))
    taken = bool(rng.random() < 0.5)
    cond = t.prog.region(1, name=f"cond{t.pid}")
    if kind == "bus":
        t.prog.task("correlation", in_=t.frame, out=cond, tid=0)
        cond.effect(9 if taken else 1)
    else:
        cond.init(9 if taken else 1)
    br = t.prog.branch(on=cond, cond=">=", thr=5, kind=kind)
    with br.not_taken():                    # speculated path
        for i in range(n_each):
            t.prog.task(str(rng.choice(kernels)), in_=t.frame, out=4,
                        tid=i & 0xF)
    with br.taken():
        for i in range(n_each):
            t.prog.task(str(rng.choice(kernels)), in_=t.frame, out=4,
                        tid=(i + 4) & 0xF)
    return True


def _generate_tenant(rng: np.random.Generator, pid: int, base: int, span: int,
                     reg_budget: int, kernels: Sequence[str],
                     max_tasks: int) -> Bench:
    t = _Tenant(pid, base, span, reg_budget)
    shape = str(rng.choice(_SHAPES))
    with t.prog.process(pid):
        if shape == "loop" and not _emit_loop(rng, t, kernels):
            shape = "chain"
        elif shape == "branch" and not _emit_branch(rng, t, kernels):
            shape = "fanout"
        if shape in ("chain", "fanout"):
            _emit_straight(rng, t, kernels, int(rng.integers(2, max_tasks + 1)),
                           chain=(shape == "chain"))
        elif shape == "mixed":
            _emit_straight(rng, t, kernels, int(rng.integers(1, 3)),
                           chain=True)
            if rng.random() < 0.5:
                _emit_loop(rng, t, kernels)
            else:
                _emit_straight(rng, t, kernels, int(rng.integers(1, 3)),
                               chain=False)
        else:                               # loop/branch got their core; pad
            _emit_straight(rng, t, kernels, int(rng.integers(0, 2)),
                           chain=False)
    return Bench.of(t.prog)


#: weight pool for ``mixed_priority`` scenarios: a QoS class per tenant,
#: skewed towards best-effort (0) with occasional high-priority tenants.
PRIORITY_POOL = (0, 0, 1, 2, 4, 8)


#: largest drawn per-tenant arrival offset (cycles).  Big enough that an
#: early tenant can flood the shared window before a late one arrives,
#: small relative to generated-program makespans (kernels are 53–18673
#: cycles), so arrival-staggered scenarios still overlap.
MAX_ARRIVAL = 256


def generate_scenario(seed: int, *, n_tenants: Optional[int] = None,
                      kernels: Sequence[str] = DSP_MIX,
                      max_tasks: int = 5,
                      name: Optional[str] = None,
                      mixed_priority: bool = False,
                      frontends: bool = False,
                      arrivals: bool = False,
                      heterogeneous_fus: bool = False) -> Scenario:
    """One seeded scenario: ``n_tenants`` (2–8, drawn when omitted) programs
    with distinct pids, disjoint region/register budgets, merged N-way.

    ``mixed_priority=True`` additionally draws a :class:`SchedPolicy` for the
    merge — per-pid priority weights from :data:`PRIORITY_POOL` (at least one
    tenant strictly above the rest so the weighted arbiter provably engages)
    and, each with probability ½ per scenario, a per-class FU quota of 1–2
    units on one tenant and an RS admission cap of 1–4 entries on one
    tenant.  The tenant *programs* are identical to the unprioritised
    scenario of the same seed (the policy draws happen after program
    generation), so fuzz failures stay one integer away from reproduction.

    ``frontends=True`` additionally builds :attr:`Scenario.multi` — the
    same tenants as per-tenant frontend streams
    (:func:`frontend.build_frontends`, same pids and policy), the fuzz
    target for the multi-stream dispatch model.  ``arrivals=True``
    (implies ``frontends``) draws seeded per-tenant arrival offsets in
    ``[0, MAX_ARRIVAL]`` into the stream table; the draws happen *after*
    program and policy generation, so same-seed programs are unchanged.

    ``heterogeneous_fus=True`` draws (last of all, so every earlier draw
    of the same seed is unchanged) a per-(class, unit) cost table into
    :attr:`Scenario.fu_cost` — each class gets, with probability ½, a row
    of small integer multipliers (slow units deliberately land at *low*
    unit indices sometimes, where the greedy arbiter picks them first) —
    and, with probability ½, flips the scenario policy to
    ``issue_mode="eft"`` so the earliest-finish-time arbiter is fuzzed on
    the same programs.
    """
    rng = np.random.default_rng(seed)
    if n_tenants is None:
        n_tenants = int(rng.integers(2, 9))
    if not 1 <= n_tenants <= 8:
        raise ValueError(f"n_tenants must be in [1, 8], got {n_tenants}")
    span = ((MEM_WORDS - TENANT_BASE) // n_tenants) // _ALIGN * _ALIGN
    reg_budget = 31 // n_tenants
    pids = tuple(range(1, n_tenants + 1))
    tenants = tuple(
        _generate_tenant(rng, pid, TENANT_BASE + i * span, span, reg_budget,
                         kernels, max_tasks)
        for i, pid in enumerate(pids))
    priorities = quotas = rs_caps = None
    if mixed_priority:
        weights = {pid: int(rng.choice(PRIORITY_POOL)) for pid in pids}
        boosted = int(rng.choice(pids))
        weights[boosted] = max(weights.values()) + int(rng.integers(1, 4))
        priorities = weights
        quotas = ({int(rng.choice(pids)): int(rng.integers(1, 3))}
                  if rng.random() < 0.5 else None)
        rs_caps = ({int(rng.choice(pids)): int(rng.integers(1, 5))}
                   if rng.random() < 0.5 else None)
    merged_prog = Program.merge([b.program for b in tenants],
                                name or f"scenario_{seed}",
                                require_distinct_pids=True,
                                priorities=priorities, quotas=quotas,
                                rs_caps=rs_caps)
    multi = None
    arrival_offsets: tuple[int, ...] = ()
    if frontends or arrivals:
        if arrivals:    # drawn last: same-seed programs/policies unchanged
            arrival_offsets = tuple(
                int(rng.integers(0, MAX_ARRIVAL + 1)) for _ in pids)
        from .frontend import build_frontends
        multi = build_frontends(
            [b.program for b in tenants], f"{merged_prog.name}_fe",
            arrivals=arrival_offsets or None, require_distinct_pids=True,
            priorities=priorities, quotas=quotas, rs_caps=rs_caps)
    fu_cost = None
    if heterogeneous_fus:   # drawn last: every earlier same-seed draw intact
        table = {}
        for fid in range(NUM_FUNCS):
            if rng.random() < 0.5:
                row = tuple(int(v) for v in rng.choice(
                    (1, 1, 2, 3, 4, 8), size=int(rng.integers(2, 5))))
                if any(v != 1 for v in row):
                    table[fid] = row
        fu_cost = fu_cost_tuple(table) if table else None
        if rng.random() < 0.5:      # fuzz the EFT arbiter on the same DAGs
            eft_pol = dataclasses.replace(
                merged_prog.policy or SchedPolicy(), issue_mode="eft")
            merged_prog.policy = eft_pol
            if multi is not None:
                multi = dataclasses.replace(multi, policy=eft_pol)
    return Scenario(name=merged_prog.name, seed=seed, pids=pids,
                    tenants=tenants, merged=Bench.of(merged_prog),
                    policy=merged_prog.policy, multi=multi,
                    arrivals=arrival_offsets, fu_cost=fu_cost)


def generate_scenarios(n: int, *, seed0: int = 0, **kwargs):
    """``n`` scenarios with consecutive seeds (fuzzing convenience)."""
    for s in range(seed0, seed0 + n):
        yield generate_scenario(s, **kwargs)


# ---------------------------------------------------------------------------
# open-loop arrival streams: the serving workload
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Arrival:
    """One open-loop request: ``scenario`` arrives ``t`` seconds into the
    stream (host seconds — the serving clock, not scheduler cycles)."""
    t: float
    scenario: Scenario


def arrival_stream(seed: int, rate: float, n: int, *, seed0: int = 0,
                   dist: str = "poisson", **scenario_kwargs
                   ) -> tuple[Arrival, ...]:
    """A seeded open-loop request stream: ``n`` scenarios with arrival times.

    Closed-batch replay (everything available at t=0) is where batching
    looks free; open arrivals are where a scheduler earns its keep — this
    is the reproducible request stream the serving benchmark
    (``benchmarks/serving.py``) and the serve fuzz tests draw from.

    Inter-arrival gaps are ``Exp(1/rate)`` (``dist="poisson"``, a Poisson
    process) or ``Uniform(0, 2/rate)`` (``dist="uniform"``) — mean arrival
    rate ``rate`` requests/second either way.  The arrival draws come from
    their own ``numpy`` Generator seeded with ``seed``, and scenario ``i``
    **is** ``generate_scenario(seed0 + i, **scenario_kwargs)`` — so
    changing the stream's ``seed``/``rate``/``dist`` never changes the
    scenario programs, and a failing stream case replays from two
    integers.
    """
    if rate <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    if n < 0:
        raise ValueError(f"n must be non-negative, got {n}")
    rng = np.random.default_rng(seed)
    if dist == "poisson":
        gaps = rng.exponential(1.0 / rate, n)
    elif dist == "uniform":
        gaps = rng.uniform(0.0, 2.0 / rate, n)
    else:
        raise ValueError(f'dist must be "poisson" or "uniform", got {dist!r}')
    times = np.cumsum(gaps)
    return tuple(Arrival(float(times[i]),
                         generate_scenario(seed0 + i, **scenario_kwargs))
                 for i in range(n))


# ---------------------------------------------------------------------------
# populations: scenarios grouped into vmap-ready shape buckets
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Population:
    """One shape bucket of scenarios — the unit of a ``run_many`` batch.

    All merged programs fit ``max_prog`` (their common power-of-two table
    bucket), so the whole population simulates as one compiled, vmapped
    machine call:

        >>> pops = generate_population(64, kernels=CHEAP_MIX)
        >>> from repro_torch.core import hts
        >>> results = [hts.run_many(pop.programs, n_fu=2,
        ...                         max_prog=pop.max_prog) for pop in pops]
    """
    scenarios: tuple[Scenario, ...]
    max_prog: int

    def __len__(self) -> int:
        return len(self.scenarios)

    @property
    def programs(self) -> tuple[Bench, ...]:
        """The merged (shared) program of every scenario, batch order."""
        return tuple(sc.merged for sc in self.scenarios)

    @property
    def seeds(self) -> tuple[int, ...]:
        return tuple(sc.seed for sc in self.scenarios)


def generate_population(n: int, *, seed0: int = 0, bucket: bool = True,
                        **kwargs) -> tuple[Population, ...]:
    """``n`` seeded scenarios grouped into shape-bucketed populations.

    Scenario ``seed0 + i`` is identical to ``generate_scenario(seed0 + i,
    **kwargs)`` — bucketing only *groups* scenarios (by the power-of-two
    program-table bucket of their merged instruction count), it never
    changes them.  With ``bucket=False`` everything lands in one
    :class:`Population` padded to the largest bucket (one compile, one
    batch — what the population benchmark uses); with the default
    bucketing, each returned population compiles once per distinct bucket,
    which keeps padding waste bounded on long-tailed program lengths.
    """
    from .batch import prog_bucket, work_estimate
    scenarios = [generate_scenario(s, **kwargs)
                 for s in range(seed0, seed0 + n)]
    sizes = [prog_bucket(work_estimate(sc.merged)) for sc in scenarios]
    if not bucket:
        return (Population(tuple(scenarios), max(sizes, default=0)),)
    buckets: dict[int, list[Scenario]] = {}
    for sc, size in zip(scenarios, sizes):
        buckets.setdefault(size, []).append(sc)
    return tuple(Population(tuple(scs), size)
                 for size, scs in sorted(buckets.items()))


def solo_results(scenario: Scenario, *, scheduler="hts_spec", n_fu=2,
                 backend: str = "torch", **run_kwargs) -> dict:
    """Each tenant's standalone :class:`api.Result` (fairness baselines)."""
    from . import api
    return {pid: api.run(scenario.solo(pid), scheduler=scheduler, n_fu=n_fu,
                         backend=backend, **run_kwargs)
            for pid in scenario.pids}
