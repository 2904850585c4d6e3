"""Simulation facade of the port: ``run``, ``run_many`` and ``compare``.

    >>> from repro_torch.core import hts
    >>> p = hts.Program("demo")
    >>> x = p.input(0x10, 4)
    >>> fft = p.task("fft_256", in_=x, out=4)
    >>> r = hts.run(p, scheduler="hts_spec", n_fu=2)       # on the card
    >>> r = hts.run(p, scheduler="hts_spec", device="cpu")  # plain torch

``run`` accepts a :class:`~repro_torch.core.hts.builder.Program`, a built
program, a ``Bench``, raw assembly text, or a (P, 4) machine-code array,
and executes it on either backend:

* ``backend="torch"``  — the population machine (:mod:`machine`) as a
  population of one, event-skip by default, on ``device`` (``None`` = the
  CUDA card; without one it raises unless ``device="cpu"``);
* ``backend="golden"`` — the pure-Python cycle-accurate oracle
  (:mod:`golden`).

Both return the same :class:`Result` with identical per-task schedule rows.
``run_many`` packs a population (:mod:`batch`) and runs it as one
population machine; ``compare`` is the differential runner (golden ≡ torch
machine, event-skip on and off, per scheduler).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Sequence, Union

import numpy as np

from . import batch, golden, machine
from .batch import PackedPopulation
from .costs import (ALL_SCHEDULERS, FUNC_NAMES, NUM_FUNCS, SchedulerCosts,
                    costs_by_name, fu_cost_tuple)
from .frontend import StreamSet
from .golden import HtsParams
from .policy import SchedPolicy


class SimulationError(RuntimeError):
    """A simulation did not halt (hit ``max_cycles``) or overflowed."""


def _norm_costs(scheduler) -> SchedulerCosts:
    return (costs_by_name(scheduler) if isinstance(scheduler, str)
            else scheduler)


def _is_population(program) -> bool:
    """A sequence of programs (or a packed batch) vs one program."""
    return isinstance(program, (PackedPopulation, list, tuple))


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TaskRow:
    """One scheduled task: dispatch/issue/complete/broadcast cycles."""
    uid: int
    func: int
    dispatch: int
    issue: int
    complete: int
    broadcast: int
    aborted: bool
    pid: int = 0                 # owning process (multi-tenant accounting)

    @property
    def func_name(self) -> str:
        return FUNC_NAMES.get(self.func, f"acc_{self.func:x}")

    def astuple(self) -> tuple:
        return (self.uid, self.func, self.dispatch, self.issue,
                self.complete, self.broadcast, self.aborted, self.pid)


@dataclasses.dataclass(frozen=True)
class Result:
    """Uniform simulation outcome (either backend)."""
    program: str
    scheduler: str
    backend: str
    n_fu: tuple[int, ...]
    cycles: int
    halted: bool
    schedule: tuple[TaskRow, ...]
    spec_aborted: int
    stall_cycles: int
    fu_busy_cycles: tuple[int, ...]     # per existing unit, class-major order
    wall_us: float
    raw: Any = dataclasses.field(repr=False, compare=False, default=None)
    policy: Optional[SchedPolicy] = dataclasses.field(
        default=None, compare=False)    # arbitration policy this run used
    #: per-stream dispatch-stall cycles (one entry for merged-frontend runs)
    fe_stall: tuple[int, ...] = dataclasses.field(default=(), compare=False)
    #: the per-tenant frontends this run dispatched through (None = the
    #: one merged in-order stream)
    streams: Optional[StreamSet] = dataclasses.field(
        default=None, compare=False)

    @property
    def n_tasks(self) -> int:
        return len(self.schedule)

    @property
    def utilization(self) -> float:
        """Mean busy fraction across the accelerator units that exist."""
        units = sum(self.n_fu)
        if units == 0 or self.cycles == 0:
            return 0.0
        return float(sum(self.fu_busy_cycles)) / (units * self.cycles)

    def speedup_vs(self, other: "Result") -> float:
        """How much faster this run is than ``other`` (>1 ⇒ faster)."""
        return other.cycles / self.cycles

    def schedule_tuple(self) -> list[tuple]:
        """Canonical rows, comparable across backends."""
        return [row.astuple() for row in self.schedule]

    # ------------------------------------------------- multi-tenant metrics
    @property
    def pids(self) -> tuple[int, ...]:
        """Process ids present in the schedule, ascending."""
        return tuple(sorted({row.pid for row in self.schedule}))

    def by_pid(self) -> dict[int, tuple[TaskRow, ...]]:
        """Per-process schedule slices (each app's rows, uid order)."""
        out: dict[int, list[TaskRow]] = {}
        for row in self.schedule:
            out.setdefault(row.pid, []).append(row)
        return {pid: tuple(rows) for pid, rows in sorted(out.items())}

    def schedule_for(self, pid: int) -> tuple[TaskRow, ...]:
        """The schedule rows owned by process ``pid``."""
        return tuple(row for row in self.schedule if row.pid == pid)

    def app_makespan(self, pid: int) -> int:
        """Completion cycle of ``pid``'s last non-aborted task (0 if none)."""
        done = [row.complete for row in self.schedule
                if row.pid == pid and not row.aborted and row.complete >= 0]
        return max(done, default=0)

    def fairness(self, solo: "dict[int, Result]") -> "FairnessReport":
        """Slowdown of each tenant vs its solo run on the same pool:
        shared app makespan / solo makespan; ``max_slowdown`` is the
        fairness figure of merit."""
        slowdowns = {}
        for pid, solo_res in sorted(solo.items()):
            base = solo_res.app_makespan(pid) or solo_res.cycles
            shared = self.app_makespan(pid)
            slowdowns[pid] = shared / base if base else float("inf")
        pol = self.policy or SchedPolicy()
        return FairnessReport(
            slowdowns=slowdowns,
            max_slowdown=max(slowdowns.values(), default=0.0),
            mean_slowdown=(sum(slowdowns.values()) / len(slowdowns)
                           if slowdowns else 0.0),
            weights={pid: pol.weight_of(pid) for pid in slowdowns},
            frontend=({pid: self.frontend_metrics(pid) for pid in slowdowns}
                      if self.streams is not None else {}))

    # ------------------------------------------------- frontend metrics
    def dispatch_stall_cycles(self, pid: Optional[int] = None):
        """Cycles a tenant's stream had arrived and held undispatched
        instructions but was not granted dispatch.  ``pid=None`` returns
        the per-pid dict; a merged-frontend run charges its one stream
        (pid 0)."""
        pids = (self.streams.pids if self.streams is not None
                else (0,) * len(self.fe_stall))
        if pid is None:
            out: dict[int, int] = {}
            for p, s in zip(pids, self.fe_stall):
                out[p] = out.get(p, 0) + int(s)
            return out
        return sum(int(s) for p, s in zip(pids, self.fe_stall) if p == pid)

    def time_to_first_issue(self, pid: int) -> Optional[int]:
        """Cycles from ``pid``'s stream arrival to its first task issue."""
        issues = [row.issue for row in self.schedule
                  if row.pid == pid and row.issue >= 0]
        if not issues:
            return None
        arrival = (self.streams.arrival_of(pid)
                   if self.streams is not None else 0)
        return min(issues) - arrival

    def rs_occupancy_at_dispatch(self, pid: int) -> float:
        """Mean count of ``pid``'s RS-resident tasks at each of its
        dispatches (including the new one)."""
        rows = [(r.dispatch, r.issue) for r in self.schedule
                if r.pid == pid and not r.aborted and r.dispatch >= 0]
        if not rows:
            return 0.0
        occ = [sum(1 for d2, i2 in rows if d2 <= d and (i2 < 0 or i2 > d))
               for d, _ in rows]
        return sum(occ) / len(occ)

    def frontend_metrics(self, pid: int) -> dict:
        return {
            "dispatch_stall_cycles": self.dispatch_stall_cycles(pid),
            "rs_occupancy_at_dispatch": self.rs_occupancy_at_dispatch(pid),
            "time_to_first_issue": self.time_to_first_issue(pid),
        }

    def table(self) -> str:
        """Human-readable per-task schedule."""
        lines = [f"{self.program} · {self.scheduler} · {self.backend} · "
                 f"{self.cycles} cycles · utilization "
                 f"{self.utilization:.1%}",
                 f"{'uid':>4} {'pid':>3} {'function':<13} {'dispatch':>8} "
                 f"{'issue':>8} {'complete':>9} {'broadcast':>9}"]
        for t in self.schedule:
            flag = "  (aborted)" if t.aborted else ""
            lines.append(f"{t.uid:>4} {t.pid:>3} {t.func_name:<13} "
                         f"{t.dispatch:>8} {t.issue:>8} {t.complete:>9} "
                         f"{t.broadcast:>9}{flag}")
        return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class FairnessReport:
    """Per-tenant slowdown of a shared run vs each tenant's solo run."""
    slowdowns: dict[int, float]         # pid → shared/solo makespan ratio
    max_slowdown: float                 # fairness figure of merit
    mean_slowdown: float
    weights: dict[int, int] = dataclasses.field(default_factory=dict)
    frontend: dict[int, dict] = dataclasses.field(default_factory=dict)

    def by_weight(self) -> dict[int, float]:
        """Mean slowdown per priority weight (descending weight order)."""
        acc: dict[int, list[float]] = {}
        for pid, s in self.slowdowns.items():
            acc.setdefault(self.weights.get(pid, 0), []).append(s)
        return {w: sum(v) / len(v)
                for w, v in sorted(acc.items(), reverse=True)}

    def table(self) -> str:
        lines = [f"{'pid':>4} {'weight':>7} {'slowdown':>9}"]
        for pid, s in sorted(self.slowdowns.items()):
            lines.append(f"{pid:>4} {self.weights.get(pid, 0):>7} {s:>9.3f}")
        lines.append(f" max {'':>7} {self.max_slowdown:>9.3f}")
        return "\n".join(lines)


def scenarios_per_second(n: int, wall_us: float) -> float:
    """``n`` scenarios over ``wall_us`` host microseconds (0.0 if unmeasured)."""
    return float(n) / (wall_us * 1e-6) if wall_us else 0.0


def _machine_rows(out: dict[str, Any]) -> tuple[TaskRow, ...]:
    return tuple(TaskRow(*row) for row in machine.schedule_tuple(out))


def _golden_rows(res: golden.Result) -> tuple[TaskRow, ...]:
    return tuple(TaskRow(*row) for row in res.schedule_tuple())


def _machine_result(name: str, scheduler: str, fu: tuple[int, ...],
                    out: dict[str, Any], wall_us: float,
                    pol: SchedPolicy, max_fu_per_class: int,
                    streams: Optional[StreamSet] = None) -> Result:
    """A :class:`Result` from one machine output dict (single scenario)."""
    halted = bool(out["halted"]) and not bool(out["overflow"])
    busy = np.asarray(out["fu_busy_cycles"]).reshape(NUM_FUNCS,
                                                     max_fu_per_class)
    busy_exist = tuple(int(busy[c, u]) for c in range(NUM_FUNCS)
                       for u in range(fu[c]))
    n_streams = len(streams) if streams is not None else 1
    fe_stall = tuple(int(x) for x in
                     np.asarray(out["fe_stall"]).ravel()[:n_streams])
    return Result(
        program=name, scheduler=scheduler, backend="torch", n_fu=fu,
        cycles=int(out["cycles"]), halted=halted,
        schedule=_machine_rows(out), spec_aborted=int(out["spec_aborted"]),
        stall_cycles=int(out["stall_cycles"]), fu_busy_cycles=busy_exist,
        wall_us=wall_us, raw=out, policy=pol, fe_stall=fe_stall,
        streams=streams)


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------
def run(program, *, scheduler: Union[str, SchedulerCosts] = "hts_spec",
        n_fu: Union[int, Sequence[int]] = 2, backend: str = "torch",
        params: HtsParams = HtsParams(), event_skip: bool = True,
        max_cycles: int = 5_000_000, max_prog: int = 256,
        max_fu_per_class: int = 16, check: bool = True,
        policy: Optional[SchedPolicy] = None, fu_cost=None,
        device=None) -> Result:
    """Simulate ``program`` under one scheduler cost model.

    ``policy``: explicit argument > policy attached to the program >
    ``params.policy``.  ``fu_cost``: explicit argument > ``params.fu_cost``
    (any form ``costs.norm_fu_cost`` accepts).  ``device`` places the torch
    machine (``None`` = CUDA, which raises without a card).

    Raises :class:`SimulationError` if the machine does not drain within
    ``max_cycles`` (``check=False`` returns the partial Result).
    """
    prep = batch.prepare(program)
    cost = _norm_costs(scheduler)
    fu = batch.norm_n_fu(n_fu)
    pol = batch.norm_policy(policy, prep, params)
    stream_tab = (prep.streams.table(pol) if prep.streams is not None
                  else None)
    eff_cost = fu_cost if fu_cost is not None else params.fu_cost

    t0 = time.perf_counter()
    if backend == "torch":
        out = machine.simulate(prep.code, cost, params,
                               n_fu=np.asarray(fu, np.int32),
                               mem_init=prep.mem_init, effects=prep.effects,
                               event_skip=event_skip, max_cycles=max_cycles,
                               max_fu_per_class=max_fu_per_class,
                               max_prog=max_prog, policy=pol,
                               fu_cost=eff_cost, streams=stream_tab,
                               device=device)
        wall = (time.perf_counter() - t0) * 1e6
        result = _machine_result(prep.name, cost.name, fu, out, wall, pol,
                                 max_fu_per_class, prep.streams)
    elif backend == "golden":
        g = golden.run(prep.code, cost,
                       dataclasses.replace(params, n_fu=fu, policy=pol,
                                           fu_cost=fu_cost_tuple(eff_cost)),
                       prep.mem_init, prep.effects, max_cycles=max_cycles,
                       streams=stream_tab)
        wall = (time.perf_counter() - t0) * 1e6
        result = Result(
            program=prep.name, scheduler=cost.name, backend=backend,
            n_fu=fu, cycles=int(g.cycles), halted=bool(g.halted),
            schedule=_golden_rows(g), spec_aborted=int(g.spec_aborted),
            stall_cycles=int(g.stall_cycles),
            fu_busy_cycles=tuple(int(x) for x in g.fu_busy_cycles),
            wall_us=wall, raw=g, policy=pol,
            fe_stall=tuple(int(x) for x in g.fe_stall),
            streams=prep.streams)
    else:
        raise ValueError(
            f'backend must be "torch" or "golden", got {backend!r}')

    if check and not result.halted:
        raise SimulationError(
            f"program {prep.name!r} under scheduler {cost.name!r} "
            f"(backend={backend}, n_fu={fu}) did not halt within "
            f"{max_cycles} cycles — livelock, structural overflow, or "
            "max_cycles too small")
    return result


# ---------------------------------------------------------------------------
# run_many: a population in one machine
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True, eq=False)
class PopulationResult:
    """Stacked outcome of one population run.

    Array fields are scenario-major (``cycles[i]`` is scenario ``i``);
    ``self[i]`` materialises scenario ``i`` as an ordinary :class:`Result`.
    """
    scheduler: str
    backend: str
    names: tuple[str, ...]
    n_fu: np.ndarray                   # (N, NUM_FUNCS)
    cycles: np.ndarray                 # (N,)
    halted: np.ndarray                 # (N,) bool (and not overflowed)
    wall_us: float                     # the one population call
    max_fu_per_class: int
    policies: tuple[SchedPolicy, ...]
    raw: Any = dataclasses.field(repr=False, default=None)
    _results: Optional[tuple] = dataclasses.field(repr=False, default=None)
    #: per-scenario frontend stream sets (None entries = merged frontend)
    stream_sets: tuple = ()
    #: trips of the host loop (every lane steps on each); None on golden
    trips: Optional[int] = None

    def __len__(self) -> int:
        return len(self.names)

    def __getitem__(self, i: int) -> Result:
        if self._results is not None:           # golden loop backend
            return self._results[i]
        out = {k: v[i] for k, v in self.raw.items()}
        fu = tuple(int(x) for x in self.n_fu[i])
        return _machine_result(self.names[i], self.scheduler, fu, out,
                               self.wall_us / max(len(self), 1),
                               self.policies[i], self.max_fu_per_class,
                               (self.stream_sets[i] if self.stream_sets
                                else None))

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    @property
    def all_halted(self) -> bool:
        return bool(np.asarray(self.halted).all())

    @property
    def steps(self) -> Optional[np.ndarray]:
        """Per-scenario machine step counts (None on the golden backend)."""
        if self.raw is None or "steps" not in self.raw:
            return None
        return np.asarray(self.raw["steps"])

    def scenarios_per_second(self, wall_us: Optional[float] = None) -> float:
        return scenarios_per_second(
            len(self), self.wall_us if wall_us is None else wall_us)

    def table(self) -> str:
        lines = [f"population · {self.scheduler} · {self.backend} · "
                 f"{len(self)} scenarios · {self.wall_us:.0f} us",
                 f"{'scenario':<28} {'cycles':>10} {'halted':>7}"]
        for i, nm in enumerate(self.names):
            lines.append(f"{nm:<28} {int(self.cycles[i]):>10} "
                         f"{str(bool(self.halted[i])):>7}")
        return "\n".join(lines)


def run_many(programs, *,
             scheduler: Union[str, SchedulerCosts] = "hts_spec",
             n_fu: Union[int, Sequence] = 2, backend: str = "torch",
             params: HtsParams = HtsParams(), event_skip: bool = True,
             max_cycles: int = 5_000_000, max_prog: Optional[int] = None,
             max_fu_per_class: Optional[int] = None,
             policy=None, check: bool = True, fu_cost=None,
             device=None) -> PopulationResult:
    """Simulate a population of programs as **one population machine**.

    ``programs`` is a sequence of anything :func:`run` accepts (or a
    :class:`~repro_torch.core.hts.batch.PackedPopulation`, which then
    supplies ``n_fu``/``policy``/``max_prog``/``fu_cost``).  ``n_fu``,
    ``policy`` and ``fu_cost`` take one shared value or one per scenario.
    ``backend="golden"`` runs the oracle in a loop instead (same result
    surface).  ``device``: ``None`` = CUDA (raises without a card).
    """
    pop = (programs if isinstance(programs, PackedPopulation)
           else batch.pack_population(programs, params=params, n_fu=n_fu,
                                      policy=policy, fu_cost=fu_cost,
                                      max_prog=max_prog))
    cost = _norm_costs(scheduler)

    if backend == "golden":
        t0 = time.perf_counter()
        results = tuple(
            run(prep, scheduler=cost, n_fu=tuple(int(x) for x in pop.n_fu[i]),
                backend="golden", params=pop.params, max_cycles=max_cycles,
                policy=pop.policies[i], fu_cost=pop.fu_cost[i], check=check)
            for i, prep in enumerate(pop.preps))
        wall = (time.perf_counter() - t0) * 1e6
        return PopulationResult(
            scheduler=cost.name, backend="golden", names=pop.names,
            n_fu=pop.n_fu, cycles=np.asarray([r.cycles for r in results]),
            halted=np.asarray([r.halted for r in results]), wall_us=wall,
            max_fu_per_class=pop.widest_fu, policies=pop.policies,
            _results=results,
            stream_sets=tuple(p.streams for p in pop.preps))
    if backend != "torch":
        raise ValueError(
            f'backend must be "torch" or "golden", got {backend!r}')

    widest = pop.widest_fu
    if max_fu_per_class is None:
        # narrow pools: every per-unit state array is multiplied by N lanes
        max_fu_per_class = max(4, widest)
    elif widest > max_fu_per_class:
        raise ValueError(f"population n_fu {widest} exceeds "
                         f"max_fu_per_class {max_fu_per_class}")

    spec = machine.MachineSpec(params=pop.params, costs=cost,
                               event_skip=event_skip, max_cycles=max_cycles,
                               max_fu_per_class=max_fu_per_class)
    m = machine.make_machine(spec, pop.max_prog, device)
    t0 = time.perf_counter()
    out = machine.carry_to_numpy(m.run(*pop.machine_args()))
    wall = (time.perf_counter() - t0) * 1e6

    halted = out["halted"] & ~out["overflow"]
    result = PopulationResult(
        scheduler=cost.name, backend="torch", names=pop.names, n_fu=pop.n_fu,
        cycles=out["cycles"], halted=halted, wall_us=wall,
        max_fu_per_class=max_fu_per_class, policies=pop.policies, raw=out,
        stream_sets=tuple(p.streams for p in pop.preps),
        trips=m.stats["trips"])
    if check and not result.all_halted:
        bad = [pop.names[i] for i in np.nonzero(~halted)[0]]
        raise SimulationError(
            f"population run under scheduler {cost.name!r}: scenarios "
            f"{bad} did not halt within {max_cycles} cycles — livelock, "
            "structural overflow, or max_cycles too small")
    return result


# ---------------------------------------------------------------------------
# compare: differential runner (golden vs torch machine, event-skip on/off)
# ---------------------------------------------------------------------------
class MismatchError(AssertionError):
    """Two backends produced different schedules for the same program."""


@dataclasses.dataclass(frozen=True)
class CompareReport:
    """Outcome of :func:`compare`: ``results[scheduler]`` is the golden
    :class:`Result`, which the torch machine matched with event-skip on
    and off (``n_modes`` = 3 executions per scheduler)."""
    program: str
    schedulers: tuple[str, ...]
    results: dict[str, Result]
    n_modes: int = 3

    def cycles(self, scheduler: str) -> int:
        return self.results[scheduler].cycles


def _first_diff(a: list[tuple], b: list[tuple]) -> str:
    if len(a) != len(b):
        return f"row counts differ: {len(a)} vs {len(b)}"
    for i, (ra, rb) in enumerate(zip(a, b)):
        if ra != rb:
            return f"first differing row {i}: {ra} vs {rb}"
    return "schedules equal"


def compare(program, *,
            schedulers: Sequence[Union[str, SchedulerCosts]] =
            ("naive", "hts_nospec", "hts_spec"),
            n_fu: Union[int, Sequence[int]] = 2,
            params: HtsParams = HtsParams(),
            max_cycles: int = 5_000_000, max_prog: Optional[int] = None,
            max_fu_per_class: Optional[int] = None,
            policy: Optional[SchedPolicy] = None, fu_cost=None,
            device=None) -> CompareReport:
    """Differential execution: golden oracle vs the torch machine with
    event-skip **on and off**, for every scheduler cost model.

    Raises :class:`MismatchError` (naming program, scheduler and mode) on
    the first schedule-tuple or cycle-count disagreement.  One program
    only: the population form (``compare_population``) is not ported yet.
    """
    if _is_population(program):
        raise TypeError("compare takes one program; population compare is "
                        "not ported yet (use run_many against golden)")
    prep = batch.prepare(program)
    if max_prog is None:
        max_prog = 256
    fu = batch.norm_n_fu(n_fu)
    if max_fu_per_class is None:
        # size the pool to the request: the event-skip-off runs tick every
        # cycle, and per-cycle cost scales with the pool width
        max_fu_per_class = max(4, max(fu))
    results: dict[str, Result] = {}
    names = []
    for scheduler in schedulers:
        cost = _norm_costs(scheduler)
        names.append(cost.name)
        g = run(prep, scheduler=cost, n_fu=fu, backend="golden",
                params=params, max_cycles=max_cycles, max_prog=max_prog,
                policy=policy, fu_cost=fu_cost)
        gold_rows = g.schedule_tuple()
        for event_skip in (True, False):
            m = run(prep, scheduler=cost, n_fu=fu, backend="torch",
                    params=params, event_skip=event_skip,
                    max_cycles=max_cycles, max_prog=max_prog,
                    max_fu_per_class=max_fu_per_class, policy=policy,
                    fu_cost=fu_cost, device=device)
            mode = f"torch event_skip={'on' if event_skip else 'off'}"
            if m.cycles != g.cycles:
                raise MismatchError(
                    f"{prep.name!r} under {cost.name!r}: {mode} ran "
                    f"{m.cycles} cycles, golden ran {g.cycles}")
            if m.schedule_tuple() != gold_rows:
                raise MismatchError(
                    f"{prep.name!r} under {cost.name!r}: {mode} schedule "
                    f"differs from golden — "
                    f"{_first_diff(m.schedule_tuple(), gold_rows)}")
        results[cost.name] = g
    return CompareReport(program=prep.name, schedulers=tuple(names),
                         results=results)


__all__ = ["run", "run_many", "compare", "Result", "PopulationResult",
           "TaskRow", "FairnessReport", "CompareReport", "MismatchError",
           "SimulationError", "SchedPolicy", "PackedPopulation",
           "ALL_SCHEDULERS", "scenarios_per_second"]
