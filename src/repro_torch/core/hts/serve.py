"""hts.serve — continuous batching over the population machine.

:func:`api.run_many` answers "simulate this population"; this module
answers "keep simulating whatever arrives".  A :class:`Server` accepts
single scenarios (``submit() -> Future[Result]``), routes each into an
open batch for its *shape bucket*, and launches buckets through the same
population machine everything else uses, so an open arrival stream gets
the batched path's economics.

The pieces, and why each exists:

* **Bucket router** — the machine is shaped by the program-table size and
  the frontend-stream width, so requests are keyed by
  ``(prog_bucket(p_len), prog_bucket(n_streams, floor=1))``.  One open
  batch per bucket.  The key is read off the
  :class:`~repro_torch.core.hts.batch.Prepared` request (code rows, stream
  count): admission never decodes the program.
* **Launch-on-full / launch-on-deadline** — a batch launches the moment
  it reaches ``max_batch`` (inline, inside ``submit``), or when its
  oldest request has waited ``deadline`` seconds (``poll()``, which
  ``submit`` also runs on entry).  The clock is injectable
  (:class:`ManualClock`), so deadlines are testable without sleeps.
* **Static launches** go through :func:`api.run_many`: one ``hts_run``
  launch on the card (one a device with ``devices=N``).
* **Slice-and-refill** (``slice_steps=``) — a static launch holds all its
  lanes until the slowest halts.  With ``slice_steps`` set, a launch
  advances its lanes in slices of at most that many machine steps (one
  ``hts_run`` launch a slice; per-lane limit ``steps + budget`` at entry,
  so a lane refilled at step 0 and one at step 6000 pause alike); after
  each slice the dead lanes are harvested (their futures resolve) and
  refilled from the bucket's queue.  The carry and the normalised
  arguments (``machine.Args``) stay on the device across slices and are
  changed in place: a slice reads back one thing, the dead mask
  (``halted | overflow | cycle >= max_cycles``, computed on the device);
  every dead lane is gathered with one ``index_select`` a collected key;
  the slice's refills are packed together and spliced with one
  ``index_copy_`` a carry key and an argument field, at exactly the
  refilled lanes.  A refill's carry row is ``machine.init_state`` of its
  own arguments, which differs from the fresh template only in ``pc`` and
  ``mem``.  ``slice_steps="auto"`` sizes each slice from the bucket's
  measured completed-request step counts.  In this mode ``submit`` lets a
  bucket's queue deepen past ``max_batch`` (the queue is the refill
  reservoir) and launches on deadline, ``drain()`` or queue pressure.
* **Stable launch shapes** — partial batches are padded to the bucket's
  one lane width (``max_batch``, rounded up to a device multiple) by
  replicating the batch's first request, and ``pack_population(
  max_prog=bucket, max_streams=bucket)`` pins the other two shapes, so
  every launch of a bucket runs the same cached machine
  (:func:`api._runner_for`).  :meth:`Server.cache_info` counts bucket
  hits and misses, and probes what the card would recompile: the CUDA
  libraries this process has built (``builds``) and the ``hts_run``
  launches so far (``launches``), so a warmed server can assert that
  nothing is built after warm-up and that it launched exactly once a
  static batch or a slice.
* **Backpressure** — at most ``max_queue`` requests may be pending across
  all open batches; ``submit`` raises :class:`QueueFullError` beyond
  that, after flushing deadline-expired batches.  A request that
  completes its bucket's batch is always admitted: it launches inline and
  frees ``max_batch`` slots.
* **Sharding** — ``ServeSpec(devices=N)`` splits every launch's lanes
  over N cards (:mod:`shard`): static launches through ``run_many(
  devices=N)``, slices one ``hts_run`` launch a card, all launched before
  any is read back.
* **Service metrics** — every completed request records its queue wait
  and time to result; :meth:`Server.report` aggregates per bucket and per
  tenant, with the slices, their budgets and their host times.

    >>> from repro_torch.core import hts
    >>> with hts.serve(max_batch=4, deadline=0.01, device="cpu") as srv:
    ...     futs = [srv.submit(p) for p in programs]
    ...     srv.drain()
    ...     cycles = [f.result().cycles for f in futs]

The engine is single-threaded: launches happen inside
``submit``/``poll``/``drain`` on the caller's thread, and futures are
resolved before those calls return.

Lifecycle: after :meth:`Server.close` (which flushes), ``submit``,
``poll`` and ``drain`` raise ``RuntimeError``.  Leaving the ``with``
block normally closes; leaving it on an exception calls
:meth:`Server.abort`, which cancels still-queued futures instead of
launching work nobody will read.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from concurrent.futures import Future
from typing import Any, Optional, Sequence, Union

import numpy as np
import torch

from ... import _build
from . import api, batch, cuda_run, machine, shard
from .costs import SchedulerCosts
from .golden import HtsParams
from .policy import SchedPolicy


class QueueFullError(RuntimeError):
    """``submit`` refused: ``max_queue`` requests already pending (and the
    incoming request would not have completed a batch)."""


# ---------------------------------------------------------------------------
# clocks (injectable for deterministic deadline tests)
# ---------------------------------------------------------------------------
class SystemClock:
    """Wall time (``time.monotonic``) — the production clock."""

    def now(self) -> float:
        return time.monotonic()


class ManualClock:
    """A clock that only moves when told to — deadline tests advance it
    explicitly, so launch-on-deadline is exact instead of sleep-flaky."""

    def __init__(self, t: float = 0.0):
        self.t = float(t)

    def now(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += float(dt)
        return self.t


# ---------------------------------------------------------------------------
# spec + reports
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ServeSpec:
    """Everything a :class:`Server` is configured by.

    ``n_fu``/``scheduler``/``params``/``policy``/``event_skip``/
    ``max_cycles`` mean what they mean on :func:`api.run_many` and are
    shared by every request (they shape the machine, so per-request
    variation would defeat the bucket cache; per-request policies still
    work: attach them to the program and leave ``policy=None``).

    ``max_batch`` — lanes per launch (every launch is padded to exactly
    this, rounded up to a device multiple).  ``max_queue`` — pending-
    request bound across all open batches.  ``deadline`` — seconds an
    open batch may age before ``poll()`` launches it partial.
    ``devices`` — shard each launch over N cards (``None`` = one device).
    ``device`` — where the machine runs (``None`` = the CUDA card, which
    raises without one; ``"cpu"`` the plain version).

    ``slice_steps`` — ``None`` (default) launches static batches that run
    to completion; an int runs every launch in slices of at most that
    many machine steps a lane, with dead lanes harvested and refilled from
    the bucket queue between slices; ``"auto"`` sizes slices from the
    bucket's measured completed-request step counts (4x the median of the
    last 64, floor {AUTO_MIN}; first launch at {AUTO} steps).

    The reference's ``step_impl`` (its JAX step lowerings) is not ported:
    the port has one step.
    """
    scheduler: Union[str, SchedulerCosts] = "hts_spec"
    n_fu: Union[int, Sequence[int]] = 2
    params: HtsParams = HtsParams()
    policy: Optional[SchedPolicy] = None
    event_skip: bool = True
    max_cycles: int = 5_000_000
    max_batch: int = 8
    max_queue: int = 64
    deadline: float = 0.050
    devices: Optional[int] = None
    max_fu_per_class: Optional[int] = None
    slice_steps: Optional[Union[int, str]] = None
    device: Any = None


#: first-launch slice budget (machine steps) under ``slice_steps="auto"``
#: (no measured completions yet to take a median of)
AUTO_SLICE_STEPS = 256
#: smallest auto slice — below this, per-slice overhead dominates
AUTO_SLICE_STEPS_MIN = 32
ServeSpec.__doc__ = ServeSpec.__doc__.format(AUTO=AUTO_SLICE_STEPS,
                                             AUTO_MIN=AUTO_SLICE_STEPS_MIN)


@dataclasses.dataclass(frozen=True)
class CacheInfo:
    """Machine-cache accounting.  ``hits``/``misses`` count bucket-machine
    lookups at launch time (miss = first launch of a bucket); ``entries``
    is the number of distinct buckets launched.  ``builds`` is the number
    of CUDA libraries this process has built and opened, ``launches`` its
    ``hts_run`` launches (``cuda_run.launches["run"]``): read from the
    library and the kernel's counter, not inferred.  A warmed server
    launches batch after batch, and refill after refill, with ``builds``
    frozen and ``launches`` up by one a static batch or a slice (one a
    card with ``devices=N``)."""
    hits: int
    misses: int
    entries: int
    builds: int
    launches: int


@dataclasses.dataclass(frozen=True)
class BucketStats:
    batches: int
    requests: int
    pad_lanes: int
    occupancy: float            # mean real-lane fraction (measured per
    #                             slice for sliced launches)
    mean_wait: float            # seconds queued before a lane ran it
    mean_ttr: float             # seconds submit -> result
    slices: int = 0             # sliced launches: slices run
    budgets: tuple = ()         # the slice budgets used, in order of use
    launch_ms: float = 0.0      # host ms a slice: launch to dead mask read
    host_ms: float = 0.0        # host ms a slice: harvest and refill


@dataclasses.dataclass(frozen=True)
class TenantStats:
    requests: int
    mean_wait: float
    mean_ttr: float


@dataclasses.dataclass(frozen=True)
class ServeReport:
    """Aggregated service metrics for everything the server completed."""
    requests: int
    batches: int
    per_bucket: dict
    per_tenant: dict

    def table(self) -> str:
        lines = [f"served {self.requests} requests in {self.batches} "
                 f"batches",
                 f"{'bucket':<14} {'batches':>7} {'reqs':>6} {'occ':>6} "
                 f"{'wait(ms)':>9} {'ttr(ms)':>9} {'slices':>6}"]
        for key, b in sorted(self.per_bucket.items()):
            lines.append(f"{str(key):<14} {b.batches:>7} {b.requests:>6} "
                         f"{b.occupancy:>6.2f} {b.mean_wait * 1e3:>9.3f} "
                         f"{b.mean_ttr * 1e3:>9.3f} {b.slices:>6}")
        if self.per_tenant:
            lines.append(f"{'tenant':<14} {'':>7} {'reqs':>6} {'':>6} "
                         f"{'wait(ms)':>9} {'ttr(ms)':>9}")
            for name, t in sorted(self.per_tenant.items()):
                lines.append(f"{name:<14} {'':>7} {t.requests:>6} {'':>6} "
                             f"{t.mean_wait * 1e3:>9.3f} "
                             f"{t.mean_ttr * 1e3:>9.3f}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class _Request:
    prep: batch.Prepared
    tenant: str
    t_submit: float
    future: Future


@dataclasses.dataclass
class _OpenBatch:
    t_open: float
    requests: list


def _arg_tensors(a: machine.Args) -> list[torch.Tensor]:
    """Every tensor of ``machine.Args``, the program-table fields first."""
    out = []
    for f in dataclasses.fields(a):
        v = getattr(a, f.name)
        out += list(v.values()) if isinstance(v, dict) else [v]
    return out


class Server:
    """The continuous-batching engine.  Build via :func:`serve`."""

    def __init__(self, spec: ServeSpec = ServeSpec(), *, clock=None):
        self.spec = spec
        self._clock = clock if clock is not None else SystemClock()
        self._cost = api._norm_costs(spec.scheduler)
        widest = max(batch.norm_n_fu(spec.n_fu))
        self._max_fu = (spec.max_fu_per_class
                        if spec.max_fu_per_class is not None
                        else max(4, widest))
        if widest > self._max_fu:
            raise ValueError(f"n_fu {widest} exceeds max_fu_per_class "
                             f"{self._max_fu}")
        if spec.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if spec.max_queue < spec.max_batch:
            raise ValueError("max_queue must be >= max_batch")
        sc = spec.slice_steps
        if sc is not None and sc != "auto" and (
                not isinstance(sc, (int, np.integer)) or sc < 1):
            raise ValueError('slice_steps must be None, "auto", or a '
                             f'positive int, got {sc!r}')
        self._device = machine.resolve_device(spec.device)
        if spec.devices is not None:
            shard.shard_devices(spec.devices, self._device)
        self._compaction = sc is not None
        # lane width: max_batch rounded up to a device multiple, so every
        # shard of every launch has the same lanes
        mult = spec.devices or 1
        self._lanes = -(-spec.max_batch // mult) * mult
        self._open: dict[tuple[int, int], _OpenBatch] = {}
        self._runners: dict[tuple[int, int], object] = {}
        self._hits = 0
        self._misses = 0
        self._pending = 0
        self._closed = False
        self._req_rows: list = []      # (bucket, tenant, wait, ttr)
        self._batch_rows: list = []    # (bucket, n_real, pad, occupancy)
        self._slice_rows: list = []    # (bucket, budget, launch s, host s)
        self._done_steps: dict[tuple[int, int], list] = {}

    # -- admission ----------------------------------------------------------
    def bucket_of(self, program) -> tuple[int, int]:
        """The shape-bucket key a program routes to:
        ``(prog_bucket(p_len), prog_bucket(n_streams, floor=1))``."""
        return self._bucket_key(batch.prepare(program))

    @staticmethod
    def _bucket_key(prep: batch.Prepared) -> tuple[int, int]:
        # the hot admission path: length is the code-row count and the
        # stream count is the stream-set size — no program decode here
        n_streams = len(prep.streams) if prep.streams is not None else 1
        return (batch.prog_bucket(len(prep.code)),
                batch.prog_bucket(n_streams, floor=1))

    def _require_open(self) -> None:
        if self._closed:
            raise RuntimeError("server is closed")

    def submit(self, program, *, tenant: str = "-") -> Future:
        """Enqueue one scenario; the Future resolves to its
        :class:`~repro_torch.core.hts.api.Result` when a launch runs it
        (inline on fill or queue pressure, or on a later
        ``poll``/``drain``).

        Raises :class:`QueueFullError` when ``max_queue`` requests are
        already pending (after flushing any deadline-expired batches),
        unless this request completes its bucket's batch, in which case
        it is admitted and the batch launches inline, freeing its slots.
        """
        self._require_open()
        self.poll()                     # free space deadlines already owe
        prep = batch.prepare(program)
        key = self._bucket_key(prep)
        ob = self._open.get(key)
        waiting = len(ob.requests) if ob is not None else 0
        full = self._pending >= self.spec.max_queue
        if full and waiting + 1 < self.spec.max_batch:
            raise QueueFullError(
                f"{self._pending} requests pending >= max_queue "
                f"{self.spec.max_queue}")
        req = _Request(prep=prep, tenant=tenant,
                       t_submit=self._clock.now(), future=Future())
        if ob is None:
            ob = self._open[key] = _OpenBatch(t_open=req.t_submit,
                                              requests=[])
        ob.requests.append(req)
        self._pending += 1
        # static mode launches the moment a batch fills; sliced mode lets
        # the bucket queue deepen (it is the refill reservoir) and
        # launches on deadline/drain, or right here under queue pressure
        if len(ob.requests) >= self.spec.max_batch and (
                full or not self._compaction):
            self._launch(key)
        return req.future

    def poll(self) -> int:
        """Launch every open batch whose oldest request has aged past
        ``deadline``.  Returns the number of batches launched."""
        self._require_open()
        now = self._clock.now()
        due = [k for k, ob in self._open.items()
               if now - ob.t_open >= self.spec.deadline]
        for k in due:
            self._launch(k)
        return len(due)

    def drain(self) -> int:
        """Launch every open batch regardless of age (flush)."""
        self._require_open()
        keys = list(self._open)
        for k in keys:
            self._launch(k)
        return len(keys)

    def close(self) -> None:
        """Flush, then refuse further ``submit``/``poll``/``drain``.
        Idempotent."""
        if self._closed:
            return
        self.drain()
        self._closed = True

    def abort(self) -> None:
        """Discard queued work without launching: cancel every pending
        future, empty the queue, close the server (the ``with`` block's
        exit on an exception)."""
        if self._closed:
            return
        for ob in self._open.values():
            for r in ob.requests:
                r.future.cancel()
        self._open.clear()
        self._pending = 0
        self._closed = True

    def __enter__(self) -> "Server":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is not None:
            self.abort()
        else:
            self.close()

    @property
    def pending(self) -> int:
        """Requests admitted whose futures have not yet resolved."""
        return self._pending

    # -- execution ----------------------------------------------------------
    def _machine_spec(self) -> machine.MachineSpec:
        # run_many's spec exactly (policy/cost-stripped params), so the
        # machine fetched here is the one run_many runs
        return machine.MachineSpec(
            params=dataclasses.replace(self.spec.params,
                                       policy=SchedPolicy(), fu_cost=None),
            costs=self._cost, event_skip=self.spec.event_skip,
            max_cycles=self.spec.max_cycles,
            max_fu_per_class=self._max_fu)

    def _runner(self, key: tuple[int, int]):
        r = self._runners.get(key)
        if r is not None:
            self._hits += 1
            return r
        r = api._runner_for(self._machine_spec(), key[0], self.spec.devices,
                            self._device)
        self._runners[key] = r
        self._misses += 1
        return r

    def _pack(self, preps, key: tuple[int, int]) -> batch.PackedPopulation:
        return batch.pack_population(
            preps, params=self.spec.params, n_fu=self.spec.n_fu,
            policy=self.spec.policy, max_prog=key[0], max_streams=key[1])

    def _resolve(self, key, req: _Request, result, t_filled: float,
                 t_done: float) -> None:
        """Resolve one request's future (and its accounting) — the only
        place ``_pending`` decrements, so a request admitted is a request
        either resolved or still counted."""
        self._pending -= 1
        self._req_rows.append((key, req.tenant, t_filled - req.t_submit,
                               t_done - req.t_submit))
        if result is not None:
            self._done_steps.setdefault(key, []).append(
                int(np.asarray(result.raw["steps"])))
            req.future.set_result(result)
        else:
            req.future.set_exception(api.SimulationError(
                f"request {req.prep.name!r} (tenant {req.tenant!r}) did "
                f"not halt within {self.spec.max_cycles} cycles"))

    def _launch(self, key: tuple[int, int]) -> None:
        ob = self._open.pop(key, None)
        if ob is None or not ob.requests:
            return
        try:
            if self._compaction:
                self._launch_sliced(key, ob.requests)
            else:
                self._launch_static(key, ob.requests)
        except BaseException as e:
            # a failed launch fails its own futures and restores the queue
            # accounting, instead of leaking hung futures
            for r in ob.requests:
                if not r.future.done():
                    self._pending -= 1
                    r.future.set_exception(e)
            raise

    def _launch_static(self, key: tuple[int, int], reqs: list) -> None:
        self._runner(key)           # cache accounting (run_many reuses it)
        # pad to the bucket's one launch shape (replicating the first
        # request; pad results are discarded)
        pad = self._lanes - len(reqs)
        preps = [r.prep for r in reqs] + [reqs[0].prep] * pad
        pop = self._pack(preps, key)
        t_launch = self._clock.now()
        res = api.run_many(pop, scheduler=self._cost,
                           event_skip=self.spec.event_skip,
                           max_cycles=self.spec.max_cycles,
                           max_fu_per_class=self._max_fu,
                           devices=self.spec.devices, check=False,
                           device=self._device)
        t_done = self._clock.now()
        self._batch_rows.append((key, len(reqs), pad,
                                 len(reqs) / self._lanes))
        for i, r in enumerate(reqs):
            self._resolve(key, r, res[i] if bool(res.halted[i]) else None,
                          t_launch, t_done)

    # -- slice-and-refill ---------------------------------------------------
    def _slice_budget(self, key: tuple[int, int]) -> int:
        sc = self.spec.slice_steps
        if sc == "auto":
            hist = self._done_steps.get(key)
            if not hist:
                return AUTO_SLICE_STEPS
            # a few typical requests a slice: fine enough that an
            # event-dense straggler cannot stall the width for long,
            # coarse enough that the per-slice overhead stays amortised
            return max(AUTO_SLICE_STEPS_MIN,
                       4 * int(np.median(hist[-64:])))
        return int(sc)

    def _lane_result(self, req: _Request, out: dict, n_fu_row,
                     wall_us: float) -> api.Result:
        fu = tuple(int(x) for x in n_fu_row)
        pol = batch.norm_policy(self.spec.policy, req.prep,
                                self.spec.params)
        return api._machine_result(req.prep.name, self._cost.name, fu, out,
                                   wall_us, pol, self._max_fu,
                                   req.prep.streams)

    def _dead(self, shards) -> np.ndarray:
        """The one read-back of a slice: each lane's dead mask (halted,
        overflowed or out of cycles), computed on the device."""
        return np.concatenate([
            (st["halted"] | st["overflow"]
             | (st["cycle"] >= self.spec.max_cycles)).cpu().numpy()
            for _m, st, _a in shards])

    def _harvest(self, shards, per: int, lanes: list) -> dict:
        """Each dead lane's output row (numpy): one ``index_select`` a
        collected key on each shard that has dead lanes."""
        rows = {}
        for j, (_m, st, _a) in enumerate(shards):
            mine = [i for i in lanes if i // per == j]
            if not mine:
                continue
            idx = torch.tensor([i % per for i in mine],
                               device=st["cycle"].device)
            out = machine.carry_to_numpy(
                {k: v.index_select(0, idx)
                 for k, v in machine.collect(st).items()})
            for r, i in enumerate(mine):
                rows[i] = {k: v[r] for k, v in out.items()}
        return rows

    def _refill_rows(self, shards, per: int, key: tuple[int, int],
                     lanes: list, reqs: list) -> np.ndarray:
        """Splice fresh lanes for ``reqs`` into ``lanes``: the requests
        packed together, then on each shard their normalised arguments and
        their fresh carry rows (``init_state``: the fresh template with
        their ``pc`` and ``mem``) written with one ``index_copy_`` a carry
        key and an argument field.  Returns the packed ``n_fu`` rows."""
        pop = self._pack([r.prep for r in reqs], key)
        margs = pop.machine_args()
        for j, (m, st, a) in enumerate(shards):
            pick = [r for r, i in enumerate(lanes) if i // per == j]
            if not pick:
                continue
            idx = torch.tensor([lanes[r] % per for r in pick],
                               device=st["cycle"].device)
            rows = machine.norm_args(m, *(None if x is None else x[pick]
                                          for x in margs))
            fresh = machine.init_state(m, rows.mem_init, rows.streams)
            for k, v in st.items():
                v.index_copy_(0, idx, fresh[k])
            for dst, src in zip(_arg_tensors(a), _arg_tensors(rows)):
                dst.index_copy_(0, idx, src)
        return pop.n_fu

    def _launch_sliced(self, key: tuple[int, int], reqs: list) -> None:
        """Run one bucket's queue through ``self._lanes`` lanes in bounded
        step slices, harvesting dead lanes and refilling their slots
        between slices, until the queue is dry and every lane has drained.
        Each request's future resolves the moment its own lane dies."""
        rm = self._runner(key)
        machines = (rm.machines if isinstance(rm, shard.ShardedMachine)
                    else (rm,))
        W = self._lanes
        per = W // len(machines)
        queue = collections.deque(reqs)                # FIFO submit order
        take = [queue.popleft() for _ in range(min(W, len(queue)))]
        pad = W - len(take)
        margs = self._pack([r.prep for r in take] + [take[0].prep] * pad,
                           key).machine_args()
        n_fu_host = np.array(margs[2])             # host mirror for reads
        shards = []
        for j, m in enumerate(machines):
            part = slice(j * per, (j + 1) * per)
            a = machine.norm_args(m, *(None if x is None else x[part]
                                       for x in margs))
            st = machine.init_state(m, a.mem_init, a.streams)
            # retire pad lanes before the first slice: halted, they are
            # fixed points of the step and refillable at once
            lo = len(take) - j * per
            if lo < per:
                st["halted"][max(lo, 0):] = True
            shards.append((m, st, a))
        lanes: list = list(take) + [None] * pad
        t_fill = [self._clock.now()] * W
        served = 0
        occ_num = 0.0
        occ_den = 0
        while any(r is not None for r in lanes):
            occ_num += sum(r is not None for r in lanes) / W
            occ_den += 1
            budget = self._slice_budget(key)
            t0 = time.perf_counter()
            shard.advance(shards, budget, count_trips=False)
            dead = self._dead(shards)
            t1 = time.perf_counter()
            now = self._clock.now()
            done = [i for i in range(W) if lanes[i] is not None and dead[i]]
            refill: list = []
            if done:
                rows = self._harvest(shards, per, done)
                for i in done:
                    r = lanes[i]
                    res = self._lane_result(r, rows[i], n_fu_host[i],
                                            (now - t_fill[i]) * 1e6)
                    self._resolve(key, r, res if res.halted else None,
                                  t_fill[i], now)
                    served += 1
                    lanes[i] = None
                    if queue:
                        lanes[i] = queue.popleft()
                        t_fill[i] = now
                        refill.append(i)
            if refill:
                n_fu_host[refill] = self._refill_rows(
                    shards, per, key, refill, [lanes[i] for i in refill])
            self._slice_rows.append((key, budget, t1 - t0,
                                     time.perf_counter() - t1))
        self._batch_rows.append((key, served, max(0, W - served),
                                 occ_num / max(occ_den, 1)))

    # -- introspection ------------------------------------------------------
    def cache_info(self) -> CacheInfo:
        return CacheInfo(hits=self._hits, misses=self._misses,
                         entries=len(self._runners),
                         builds=_build.loaded(),
                         launches=cuda_run.launches["run"])

    def report(self) -> ServeReport:
        per_bucket: dict = {}
        for key in {row[0] for row in self._batch_rows}:
            rows = [r for r in self._req_rows if r[0] == key]
            launches = [row for row in self._batch_rows if row[0] == key]
            slices = [row for row in self._slice_rows if row[0] == key]
            per_bucket[key] = BucketStats(
                batches=len(launches),
                requests=len(rows),
                pad_lanes=sum(row[2] for row in launches),
                occupancy=float(np.mean([row[3] for row in launches])),
                mean_wait=float(np.mean([r[2] for r in rows])),
                mean_ttr=float(np.mean([r[3] for r in rows])),
                slices=len(slices),
                budgets=tuple(dict.fromkeys(row[1] for row in slices)),
                launch_ms=(float(np.mean([row[2] for row in slices])) * 1e3
                           if slices else 0.0),
                host_ms=(float(np.mean([row[3] for row in slices])) * 1e3
                         if slices else 0.0))
        per_tenant: dict = {}
        for tenant in {r[1] for r in self._req_rows}:
            rows = [r for r in self._req_rows if r[1] == tenant]
            per_tenant[tenant] = TenantStats(
                requests=len(rows),
                mean_wait=float(np.mean([r[2] for r in rows])),
                mean_ttr=float(np.mean([r[3] for r in rows])))
        return ServeReport(requests=len(self._req_rows),
                           batches=len(self._batch_rows),
                           per_bucket=per_bucket, per_tenant=per_tenant)


def serve(spec: Optional[ServeSpec] = None, *, clock=None,
          **overrides) -> Server:
    """Build a :class:`Server` — ``hts.serve()`` is the front door.

    Pass a :class:`ServeSpec`, keyword overrides for its fields, or both
    (overrides win).  ``clock`` injects a time source
    (:class:`ManualClock` in tests; wall time otherwise).  Usable as a
    context manager: ``with hts.serve(...) as srv: ...`` flushes and
    closes on normal exit, aborts (cancels queued futures) on an
    exception.
    """
    if spec is None:
        spec = ServeSpec()
    if overrides:
        spec = dataclasses.replace(spec, **overrides)
    return Server(spec, clock=clock)


__all__ = ["serve", "Server", "ServeSpec", "ServeReport", "BucketStats",
           "TenantStats", "CacheInfo", "QueueFullError", "SystemClock",
           "ManualClock", "AUTO_SLICE_STEPS"]
