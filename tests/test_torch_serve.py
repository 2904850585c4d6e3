"""The port's scenario server (``serve.py``) and scenario sharding
(``shard.py``) on the CPU.

Served results, static and slice-and-refill (``slice_steps`` an int and
``"auto"``, event-skip on and off, heterogeneous cost tables, per-tenant
frontends), are held against the JAX package's ``hts.run_many`` on the
same seeds (one JAX call per configuration) and against the port's own
``run_many``.  The engine's semantics (launch on full, deadlines under a
``ManualClock``, bucket routing, backpressure, failure isolation, the
lifecycle) are the reference's, case by case (``tests/test_hts_serve.py``).
The cache probe counts builds and ``hts_run`` launches: on the CPU nothing
is built, and a stand-in card route counts one launch a static batch or a
slice.  Sharding runs its shards one after another on the CPU (the card's
``devices=N`` is in ``tests/test_torch_cuda.py``).  One sliced server runs
through ``hts_run``'s own source, built with g++ against
``tests/cuda_emu.h``, so that mid-flight splicing and per-lane step limits
meet the kernel.  Programs are CHEAP_MIX scenarios of seeds whose runs
take at most ~50 machine steps (event-skip on): the CPU's plain route
costs ~10 ms a step.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import hts as jhts
from repro.core.hts import shard as jshard
from repro.core.hts import workloads as jworkloads

import repro_torch.core.hts as thts
from repro_torch.core.hts import (api, batch, cuda_run, isa, machine, shard,
                                  workloads)
from repro_torch.core.hts.builder import Program
from repro_torch.core.hts.costs import fu_cost_tuple
from repro_torch.core.hts.programs import Bench
from repro_torch.core.hts.serve import AUTO_SLICE_STEPS, _Request
from test_torch_run import _launch_emulated, emulated  # noqa: F401

CPU = dict(device="cpu")
#: CHEAP_MIX seeds of 14–40 steps each (seed 0 takes 769)
SEEDS = range(1, 7)
#: the sliced fuzz: event-skip on (merged, and per-tenant frontends at
#: every fifth seed), and off on the seeds of fewest cycles (114–276)
FUZZ_SKIP = range(1, 18)
FUZZ_NOSKIP = (5, 10, 31, 36, 78)
#: a cost table marking unit 0 of two classes slow, and its seeds
HETERO_FU_COST = fu_cost_tuple({"dct": (4, 1), "vector_add": (3, 1)})
HETERO_SEEDS = range(60, 68)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scenario(wl, seed, multi=False):
    sc = wl.generate_scenario(seed, n_tenants=2, frontends=multi,
                              kernels=wl.CHEAP_MIX)
    return sc.multi if multi else sc.merged


def _tiny(name, n_tasks, kernel="vector_dot", base=0x100):
    p = Program(name, region_base=base)
    prev = p.input(0x10, 4, "frame")
    for i in range(n_tasks):
        prev = p.task(kernel, in_=prev, out=4, in_size=4, tid=i)
    return p


def _fuzz_progs(wl, seeds):
    return [_scenario(wl, s, multi=s % 5 == 0) for s in seeds]


def _hetero_progs(wl, bench, policy):
    """HETERO_SEEDS' merged programs, every second one on the eft
    arbiter (a ``policy`` attached to the program)."""
    out = []
    for i, s in enumerate(HETERO_SEEDS):
        prog = wl.generate_scenario(s, n_tenants=2,
                                    kernels=wl.CHEAP_MIX).merged.program
        if i % 2:
            prog.policy = dataclasses.replace(prog.policy or policy(),
                                              issue_mode="eft")
        out.append(bench.of(prog))
    return out


@pytest.fixture(scope="module")
def progs():
    return [_scenario(workloads, s) for s in SEEDS]


@pytest.fixture(scope="module")
def port_ref(progs):
    """The port's ``run_many`` over the module's programs."""
    return thts.run_many(progs, **CPU)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's ``run_many`` over the module's seeds."""
    return jhts.run_many([_scenario(jworkloads, s) for s in SEEDS])


def _same(got, jref, i):
    """A served Result equal to lane ``i`` of a JAX population run in
    cycles, stalls, aborts, frontend stalls and schedule."""
    want = jref[i]
    assert got.halted and got.cycles == want.cycles, i
    assert got.stall_cycles == want.stall_cycles, i
    assert got.spec_aborted == want.spec_aborted, i
    assert got.fe_stall == want.fe_stall, i
    assert got.schedule_tuple() == want.schedule_tuple(), i


def _serve_all(progs, **spec):
    """Serve ``progs`` (submitted back to back, then drained) on the CPU
    under a manual clock; the results in submit order and the server."""
    with thts.serve(clock=thts.ManualClock(), **CPU, **spec) as srv:
        futs = [srv.submit(p) for p in progs]
        srv.drain()
        got = [f.result(timeout=0) for f in futs]
    return got, srv


# ---------------------------------------------------------------------------
# the facade: throughput, trip cost
# ---------------------------------------------------------------------------
def test_scenarios_per_second_formula():
    assert thts.scenarios_per_second(10, 2e6) == 5.0
    assert thts.scenarios_per_second(10, 0.0) == 0.0      # unmeasured
    assert thts.scenarios_per_second(0, 1e6) == 0.0


def test_population_result_scenarios_per_second(port_ref):
    r = port_ref
    assert r.scenarios_per_second() == pytest.approx(
        thts.scenarios_per_second(len(r), r.wall_us))
    assert r.scenarios_per_second(1e6) == float(len(r))
    assert r.scenarios_per_sec() == r.scenarios_per_second()


def test_trip_cost_us_probe(progs):
    """Positive a step on the torch backend, from a fresh carry of the
    run's own machine; refused on golden results."""
    r = thts.run_many(progs[:2], **CPU)
    assert r.trip_cost_us(budget=4, reps=2) > 0.0
    g = thts.run_many(progs[:2], backend="golden")
    with pytest.raises(ValueError, match="torch"):
        g.trip_cost_us()


def test_run_many_reuses_one_machine_per_bucket(progs):
    """``_runner_for`` is cached per (spec, max_prog, devices, device):
    the server's hit accounting and ``trip_cost_us`` see the object
    ``run_many`` ran, and ``trips`` stays per call."""
    a = thts.run_many(progs[:2], **CPU)
    b = thts.run_many(progs[:2], **CPU)
    assert a.trips == b.trips == int(a.steps.max())
    m1 = api._runner_for(a._spec, a._max_prog, None, "cpu")
    assert api._runner_for(a._spec, a._max_prog, None, "cpu") is m1
    assert api._runner_for(a._spec, a._max_prog, 2, "cpu") is not m1


# ---------------------------------------------------------------------------
# sharding
# ---------------------------------------------------------------------------
def test_pad_lanes_shape_and_markers(progs):
    pop = batch.pack_population(progs[:3], n_fu=2)
    padded = shard.pad_lanes(pop, 4)
    assert len(padded) == 4 and len(pop) == 3
    assert padded.names[:3] == pop.names
    assert padded.names[3].startswith("<pad:")
    src = int(np.argmin(pop.p_len))                     # lightest lane
    assert int(padded.p_len[3]) == int(pop.p_len[src])
    for a, b in zip(padded.machine_args(), pop.machine_args()):
        assert np.array_equal(a[:3], b)                 # real lanes intact
        assert np.array_equal(a[3], b[src])             # pad replicates src
    assert shard.pad_lanes(pop, 3) is pop               # already divisible
    with pytest.raises(ValueError):
        shard.pad_lanes(pop, 0)
    jpop = jhts.pack_population([_scenario(jworkloads, s)
                                 for s in SEEDS[:3]], n_fu=2)
    for a, b in zip(padded.machine_args(),
                    jshard.pad_lanes(jpop, 4).machine_args()):
        assert np.array_equal(a, b)                     # the reference's


@pytest.mark.parametrize("devices", [1, 2, 3])
def test_run_many_devices_matches_default(progs, port_ref, jax_ref, devices):
    """Lanes split over 1, 2 and 3 shards (6 lanes: 3 over 2 or 2 over 3;
    the padding below), merged back in lane order: equal to the
    one-device path and to the JAX package, lane for lane."""
    r = thts.run_many(progs, devices=devices, **CPU)
    assert len(r) == len(progs)
    assert np.array_equal(r.cycles, port_ref.cycles)
    assert r.trips == port_ref.trips
    for i in range(len(progs)):
        assert r[i].schedule_tuple() == port_ref[i].schedule_tuple()
        _same(r[i], jax_ref, i)
    padded = thts.run_many(progs[:5], devices=3, **CPU)   # 5 lanes over 3
    assert np.array_equal(padded.cycles, port_ref.cycles[:5])
    assert padded._margs[0].shape[0] == 6


def test_compare_population_devices():
    """The sharded machine side held to the golden loop, event-skip on
    and off (the seeds of fewest cycles: off ticks every cycle)."""
    short = [_scenario(workloads, s) for s in (31, 36, 78)]
    rep = thts.compare_population(short, schedulers=("hts_spec",),
                                  devices=2, **CPU)
    assert len(rep) == 3


def test_devices_error_paths(progs, monkeypatch):
    with pytest.raises(ValueError, match="backend"):
        thts.run_many(progs[:2], backend="golden", devices=1)
    with pytest.raises(ValueError, match="devices"):
        thts.run_many(progs[:2], devices=0, **CPU)
    with pytest.raises(ValueError, match="devices"):
        thts.serve(devices=0, **CPU)
    # on the card, more devices than the process sees: a stand-in card
    monkeypatch.setattr(machine, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(shard, "device_count", lambda: 1)
    assert shard.shard_devices(1) == (torch.device("cuda", 0),)
    with pytest.raises(ValueError, match="sees 1 CUDA device"):
        shard.shard_devices(2)


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------
def test_serve_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    with pytest.raises(RuntimeError, match="cpu"):
        thts.serve()


def test_serve_differential_vs_run_many(progs, port_ref, jax_ref):
    """Results served out of shape-bucket batches equal the programs run
    directly, in the port and in the JAX package."""
    with thts.serve(max_batch=4, max_queue=32, deadline=1.0,
                    clock=thts.ManualClock(), **CPU) as srv:
        futs = [srv.submit(p, tenant=f"t{i % 2}")
                for i, p in enumerate(progs)]
        srv.drain()
        got = [f.result(timeout=0) for f in futs]
    assert [r.cycles for r in got] == [int(c) for c in port_ref.cycles]
    for i, r in enumerate(got):
        assert r.schedule_tuple() == port_ref[i].schedule_tuple()
        _same(r, jax_ref, i)
    rep = srv.report()
    assert rep.requests == len(progs)
    assert set(rep.per_tenant) == {"t0", "t1"}
    assert rep.per_tenant["t0"].requests == 3
    assert "served" in rep.table()


def test_serve_arrival_stream_differential():
    """Open-loop serving: a seeded arrival stream replayed on the manual
    clock (deadline-flushed), every result equal to the JAX package's
    ``run_many`` over the same stream."""
    kw = dict(rate=1000.0, n=8, n_tenants=2, seed0=1)
    stream = workloads.arrival_stream(11, kernels=workloads.CHEAP_MIX, **kw)
    jstream = jworkloads.arrival_stream(11, kernels=jworkloads.CHEAP_MIX,
                                        **kw)
    assert [a.t for a in stream] == [a.t for a in jstream]
    clock = thts.ManualClock()
    srv = thts.serve(max_batch=4, max_queue=16, deadline=0.005, clock=clock,
                     **CPU)
    futs = []
    for arr in stream:
        clock.t = arr.t
        futs.append(srv.submit(arr.scenario.merged))
    clock.advance(1.0)
    srv.poll()                                   # deadline-flush the tail
    assert srv.pending == 0
    jref = jhts.run_many([a.scenario.merged for a in jstream])
    for i, f in enumerate(futs):
        _same(f.result(timeout=0), jref, i)


def test_serve_launch_on_full_is_inline(progs):
    srv = thts.serve(max_batch=3, deadline=99.0, clock=thts.ManualClock(),
                     **CPU)
    f1 = srv.submit(progs[0])
    f2 = srv.submit(progs[1])
    assert not f1.done() and srv.pending == 2
    f3 = srv.submit(progs[2])                    # fills the batch
    assert f1.done() and f2.done() and f3.done()
    assert srv.pending == 0


def test_serve_deadline_launch_manual_clock(progs):
    clock = thts.ManualClock()
    srv = thts.serve(max_batch=8, deadline=0.050, clock=clock, **CPU)
    f = srv.submit(progs[0])
    assert srv.poll() == 0 and not f.done()      # too young
    clock.advance(0.049)
    assert srv.poll() == 0                       # still under deadline
    clock.advance(0.002)
    assert srv.poll() == 1                       # aged past 50 ms
    assert f.done()
    # a partial launch pads to max_batch: occupancy shows 1 real lane of 8
    (stats,) = srv.report().per_bucket.values()
    assert stats.pad_lanes == 7 and stats.occupancy == pytest.approx(1 / 8)


def test_serve_submit_flushes_expired_batches(progs):
    """submit() itself runs the deadline check, so a producer that never
    calls poll() still gets deadline launches."""
    clock = thts.ManualClock()
    srv = thts.serve(max_batch=8, deadline=0.010, clock=clock, **CPU)
    f = srv.submit(progs[0])
    clock.advance(0.020)
    srv.submit(progs[1])                         # flushes the aged batch
    assert f.done() and srv.pending == 1


def test_serve_bucket_routing():
    """Requests route by (program bucket, stream bucket): a long program
    and a multi-frontend scenario land in other open batches than a
    short merged one."""
    short = _tiny("short", 2)
    long = _tiny("long", 40)                     # > MIN_BUCKET instructions
    multi = _scenario(workloads, 5, multi=True)
    srv = thts.serve(max_batch=8, max_queue=32, deadline=99.0,
                     clock=thts.ManualClock(), **CPU)
    k_short, k_long, k_multi = (srv.bucket_of(p)
                                for p in (short, long, multi))
    assert k_short == (batch.MIN_BUCKET, 1)
    assert k_long[0] > batch.MIN_BUCKET          # longer program ladder
    assert k_multi[1] == 2                       # 2 frontend streams
    futs = [srv.submit(p) for p in (short, long, multi, short)]
    assert len(srv._open) == 3                   # three open batches
    srv.drain()
    for f in futs:
        assert f.result(timeout=0).halted
    rep = srv.report()
    assert set(rep.per_bucket) == {k_short, k_long, k_multi}
    assert rep.per_bucket[k_short].requests == 2


def test_serve_backpressure_queue_full(progs):
    clock = thts.ManualClock()
    srv = thts.serve(max_batch=4, max_queue=4, deadline=0.050, clock=clock,
                     **CPU)
    long = _tiny("long", 40)                     # second bucket
    for p in (progs[0], progs[1], progs[2], long):
        srv.submit(p)                            # neither bucket fills
    assert srv.pending == 4
    # a request that would not complete its batch is refused at the bound
    with pytest.raises(thts.QueueFullError):
        srv.submit(long)                         # 2nd-bucket batch: 2/4
    # one that completes a batch is admitted: it launches inline
    f4 = srv.submit(progs[3])                    # 1st bucket fills: 4/4
    assert f4.done() and f4.result(timeout=0).halted
    assert srv.pending == 1                      # only `long` still queued
    # deadline expiry frees the queue: submit() flushes before admitting
    clock.advance(0.060)
    f = srv.submit(progs[4])
    assert srv.pending == 1 and not f.done()
    srv.drain()
    assert f.result(timeout=0).halted


def test_serve_nonhalting_request_fails_its_future_only(progs):
    srv = thts.serve(max_batch=3, deadline=99.0, max_cycles=300,
                     clock=thts.ManualClock(), **CPU)
    fast = _tiny("fast", 1)                      # halts well inside 300
    f1 = srv.submit(progs[0])                    # needs 2269 cycles
    f2 = srv.submit(fast)
    f3 = srv.submit(progs[1])                    # needs 1761
    assert f1.done() and f2.done() and f3.done()
    for f in (f1, f3):
        with pytest.raises(thts.SimulationError):
            f.result(timeout=0)
    assert f2.result(timeout=0).halted
    assert srv.pending == 0


def test_serve_close_and_validation(progs):
    srv = thts.serve(max_batch=4, deadline=99.0, clock=thts.ManualClock(),
                     **CPU)
    f = srv.submit(progs[0])
    srv.close()                                  # flushes
    assert f.done()
    with pytest.raises(RuntimeError):
        srv.submit(progs[0])
    with pytest.raises(ValueError):
        thts.serve(max_batch=0, **CPU)
    with pytest.raises(ValueError):
        thts.serve(max_batch=8, max_queue=4, **CPU)   # queue < one batch
    with pytest.raises(ValueError):
        thts.serve(n_fu=8, max_fu_per_class=4, **CPU)


def test_serve_spec_overrides():
    spec = thts.ServeSpec(max_batch=2, device="cpu")
    srv = thts.serve(spec, deadline=0.5)
    assert srv.spec.max_batch == 2 and srv.spec.deadline == 0.5
    assert dataclasses.is_dataclass(srv.spec)
    assert not hasattr(srv.spec, "step_impl")    # one step in the port
    assert isinstance(api._norm_costs(srv.spec.scheduler).name, str)
    with pytest.raises(ValueError):
        thts.serve(slice_steps=0, **CPU)
    with pytest.raises(ValueError):
        thts.serve(slice_steps="adaptive", **CPU)


def test_serve_submit_prepares_once_and_never_decodes(progs, monkeypatch):
    """Admission is the hot path: one prepare() a submit and no program
    decode (the bucket key reads lengths off the Prepared request)."""
    calls = {"prepare": 0, "decode": 0}
    real_prepare, real_decode = batch.prepare, isa.decode_table
    monkeypatch.setattr(batch, "prepare", lambda p: (
        calls.__setitem__("prepare", calls["prepare"] + 1),
        real_prepare(p))[1])
    monkeypatch.setattr(isa, "decode_table", lambda code: (
        calls.__setitem__("decode", calls["decode"] + 1),
        real_decode(code))[1])
    srv = thts.serve(max_batch=8, deadline=99.0, clock=thts.ManualClock(),
                     **CPU)
    srv.submit(progs[0])                         # queued, no launch
    assert calls == {"prepare": 1, "decode": 0}
    srv.submit(progs[1])
    assert calls == {"prepare": 2, "decode": 0}


@pytest.mark.parametrize("slice_steps", [None, 32])
def test_serve_launch_failure_fails_futures_and_restores_queue(
        progs, monkeypatch, slice_steps):
    """A launch that raises fails its own futures and gives their slots
    back: no hung futures, no shrunken queue."""
    srv = thts.serve(max_batch=4, max_queue=8, deadline=99.0,
                     slice_steps=slice_steps, clock=thts.ManualClock(),
                     **CPU)
    f1 = srv.submit(progs[0])
    f2 = srv.submit(progs[1])

    def boom(*a, **k):
        raise RuntimeError("injected pack failure")

    monkeypatch.setattr(batch, "pack_population", boom)
    with pytest.raises(RuntimeError, match="injected pack failure"):
        srv.drain()
    assert srv.pending == 0                      # accounting restored
    for f in (f1, f2):
        with pytest.raises(RuntimeError, match="injected pack failure"):
            f.result(timeout=0)
    monkeypatch.undo()
    fs = [srv.submit(p) for p in progs]          # still serviceable
    srv.drain()
    assert srv.pending == 0
    assert all(f.result(timeout=0).halted for f in fs)


def test_serve_post_close_raises_everywhere(progs):
    srv = thts.serve(max_batch=4, deadline=99.0, clock=thts.ManualClock(),
                     **CPU)
    f = srv.submit(progs[0])
    srv.close()                                  # flushes
    assert f.done()
    srv.close()                                  # idempotent
    for call in (lambda: srv.submit(progs[0]), srv.poll, srv.drain):
        with pytest.raises(RuntimeError, match="closed"):
            call()


def test_serve_exit_on_exception_aborts_queued_work(progs):
    """Leaving the with-block on an exception cancels queued futures
    instead of launching work nobody will read."""
    with pytest.raises(KeyError):
        with thts.serve(max_batch=4, deadline=99.0,
                        clock=thts.ManualClock(), **CPU) as srv:
            f = srv.submit(progs[0])
            raise KeyError("caller bug")
    assert f.cancelled() and srv.pending == 0
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(progs[0])
    with thts.serve(max_batch=4, deadline=99.0, clock=thts.ManualClock(),
                    **CPU) as srv:
        f = srv.submit(progs[0])
    assert f.result(timeout=0).halted            # normal exit flushes


# ---------------------------------------------------------------------------
# the cache probe: builds and hts_run launches
# ---------------------------------------------------------------------------
@pytest.fixture
def counted_card_route(monkeypatch):
    """A stand-in card route: ``machine._advance`` takes every CPU carry
    for the card's and ``cuda_run.run_slice`` runs the per-phase loop and
    counts one ``hts_run`` launch, as the kernel's wrapper does."""
    real_loop = machine._loop
    monkeypatch.setattr(machine, "_build",
                        type("Card", (), {"on_card": staticmethod(
                            lambda dev: True)}))

    def run_slice(m, st, a, budget):
        cuda_run.LIB.launches["run"] += 1
        return real_loop(m, st, a, budget)
    monkeypatch.setattr(cuda_run, "run_slice", run_slice)
    cuda_run.reset_launches()
    yield
    cuda_run.reset_launches()


def test_serve_static_builds_nothing_and_launches_once_a_batch(
        progs, counted_card_route):
    """Once a bucket has launched, three more full batches and a padded
    partial one build nothing and launch ``hts_run`` once each."""
    spec = thts.ServeSpec(max_batch=3, max_queue=32, deadline=99.0,
                          max_cycles=4_999_999, device="cpu")
    srv = thts.serve(spec, clock=thts.ManualClock())
    assert srv.cache_info() == thts.CacheInfo(0, 0, 0, 0, 0)
    [srv.submit(p) for p in progs[:3]]           # warm the bucket
    warm = srv.cache_info()
    assert (warm.misses, warm.entries, warm.launches) == (1, 1, 1)
    for _ in range(3):                           # full batches
        fs = [srv.submit(p) for p in progs[3:6]]
        assert all(f.done() for f in fs)
    srv.submit(progs[0])                         # plus a padded partial
    srv.drain()
    after = srv.cache_info()
    assert after.builds == warm.builds == 0
    assert after.launches - warm.launches == 4 == after.hits
    assert after.misses == 1
    assert srv.report().batches == after.launches


def test_serve_sliced_builds_nothing_and_launches_once_a_slice(
        progs, counted_card_route):
    """The probe across refills and adaptive budgets: one launch a slice,
    nothing built after the first launch."""
    spec = thts.ServeSpec(max_batch=3, max_queue=32, deadline=99.0,
                          slice_steps="auto", max_cycles=4_999_998,
                          device="cpu")
    srv = thts.serve(spec, clock=thts.ManualClock())
    [srv.submit(p) for p in progs[:3]]
    srv.drain()
    warm = srv.cache_info()
    assert (warm.misses, warm.entries) == (1, 1)
    for wave in (progs[3:6], progs[:4], progs[1:6]):
        fs = [srv.submit(p) for p in wave]
        srv.drain()
        assert all(f.done() for f in fs)
    after = srv.cache_info()
    (b,) = srv.report().per_bucket.values()
    assert after.builds == warm.builds == 0 and after.misses == 1
    assert after.launches == b.slices > warm.launches
    assert b.budgets[0] == AUTO_SLICE_STEPS


# ---------------------------------------------------------------------------
# slice-and-refill
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def jax_fuzz():
    """The JAX package's ``run_many`` over each fuzz configuration."""
    return {True: jhts.run_many(_fuzz_progs(jworkloads, FUZZ_SKIP)),
            False: jhts.run_many(_fuzz_progs(jworkloads, FUZZ_NOSKIP),
                                 event_skip=False)}


@pytest.mark.parametrize("event_skip,max_batch", [(True, 4), (False, 2)],
                         ids=["skip", "noskip"])
def test_serve_sliced_refill_differential_fuzz(jax_fuzz, event_skip,
                                               max_batch):
    """Slice-and-refill serving returns each request's result as the JAX
    package's ``run_many`` does on the same seeds: merged and
    multi-frontend scenarios, a queue deeper than the lane width so
    batches refill mid-flight."""
    seeds = FUZZ_SKIP if event_skip else FUZZ_NOSKIP
    got, srv = _serve_all(_fuzz_progs(workloads, seeds), max_batch=max_batch,
                          max_queue=64, deadline=99.0, event_skip=event_skip,
                          slice_steps=24)
    for i, r in enumerate(got):
        _same(r, jax_fuzz[event_skip], i)
    rep = srv.report()
    assert rep.requests == len(seeds)
    assert all(b.occupancy > 0.5 and b.slices > 1
               for b in rep.per_bucket.values())


def test_serve_sliced_auto_matches_static(progs, port_ref, jax_ref):
    """``slice_steps="auto"``: the first slice at AUTO_SLICE_STEPS, then
    sized from measured steps; results equal the static path's."""
    got, srv = _serve_all(progs, max_batch=2, max_queue=16, deadline=99.0,
                          slice_steps="auto")
    for i, r in enumerate(got):
        assert r.schedule_tuple() == port_ref[i].schedule_tuple()
        _same(r, jax_ref, i)


def test_serve_sliced_heterogeneous_cost_tables():
    """A server whose ``params.fu_cost`` marks unit 0 of two classes slow,
    fed a queue deeper than its lanes, half the requests on the eft
    arbiter: every sliced result equals the JAX package's."""
    jparams = jhts.HtsParams(fu_cost=HETERO_FU_COST)
    from repro.core.hts.programs import Bench as JBench
    jref = jhts.run_many(_hetero_progs(jworkloads, JBench,
                                       jhts.SchedPolicy), params=jparams)
    params = thts.HtsParams(fu_cost=HETERO_FU_COST)
    got, _srv = _serve_all(_hetero_progs(workloads, Bench,
                                         thts.SchedPolicy), max_batch=3,
                           max_queue=64, deadline=99.0, params=params,
                           slice_steps=16)
    for i, r in enumerate(got):
        _same(r, jref, i)


@pytest.mark.parametrize("slice_steps", [None, 16], ids=["static", "sliced"])
@pytest.mark.parametrize("devices", [1, 2, 3])
def test_serve_devices_matches_unsharded(progs, port_ref, jax_ref, devices,
                                         slice_steps):
    """Lanes over 1, 2 and 3 shards (four lanes: padded to 4 or 6), static
    and sliced with refills: the results of ``devices=None``, which are
    the JAX package's."""
    got, srv = _serve_all(progs, max_batch=4, max_queue=16, deadline=99.0,
                          devices=devices, slice_steps=slice_steps)
    assert srv._lanes == -(-4 // devices) * devices
    for i, r in enumerate(got):
        assert r.schedule_tuple() == port_ref[i].schedule_tuple()
        _same(r, jax_ref, i)


def test_a_refilled_lane_and_an_old_lane_pause_at_their_own_limits():
    """Per-lane limits are ``steps + budget`` at entry: a lane refilled at
    step 0 beside one at step 30 advances by the same budget, and both
    finish as they would alone."""
    progs = [_scenario(workloads, s) for s in (39, 31, 32)]   # 53, 17, 49
    alone = thts.run_many(progs, **CPU)
    srv = thts.serve(max_batch=2, slice_steps=30, **CPU)
    key = srv.bucket_of(progs[0])
    m = srv._runner(key)
    a = machine.norm_args(m, *srv._pack(progs[:2], key).machine_args())
    st = machine.init_state(m, a.mem_init, a.streams)
    shards = [(m, st, a)]
    shard.advance(shards, 30, count_trips=False)
    assert st["steps"].tolist() == [30, 17] and srv._dead(shards).tolist() \
        == [False, True]
    req = _Request(batch.prepare(progs[2]), "-", 0.0, None)
    srv._refill_rows(shards, 2, key, [1], [req])
    assert st["steps"].tolist() == [30, 0]
    shard.advance(shards, 10, count_trips=False)
    assert st["steps"].tolist() == [40, 10]
    shard.advance(shards, machine.BIG, count_trips=False)
    out = machine.carry_to_numpy(machine.collect(st))
    for lane, i in ((0, 0), (1, 2)):
        assert int(out["steps"][lane]) == int(alone.steps[i])
        assert int(out["cycles"][lane]) == int(alone.cycles[i])
        got = api._machine_result("p", "hts_spec",
                                  tuple(int(x) for x in alone.n_fu[i]),
                                  {k: v[lane] for k, v in out.items()}, 0.0,
                                  alone.policies[i], 4)
        assert got.schedule_tuple() == alone[i].schedule_tuple()


def test_sliced_server_through_the_kernels_source(emulated, monkeypatch,
                                                  progs, port_ref):
    """One sliced server with refills, its slices through ``hts_run``'s
    own source (g++, ``tests/cuda_emu.h``) as the route, against the same
    server on the plain route and against ``run_many``: mid-flight
    splices, per-lane limits and retired pad lanes meet the kernel."""
    spec = dict(max_batch=3, max_queue=16, deadline=99.0, slice_steps=8)
    plain, psrv = _serve_all(progs[:5], **spec)
    monkeypatch.setattr(
        machine, "_advance",
        lambda m, st, a, budget: _launch_emulated(emulated, m, st, a,
                                                  budget))
    got, srv = _serve_all(progs[:5], **spec)
    for i, (r, p) in enumerate(zip(got, plain)):
        assert r.cycles == p.cycles == int(port_ref.cycles[i])
        assert r.schedule_tuple() == p.schedule_tuple() \
            == port_ref[i].schedule_tuple()
        assert r.raw["steps"] == p.raw["steps"]
    (b,) = srv.report().per_bucket.values()
    (pb,) = psrv.report().per_bucket.values()
    assert b.slices == pb.slices > 2
