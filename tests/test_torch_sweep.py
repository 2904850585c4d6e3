"""The port's ``sweep`` and ``compare_population`` held against the JAX
package and the golden oracle, on the CPU.

``sweep`` runs one population machine per scheduler, one lane per (program,
FU point); its cycles must equal the golden oracle's ``run`` at each point
and one JAX ``sweep`` call (the vmapped reference machine).
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core.hts as jhts
from repro.core.hts import programs as jprograms

from repro_torch.core import hts as thts
from repro_torch.core.hts import api as tapi
from repro_torch.core.hts import programs as tprograms

POINTS = (1, 2, 4)
SCHEDULERS = ("naive", "hts_spec")


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_sweep_matches_golden_and_the_jax_sweep():
    sw = thts.sweep(tprograms.no_dependency(), n_fu=POINTS,
                    schedulers=SCHEDULERS, device="cpu")
    assert sw.n_fu_list == tuple((k,) * 10 for k in POINTS)
    assert sw.schedulers == SCHEDULERS and not sw.is_population
    for s in SCHEDULERS:
        gold = [thts.run(tprograms.no_dependency(), scheduler=s, n_fu=k,
                         backend="golden").cycles for k in POINTS]
        assert sw.cycles[s].tolist() == gold, s
    ref = jhts.sweep(jprograms.no_dependency(), n_fu=POINTS,
                     schedulers=SCHEDULERS)
    for s in SCHEDULERS:
        assert np.array_equal(sw.cycles[s], np.asarray(ref.cycles[s])), s
    np.testing.assert_array_equal(sw.speedup("hts_spec", "naive"),
                                  ref.speedup("hts_spec", "naive"))


def test_population_sweep_is_scenario_major():
    benches = [g() for g in tprograms.SYNTHETIC_BRANCH]
    sw = thts.sweep(benches, n_fu=(1, 2), schedulers=("hts_spec",),
                    device="cpu")
    cyc = sw.cycles["hts_spec"]
    assert cyc.shape == (3, 2) and sw.is_population
    assert sw.programs == tuple(b.name for b in benches)
    for s, b in enumerate(benches):
        for i, k in enumerate((1, 2)):
            g = thts.run(b, scheduler="hts_spec", n_fu=k, backend="golden")
            assert int(cyc[s, i]) == g.cycles, (b.name, k)
    assert "3 scenarios" in sw.table()


def test_sweep_names_the_points_that_did_not_halt():
    with pytest.raises(thts.SimulationError, match=r"no_dependency @ \(1,"):
        thts.sweep(tprograms.no_dependency(), n_fu=(1,),
                   schedulers=("hts_spec",), max_cycles=100, device="cpu")


def test_sweep_and_compare_population_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        thts.sweep(tprograms.no_dependency(), n_fu=(1,))
    with pytest.raises(RuntimeError, match="cuda"):
        thts.compare_population([tprograms.no_dependency()])


def _pair(name, second):
    """Two short tasks (the event-skip-off runs tick every cycle)."""
    p = thts.Program(name)
    x = p.input(0x10, 4)
    y = p.task("vector_dot", in_=x, out=2)
    p.task(second, in_=y, out=2)
    return p


def test_compare_population_passes_and_names_a_mismatch(monkeypatch):
    progs = [_pair("a", "vector_add"), _pair("b", "vector_max")]
    rep = thts.compare_population(progs, schedulers=("naive", "hts_spec"),
                                  device="cpu")
    assert len(rep) == 2 and rep.n_modes == 3
    for s in ("naive", "hts_spec"):
        assert rep.cycles[s].tolist() == [
            thts.run(p, scheduler=s, backend="golden").cycles for p in progs]

    golden_run = tapi.golden.run

    def off_by_one(*a, **k):
        g = golden_run(*a, **k)
        return dataclasses.replace(g, cycles=g.cycles + 1)

    monkeypatch.setattr(tapi.golden, "run", off_by_one)
    with pytest.raises(thts.MismatchError,
                       match=r"scenario 0 \('a'\) under 'hts_spec': torch "
                             r"event_skip=on"):
        thts.compare_population(progs, schedulers=("hts_spec",),
                                device="cpu")


def test_compare_on_a_sequence_delegates_to_compare_population():
    """``compare`` handed a sequence of programs returns what the
    reference's does: a population report with the same fields and the
    same per-scheduler cycles."""
    names = ("no_dependency", "random_dependency")
    args = {"no_dependency": (1,), "random_dependency": (2,)}
    scheds = ("naive", "hts_spec")
    want = jhts.compare([getattr(jprograms, n)(*args[n]) for n in names],
                        schedulers=scheds)
    got = thts.compare([getattr(tprograms, n)(*args[n]) for n in names],
                       schedulers=scheds, device="cpu")
    assert type(got).__name__ == type(want).__name__ == \
        "PopulationCompareReport"
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.names == want.names == names
    assert got.schedulers == want.schedulers == scheds
    assert got.n_modes == want.n_modes == 3 and len(got) == 2
    for s in scheds:
        assert got.cycles[s].tolist() == np.asarray(want.cycles[s]).tolist()
