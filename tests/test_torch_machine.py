"""The torch population machine held against the JAX reference machine.

The same seeded scenarios are generated on both sides (each package's own
``workloads``), packed by each package's ``batch``, and run through
``run_many`` / ``run``; every ``collect`` array must be equal in value,
shape and dtype (the machine is all int32/bool, so the tolerance is zero).
The port runs on the CPU here (``device="cpu"``), where its four kernel
phases take their plain torch versions.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.hts as jhts
from repro.core.hts import api as japi
from repro.core.hts import batch as jbatch
from repro.core.hts import costs as jcosts
from repro.core.hts import machine as jmachine
from repro.core.hts import programs as jprograms
from repro.core.hts import workloads as jworkloads

import repro_torch.core.hts as thts
from repro_torch.core.hts import batch as tbatch
from repro_torch.core.hts import costs as tcosts
from repro_torch.core.hts import machine as tmachine
from repro_torch.core.hts import programs as tprograms
from repro_torch.core.hts import workloads as tworkloads

ROOT = Path(__file__).resolve().parent.parent
CHEAP = dict(kernels=jworkloads.CHEAP_MIX, max_tasks=4)
#: cycle ceiling of the event-skip-off runs: they tick once per cycle, so
#: both machines stop (not halted) at the same cycle and are compared there
NOSKIP_CYCLES = 400


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mixed_population(wl):
    """Every scenario kind in one population: CHEAP_MIX merged programs,
    mixed priorities/quotas/caps, heterogeneous units (seeds 1 and 3 draw
    the eft arbiter), and per-tenant frontends with arrivals.  Returns
    (programs, per-scenario fu_cost)."""
    progs, fu_cost = [], []

    def gen(s, **kw):
        return wl.generate_scenario(s, n_tenants=2 + s % 3, **CHEAP, **kw)

    for s in (1, 3, 5):
        progs.append(gen(s).merged)
        fu_cost.append(None)
    for s in (2, 10):
        progs.append(gen(s, mixed_priority=True).merged)
        fu_cost.append(None)
    for s in (1, 3):
        sc = gen(s, heterogeneous_fus=True)
        assert sc.policy.issue_mode == "eft" and sc.fu_cost is not None
        progs.append(sc.merged)
        fu_cost.append(sc.fu_cost)
    for s in (3, 10):
        progs.append(gen(s, frontends=True, arrivals=True).multi)
        fu_cost.append(None)
    return progs, fu_cost


def assert_outputs_equal(ref: dict, port: dict, ctx: str = "") -> None:
    assert set(ref) == set(port), ctx
    for k in ref:
        a, b = np.asarray(ref[k]), np.asarray(port[k])
        assert a.dtype == b.dtype, f"{ctx} {k}: dtype {a.dtype} vs {b.dtype}"
        assert a.shape == b.shape, f"{ctx} {k}: shape {a.shape} vs {b.shape}"
        assert np.array_equal(a, b), f"{ctx} {k}: values differ"


def test_pack_population_matches_reference():
    """The copied generator and packer give the reference's 11 arrays."""
    jp, jc = mixed_population(jworkloads)
    tp, tc = mixed_population(tworkloads)
    ja = jbatch.pack_population(jp, fu_cost=jc).machine_args()
    ta = tbatch.pack_population(tp, fu_cost=tc).machine_args()
    assert len(ja) == len(ta) == 11
    for a, b in zip(ja, ta):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("event_skip", [True, False], ids=["skip", "noskip"])
@pytest.mark.parametrize("scheduler", jcosts.ALL_SCHEDULERS)
def test_run_many_matches_jax(scheduler, event_skip):
    kw = dict(scheduler=scheduler, event_skip=event_skip, check=event_skip,
              max_cycles=5_000_000 if event_skip else NOSKIP_CYCLES)
    jp, jc = mixed_population(jworkloads)
    tp, tc = mixed_population(tworkloads)
    ref = jhts.run_many(jp, fu_cost=jc, **kw)
    port = thts.run_many(tp, fu_cost=tc, device="cpu", **kw)
    assert_outputs_equal(ref.raw, port.raw, f"{scheduler} skip={event_skip}")
    assert port.backend == "torch"
    assert port.trips >= int(port.steps.max())
    for i in range(len(port)):
        assert port[i].schedule_tuple() == ref[i].schedule_tuple()
        assert port[i].fe_stall == ref[i].fe_stall


@pytest.mark.parametrize("scheduler", ["naive", "hts_spec"])
def test_run_matches_jax_and_golden_on_benches(scheduler):
    for jb, tb in zip(jprograms.all_benches(), tprograms.all_benches()):
        ref = jhts.run(jb, scheduler=scheduler)
        port = thts.run(tb, scheduler=scheduler, device="cpu")
        gold = thts.run(tb, scheduler=scheduler, backend="golden")
        assert_outputs_equal(ref.raw, port.raw, tb.name)
        assert port.cycles == gold.cycles, tb.name
        assert port.schedule_tuple() == gold.schedule_tuple(), tb.name
        assert port.fu_busy_cycles == gold.fu_busy_cycles, tb.name


def test_compare_golden_event_skip_on_and_off():
    """``compare`` holds the torch machine to golden in both modes."""
    p = thts.Program("pair")
    x = p.input(0x10, 4)
    y = p.task("vector_dot", in_=x, out=2)
    p.task("vector_add", in_=y, out=2)
    rep = thts.compare(p, schedulers=("hts_nospec", "hts_spec"),
                       device="cpu")
    assert rep.n_modes == 3 and set(rep.results) == {"hts_nospec",
                                                     "hts_spec"}
    with pytest.raises(TypeError, match="one program"):
        thts.compare([p, p], device="cpu")


@pytest.mark.parametrize("budget", [1, 7, 64])
def test_slices_compose_with_run_to_completion(budget):
    progs, fu_cost = mixed_population(tworkloads)
    pop = tbatch.pack_population(progs[:6], fu_cost=fu_cost[:6])
    spec = tmachine.MachineSpec(params=pop.params,
                                costs=tcosts.costs_by_name("hts_spec"),
                                max_fu_per_class=4)
    m = tmachine.make_machine(spec, pop.max_prog, "cpu")
    args = pop.machine_args()
    full = tmachine.carry_to_numpy(m.run(*args))
    carry = m.init(*args)
    fresh = tmachine.carry_to_numpy(carry)
    first = m.run_slice(carry, *args, budget=budget)
    # the argument carry is left as it was (the kernels write in place)
    assert_outputs_equal(fresh, tmachine.carry_to_numpy(carry), "argument")
    carry = first
    while bool((~carry["halted"] & ~carry["overflow"]).any()):
        assert int(carry["steps"].max()) <= int(full["steps"].max())
        carry = m.run_slice(carry, *args, budget=budget)
    assert_outputs_equal(full, tmachine.carry_to_numpy(m.collect(carry)),
                         f"budget {budget}")


def test_reference_carry_resumes_in_port():
    """A JAX carry stopped after two slices, carried across, and finished
    by the port equals the JAX run to completion."""
    jp, jc = mixed_population(jworkloads)
    pop = jbatch.pack_population(jp, fu_cost=jc)
    spec = jmachine.MachineSpec(params=pop.params,
                                costs=jcosts.costs_by_name("hts_spec"),
                                max_fu_per_class=4)
    rm = japi._population_slicer(spec, pop.max_prog)
    jargs = [jnp.asarray(a) for a in pop.machine_args()]
    carry = rm.init(*jargs)
    for _ in range(2):
        carry = rm.run_slice(carry, *jargs, jnp.asarray(5, jnp.int32))
    ref = jhts.run_many(pop, scheduler="hts_spec")

    tspec = tmachine.MachineSpec(params=pop.params,
                                 costs=tcosts.costs_by_name("hts_spec"),
                                 max_fu_per_class=4)
    m = tmachine.make_machine(tspec, pop.max_prog, "cpu")
    tcarry = tmachine.carry_from_reference(
        {k: np.asarray(v) for k, v in carry.items()}, "cpu")
    assert set(tcarry) == set(m.init(*pop.machine_args()))
    targs = tmachine.args_from_reference(pop.machine_args(), "cpu")
    out = m.collect(m.run_slice(tcarry, *targs, budget=tmachine.BIG))
    assert_outputs_equal(ref.raw, tmachine.carry_to_numpy(out), "resumed")
    back = tmachine.carry_to_numpy(tcarry)
    for k, v in carry.items():
        assert back[k].dtype == np.asarray(v).dtype, k


def test_port_imports_no_jax_and_nothing_of_reference():
    """Every module of the port imports with jax blocked, and leaves no
    ``repro`` module behind."""
    code = "\n".join([
        "import importlib, pkgutil, sys",
        "class Block:",
        "    def find_spec(self, name, path=None, target=None):",
        "        if name.split('.')[0] in ('jax', 'jaxlib'):",
        "            raise ImportError('blocked ' + name)",
        "sys.meta_path.insert(0, Block())",
        "import repro_torch",
        "for mod in pkgutil.walk_packages(repro_torch.__path__,",
        "                                 'repro_torch.'):",
        "    importlib.import_module(mod.name)",
        "bad = [m for m in sys.modules if m.split('.')[0]",
        "       in ('repro', 'jax', 'jaxlib')]",
        "assert not bad, bad",
        "assert 'repro_torch.core.hts.api' in sys.modules",
    ])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p = thts.Program("one")
    p.task("vector_dot", in_=p.input(0x10, 4), out=1)
    with pytest.raises(RuntimeError, match="cuda"):
        thts.run(p)
    with pytest.raises(RuntimeError, match="cuda"):
        thts.run_many([p, p])
    with pytest.raises(RuntimeError, match="cuda"):
        thts.compare(p)
    with pytest.raises(RuntimeError, match="cuda"):
        tmachine.make_machine(tmachine.MachineSpec(
            costs=tcosts.costs_by_name("hts_spec")))
    assert thts.run(p, device="cpu").halted


@pytest.mark.slow
@pytest.mark.parametrize("scheduler", ["naive", "hts_spec"])
def test_run_many_matches_jax_fuzz(scheduler):
    """Wider seed sweep over every scenario kind (slow tier)."""
    for kind in ({}, dict(mixed_priority=True),
                 dict(heterogeneous_fus=True),
                 dict(frontends=True, arrivals=True)):
        sides = []
        for wl, run_many, extra in ((jworkloads, jhts.run_many, {}),
                                    (tworkloads, thts.run_many,
                                     dict(device="cpu"))):
            scs = [wl.generate_scenario(s, n_tenants=2 + s % 3, **CHEAP,
                                        **kind) for s in range(1, 13)]
            progs = [sc.multi if sc.multi is not None else sc.merged
                     for sc in scs]
            sides.append(run_many(progs, scheduler=scheduler,
                                  fu_cost=[sc.fu_cost for sc in scs],
                                  **extra))
        assert_outputs_equal(sides[0].raw, sides[1].raw, f"{kind}")
