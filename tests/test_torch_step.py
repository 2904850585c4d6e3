"""The four kernel phases (``cuda_step``): plain versions against the
reference's Pallas kernels, and the wrappers' routing and checks.  The
CUDA kernels themselves are held against the plain versions on a card, in
``test_torch_cuda.py``.

The reference's Pallas kernels run here as its own tests run them on the
CPU (interpret mode, ``step_impl="pallas"``).  The port's carry must equal
the reference's after every trip, which holds ``enqueue_ref``,
``grant_ref``, ``issue_ref`` and ``traces_ref`` to ``k_enqueue``,
``k_grant``, ``k_issue`` and ``k_traces``.  All state is int32/bool:
tolerance zero.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.hts import api as japi
from repro.core.hts import batch as jbatch
from repro.core.hts import costs as jcosts
from repro.core.hts import machine as jmachine
from repro.core.hts import workloads as jworkloads

from repro_torch.core.hts import batch as tbatch
from repro_torch.core.hts import costs as tcosts
from repro_torch.core.hts import cuda_step
from repro_torch.core.hts import machine as tmachine
from repro_torch.core.hts import workloads as tworkloads

CHEAP = dict(kernels=jworkloads.CHEAP_MIX, max_tasks=4)
HOLD_TRIPS = 24


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def three_lanes(wl):
    """A plain scenario, a heterogeneous-unit one under the eft arbiter,
    and a per-tenant-frontend one with arrivals."""
    a = wl.generate_scenario(3, n_tenants=2, **CHEAP)
    b = wl.generate_scenario(1, n_tenants=3, heterogeneous_fus=True, **CHEAP)
    c = wl.generate_scenario(10, n_tenants=3, frontends=True, arrivals=True,
                             **CHEAP)
    assert b.policy.issue_mode == "eft"
    return [a.merged, b.merged, c.multi], [None, b.fu_cost, None]


def assert_carry_equal(ref: dict, port: dict, ctx: str) -> None:
    assert set(ref) == set(port), ctx
    for k in ref:
        a = np.asarray(ref[k])
        b = port[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, f"{ctx} {k}"
        assert np.array_equal(a, b), f"{ctx}: {k} differs"


@pytest.mark.parametrize("scheduler", ["hts_spec", "naive"])
def test_per_trip_carry_matches_pallas_machine(scheduler):
    """``run_slice(budget=1)`` on both sides, whole carry compared after
    each of the first trips."""
    jp, jc = three_lanes(jworkloads)
    tp, tc = three_lanes(tworkloads)
    jpop = jbatch.pack_population(jp, fu_cost=jc)
    tpop = tbatch.pack_population(tp, fu_cost=tc)
    rm = japi._population_slicer(
        jmachine.MachineSpec(params=jpop.params,
                             costs=jcosts.costs_by_name(scheduler),
                             max_fu_per_class=4, step_impl="pallas"),
        jpop.max_prog)
    m = tmachine.make_machine(
        tmachine.MachineSpec(params=tpop.params,
                             costs=tcosts.costs_by_name(scheduler),
                             max_fu_per_class=4),
        tpop.max_prog, "cpu")
    jargs = [jnp.asarray(a) for a in jpop.machine_args()]
    targs = tpop.machine_args()
    jcarry, tcarry = rm.init(*jargs), m.init(*targs)
    assert_carry_equal(jcarry, tcarry, "init")
    one = jnp.asarray(1, jnp.int32)
    for trip in range(HOLD_TRIPS):
        jcarry = rm.run_slice(jcarry, *jargs, one)
        tcarry = m.run_slice(tcarry, *targs, budget=1)
        assert_carry_equal(jcarry, tcarry, f"{scheduler} trip {trip}")
    # the window reached every kernel phase's effect
    assert (np.asarray(jcarry["tr_issue"]) >= 0).sum() > 0
    assert (np.asarray(jcarry["tr_complete"]) >= 0).sum() > 0


def _mid_run_state(trips=12):
    """A real CPU carry a few trips in, plus the phase inputs of its next
    trip, captured just before K1."""
    tp, tc = three_lanes(tworkloads)
    pop = tbatch.pack_population(tp, fu_cost=tc)
    m = tmachine.make_machine(
        tmachine.MachineSpec(params=pop.params,
                             costs=tcosts.costs_by_name("hts_spec"),
                             max_fu_per_class=4), pop.max_prog, "cpu")
    args = pop.machine_args()
    carry = m.run_slice(m.init(*args), *args, budget=trips)
    a = tmachine.norm_args(m, *args)
    st = {k: v.clone() for k, v in carry.items()}
    limit = st["steps"] + 1
    alive = tmachine.step_top(m, st, a.streams, limit)
    done = tmachine.fu_exec(m, st, a.exists, a.effects, alive)
    return m, a, st, alive, done


def _clone(st):
    return {k: v.clone() for k, v in st.items()}


def test_wrappers_send_cpu_tensors_to_plain_versions():
    """On CPU tensors each wrapper computes exactly its plain version and
    launches nothing."""
    m, a, st, alive, done = _mid_run_state()
    cuda_step.reset_launches()
    s1, s2 = _clone(st), _clone(st)
    cuda_step.enqueue(s1, done, 0)
    cuda_step.enqueue_ref(s2, done, 0)
    fired = torch.zeros_like(alive)
    b1, b2 = fired.clone(), fired.clone()
    cuda_step.grant(s1, b1, alive, 1)
    cuda_step.grant_ref(s2, b2, alive, 1)
    assert torch.equal(b1, b2)
    cuda_step.issue(s1, a.exists, a.prio, a.quota, a.cost, a.eft, alive, 4)
    cuda_step.issue_ref(s2, a.exists, a.prio, a.quota, a.cost, a.eft, alive,
                        4)
    n = alive.shape[0]
    kill = torch.ones_like(s1["rs_valid"])
    fkill = torch.ones_like(s1["fu_busy"])
    tr = (s1["rs_uid"].clone(), kill, s1["fu_uid"].clone(), fkill,
          torch.full((n,), 2, dtype=torch.int32), torch.ones(n, dtype=torch.int32),
          torch.zeros(n, dtype=torch.int32), torch.ones(n, dtype=torch.int32),
          torch.ones(n, dtype=torch.bool))
    cuda_step.traces(s1, *tr)
    cuda_step.traces_ref(s2, *tr)
    for k in st:
        assert torch.equal(s1[k], s2[k]), k
    assert all(v == 0 for v in cuda_step.launches.values())
    # the phases did write their keys on this state
    for k in ("tr_issue", "tr_aborted", "tr_dispatch"):
        assert not torch.equal(s1[k], st[k]), k


def test_wrappers_reject_bad_inputs():
    m, a, st, alive, done = _mid_run_state(trips=2)
    with pytest.raises(TypeError, match="done"):
        cuda_step.enqueue(_clone(st), done.to(torch.int32), 0)
    bad = _clone(st)
    bad["cdb_uid"] = bad["cdb_uid"][:, :-1]
    with pytest.raises(ValueError, match="cdb_uid"):
        cuda_step.enqueue(bad, done, 0)
    bad = _clone(st)
    bad["rs_dep"] = bad["rs_dep"].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        cuda_step.grant(bad, torch.zeros_like(alive), alive, 1)
    with pytest.raises(ValueError, match="cost"):
        cuda_step.issue(_clone(st), a.exists, a.prio, a.quota,
                        a.cost[:, :-1], a.eft, alive, 4)


def test_scatter_and_gather_follow_jax_semantics():
    """The two index hazards: a dropped scatter (index U and beyond writes
    nothing, a negative index wraps once) and a clamped gather."""
    U = 5
    arr = np.full((2, U), -1, np.int32)
    idx = np.array([[1, U], [-1, 7]], np.int32)
    val = np.array([[10, 11], [12, 13]], np.int32)
    ref = np.stack([jnp.asarray(arr[i]).at[jnp.asarray(idx[i])]
                    .set(jnp.asarray(val[i]), mode="drop") for i in range(2)])
    t = torch.from_numpy(arr.copy())
    cuda_step._scatter_drop(t, torch.from_numpy(idx), torch.from_numpy(val),
                            torch.ones(2, 2, dtype=torch.bool))
    assert np.array_equal(t.numpy(), np.asarray(ref))
    x = np.arange(4, dtype=np.int32)[None] * 10
    for i in (5, -1, -9, 2):
        want = int(jnp.asarray(x[0])[jnp.asarray(i)])
        got = int(tmachine.take(torch.from_numpy(x),
                                torch.tensor([i], dtype=torch.int32))[0])
        assert got == want, i


def test_build_paths_are_inside_the_checkout():
    root = cuda_step.SOURCE.parents[3]
    assert cuda_step.SOURCE.exists()
    assert cuda_step.BUILD_DIR == root / "build" / "repro_torch"
