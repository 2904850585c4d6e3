"""Card only: the CUDA step kernels against their plain torch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode; the CPU tests hold the plain
versions to the reference).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only torch and the port, so it runs where JAX is not
installed.  The state is int32/bool: tolerance zero.
"""
import pytest
import torch

from repro_torch.core.hts import batch, costs, cuda_step, machine, workloads

pytestmark = pytest.mark.cuda

CHEAP = dict(kernels=workloads.CHEAP_MIX, max_tasks=4)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _population():
    scs = [workloads.generate_scenario(3, n_tenants=2, **CHEAP),
           workloads.generate_scenario(1, n_tenants=3, heterogeneous_fus=True,
                                       **CHEAP),
           workloads.generate_scenario(10, n_tenants=3, frontends=True,
                                       arrivals=True, **CHEAP)]
    progs = [scs[0].merged, scs[1].merged, scs[2].multi]
    pop = batch.pack_population(progs, fu_cost=[None, scs[1].fu_cost, None])
    spec = machine.MachineSpec(params=pop.params,
                               costs=costs.costs_by_name("hts_spec"),
                               max_fu_per_class=4)
    return pop, spec


def test_cuda_machine_matches_cpu_machine(card):
    """The whole population on the card (kernels) equals it on the CPU
    (plain versions), and every kernel launched once per trip."""
    pop, spec = _population()
    args = pop.machine_args()
    cpu = machine.make_machine(spec, pop.max_prog, "cpu")
    ref = cpu.run(*args)
    m = machine.make_machine(spec, pop.max_prog, card)
    cuda_step.reset_launches()
    out = m.run(*args)
    torch.cuda.synchronize()
    assert all(v == m.stats["trips"] for v in cuda_step.launches.values())
    for k in ref:
        assert torch.equal(ref[k], out[k].cpu()), k


@pytest.mark.parametrize("trips", [0, 5, 20])
def test_each_kernel_matches_plain_on_a_carry(card, trips):
    """Each kernel and its plain version on clones of one real carry."""
    pop, spec = _population()
    m = machine.make_machine(spec, pop.max_prog, card)
    args = pop.machine_args()
    carry = m.run_slice(m.init(*args), *args, budget=trips)
    a = machine.norm_args(m, *args)
    st = {k: v.clone() for k, v in carry.items()}
    limit = st["steps"] + 1
    alive = machine.step_top(m, st, a.streams, limit)
    done = machine.fu_exec(m, st, a.exists, a.effects, alive)
    n = alive.shape[0]
    calls = {
        "enqueue": (done, 0),
        "grant": (torch.zeros_like(alive), alive, 1),
        "issue": (a.exists, a.prio, a.quota, a.cost, a.eft, alive, 4),
        "traces": (st["rs_uid"].clone(), st["rs_valid"].clone(),
                   st["fu_uid"].clone(), st["fu_busy"].clone(),
                   st["next_uid"].clone(), torch.ones_like(st["cycle"]),
                   torch.zeros_like(st["cycle"]), torch.ones_like(st["cycle"]),
                   torch.ones(n, dtype=torch.bool, device=card)),
    }
    for name, (wrapper, plain, keys) in cuda_step.KERNELS.items():
        before = cuda_step.launches[name]
        s1 = {k: v.clone() for k, v in st.items()}
        s2 = {k: v.clone() for k, v in st.items()}
        a1 = tuple(x.clone() if torch.is_tensor(x) else x
                   for x in calls[name])
        a2 = tuple(x.clone() if torch.is_tensor(x) else x
                   for x in calls[name])
        wrapper(s1, *a1)
        plain(s2, *a2)
        torch.cuda.synchronize()
        assert cuda_step.launches[name] == before + 1
        for k in st:
            assert torch.equal(s1[k], s2[k]), (name, k)
            if k not in keys:
                assert torch.equal(s1[k], st[k]), (name, k, "not its key")
        for x, y in zip(a1, a2):
            if torch.is_tensor(x):
                assert torch.equal(x, y), name
