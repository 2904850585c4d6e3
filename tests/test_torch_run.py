"""The persistent step loop (``cuda_run``, ``csrc/hts_run.cu``) on the CPU.

``hts_run`` runs on the card (``tests/test_torch_cuda.py`` holds it against
the per-phase loop there).  Here: the carry's key order and shapes the
kernel is written against, the shared-memory layout the wrapper hands it,
the specs it refuses, its plain route (the per-phase loop) against the JAX
machine, ``trips`` as the largest number of steps any lane advanced, and
the kernel's own source, compiled with g++ against ``tests/cuda_emu.h``
(a block as its threads, warp collectives through a barrier) and launched
through the wrapper's packing, against the per-phase loop: equal on every
carry array.  The emulation shows the kernel's logic, not what the card
makes of it.
"""
import ctypes
import dataclasses
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core.hts import api as japi
from repro.core.hts import batch as jbatch
from repro.core.hts import costs as jcosts
from repro.core.hts import machine as jmachine
from repro.core.hts import workloads as jworkloads

import repro_torch.core.hts as thts
from repro_torch.core.hts import HtsParams, cuda_run, machine, programs
from repro_torch.core.hts import batch as tbatch
from repro_torch.core.hts import costs as tcosts
from repro_torch.core.hts import workloads as tworkloads

CHEAP = dict(kernels=jworkloads.CHEAP_MIX, max_tasks=4)
#: the main path's machine (``run_many``: max(4, widest) units a class) and
#: Fig 10's (16 units a class, its capacities)
MAIN = (HtsParams(), 4)
FIG10 = (HtsParams(max_tasks=256, mem_words=2048, tracker_entries=256,
                   rs_entries=64), 16)
SOURCE = cuda_run.SOURCE.read_text()
#: hts_spec issuing one entry a cycle and granting two broadcasts: the
#: issue-width cap and K2's second grant bind every few cycles
NARROW = dataclasses.replace(tcosts.costs_by_name("hts_spec"),
                             issue_width=1, cdb_width=2)
#: launches the kernel of ``hts_run.cu`` block after block, each block's
#: threads as std::threads (``tests/cuda_emu.h``)
EMU_RUNNER = r"""
#include <memory>
#include <thread>
#include <vector>
extern "C" int emu_hts_run(const int* dims, int ndims, void* const* ptrs) {
  if (ndims != (int)(sizeof(Dims) / sizeof(int))) return 1;
  Dims d;
  memcpy(&d, dims, sizeof(Dims));
  for (int b = 0; b < d.n; ++b) {
    std::vector<unsigned char> sm(d.smem_bytes);
    std::barrier<> block(THREADS);
    std::vector<std::unique_ptr<std::barrier<>>> bars;
    std::vector<EmuWarp> warps(THREADS / 32);
    for (int w = 0; w < THREADS / 32; ++w) {
      bars.push_back(std::make_unique<std::barrier<>>(32));
      warps[w].bar = bars[w].get();
    }
    std::vector<std::thread> threads;
    for (unsigned t = 0; t < (unsigned)THREADS; ++t)
      threads.emplace_back([&, t] {
        threadIdx = {t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        emu_warp = &warps[t / 32];
        emu_block = &block;
        emu_shared = sm.data();
        hts_run_kernel(d, ptrs);
      });
    for (auto& th : threads) th.join();
  }
  return 0;
}
"""


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _machine(params, wc, scheduler="hts_spec", max_prog=64):
    costs = (scheduler if isinstance(scheduler, tcosts.SchedulerCosts)
             else tcosts.costs_by_name(scheduler))
    spec = machine.MachineSpec(params=params, costs=costs,
                               max_fu_per_class=wc)
    return machine.make_machine(spec, max_prog, "cpu")


def _population(wl, n=6):
    scs = [wl.generate_scenario(s, n_tenants=2 + s % 3, **CHEAP,
                                **kind)
           for s, kind in zip(range(1, n + 1), [
               {}, dict(mixed_priority=True), dict(heterogeneous_fus=True),
               dict(frontends=True, arrivals=True)] * n)]
    progs = [sc.multi if sc.multi is not None else sc.merged for sc in scs]
    return progs, [sc.fu_cost for sc in scs]


def _enum(name):
    body = re.search(rf"enum {name} \{{(.*?)\}};", SOURCE, re.S).group(1)
    return [w.strip() for w in body.replace("\n", " ").split(",")
            if w.strip()]


@pytest.mark.parametrize("params,wc", [MAIN, FIG10], ids=["main", "fig10"])
@pytest.mark.parametrize("streams", [1, 3])
def test_carry_keys_cover_init_state_once(params, wc, streams):
    m = _machine(params, wc)
    st = machine.init_state(
        m, torch.zeros((2, m.M), dtype=torch.int32),
        torch.zeros((2, streams, 4), dtype=torch.int32))
    assert tuple(st) == cuda_run.CARRY_KEYS
    assert len(set(cuda_run.CARRY_KEYS)) == len(cuda_run.CARRY_KEYS)
    spec = m.carry_spec(streams)
    assert tuple(spec) == tuple(st)
    for k, v in st.items():
        assert spec[k] == (v.dtype, tuple(v.shape[1:])), k


def test_kernel_source_follows_the_wrapper_order():
    """``enum Key``, ``enum Arg`` and ``struct Dims`` in ``hts_run.cu``
    list what the wrapper packs, in its order."""
    assert _enum("Key") == [f"K_{k}" for k in cuda_run.CARRY_KEYS] + [
        "NCARRY"]
    assert _enum("Arg") == [f"A_{k}" for k in cuda_run.ARG_KEYS] + ["NARGS"]
    body = re.search(r"struct Dims \{(.*?)\};", SOURCE, re.S).group(1)
    code = " ".join(line.split("//")[0] for line in body.splitlines())
    head = []
    for decl in code.split(";"):
        decl = decl.strip()
        if decl.startswith("int ") and "[" not in decl:
            head += [w.strip() for w in decl[4:].split(",")]
    assert tuple(head) == cuda_run.HEADER
    assert re.search(rf"MAX_FUNCS = {cuda_run.MAX_FUNCS};", SOURCE)
    assert "int func_cycles[MAX_FUNCS];" in body
    assert "int off[NCARRY];" in body and "int len[NCARRY];" in body
    m = _machine(*MAIN)
    d = cuda_run.dims(m, 3, 2, 10)
    assert d.dtype == torch.int32 and d.device.type == "cpu"
    assert d.numel() == (len(cuda_run.HEADER) + cuda_run.MAX_FUNCS
                         + 3 * len(cuda_run.CARRY_KEYS))
    head = dict(zip(cuda_run.HEADER, d.tolist()))
    assert (head["n"], head["NS"], head["budget"], head["NFU"]) == (3, 2, 10,
                                                                    40)
    assert cuda_run.dims(m, 3, 2, 2**40)[cuda_run.HEADER.index(
        "budget")] == machine.BIG


def _hot_bytes(m, NS):
    """The hot arrays' bytes a lane: int32 rows and every scalar at 4 bytes
    an element, bool rows a byte an element, the CDB's two bool rows as
    bitmaps; the traces stay in device memory."""
    total = 0
    for k, (dtype, shape) in m.carry_spec(NS).items():
        if k.startswith("tr_"):
            continue
        n = shape[0] if shape else 1
        if k in ("cdb_valid", "cdb_spec"):
            total += 4 * -(-n // 32)
        elif dtype == torch.bool and shape:
            total += n
        else:
            total += 4 * n
    return total


@pytest.mark.parametrize("params,wc,NS,want", [MAIN + (8, 21888),
                                               FIG10 + (1, 24464)],
                         ids=["main", "fig10"])
def test_shared_memory_is_the_hot_arrays_bytes(params, wc, NS, want):
    """The main path (8 stream rows) and Fig 10's sweep (one stream)."""
    m = _machine(params, wc)
    lay, scratch, total = cuda_run.layout(m, NS)
    assert total == -(-(_hot_bytes(m, NS) + 4 * m.NFU) // 16) * 16 == want
    assert cuda_run.check_fits(m, NS) == total
    # eight CTAs an SM fit beside each other in its 228 KB (1 KB each
    # reserved), under the 48 KB a launch takes without opting in
    assert total <= 48 * 1024 and 8 * (total + 1024) <= 228 * 1024
    # arrays do not overlap; 4-byte ones are 4-byte aligned; traces stay out
    spans = [(scratch, scratch + 4 * m.NFU)]
    for k, (off, kind, n) in lay.items():
        if kind in (cuda_run.TRACE32, cuda_run.TRACE8):
            assert off == -1 and k.startswith("tr_")
            continue
        size = {cuda_run.ROW8: n, cuda_run.BITS: 4 * -(-n // 32)}.get(
            kind, 4 * n)
        if kind != cuda_run.ROW8:
            assert off % 4 == 0, k
        spans.append((off, off + size))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= total


@pytest.mark.parametrize("change,match", [
    (dict(mem_words=60_000), "shared memory"),
    (dict(rs_entries=65), "rs_entries"),
    (dict(tm_slots=33), "tm_slots"),
])
def test_refuses_a_spec_it_cannot_take(change, match):
    m = _machine(HtsParams(**change), 4)
    with pytest.raises(ValueError, match=match):
        cuda_run.check_fits(m, 1)
    with pytest.raises(ValueError, match="frontend streams"):
        cuda_run.check_fits(_machine(*MAIN), 33)


def test_checks_every_carry_tensor():
    progs, fu_cost = _population(tworkloads, 3)
    pop = tbatch.pack_population(progs, fu_cost=fu_cost)
    m = _machine(pop.params, 4, max_prog=pop.max_prog)
    args = pop.machine_args()
    a = machine.norm_args(m, *args)
    st = m.init(*args)
    assert cuda_run._check_all(m, st, a) == (3, pop.streams.shape[1])
    for k, bad, err in (
            ("cdb_valid", st["cdb_valid"].int(), TypeError),
            ("mem", st["mem"][:, :-1], ValueError),
            ("fu_uid", st["fu_uid"].t().contiguous().t(), ValueError),
            ("regs", st["regs"].repeat(1, 2)[:, ::2], ValueError)):
        broken = dict(st, **{k: bad})
        with pytest.raises(err, match=k):
            cuda_run._check_all(m, broken, a)
    with pytest.raises(ValueError, match="carry keys"):
        cuda_run._check_all(m, {k: v for k, v in st.items()
                                if k != "steps"}, a)


def test_plain_route_launches_nothing_and_matches_the_loop():
    """On the CPU ``Machine.run_slice`` is the per-phase loop, and no
    launch; ``cuda_run.run_slice`` refuses a carry off the card."""
    progs, fu_cost = _population(tworkloads)
    pop = tbatch.pack_population(progs, fu_cost=fu_cost)
    m = _machine(pop.params, 4, max_prog=pop.max_prog)
    args = pop.machine_args()
    a = machine.norm_args(m, *args)
    cuda_run.reset_launches()
    got = m.run_slice(m.init(*args), *args, budget=9)
    want = machine._loop(m, m.init(*args), a, 9)
    assert cuda_run.launches == {"run": 0}
    with pytest.raises(ValueError, match="runs on the card"):
        cuda_run.run_slice(m, m.init(*args), a, 9)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("budgets", [(1, 16), (5, 5, 5)])
def test_slices_match_the_reference_machine(budgets):
    """The port's slices (the plain route) and the JAX machine's, from the
    same scenarios: every carry array equal after each slice."""
    jp, jc = _population(jworkloads)
    tp, tc = _population(tworkloads)
    jpop = jbatch.pack_population(jp, fu_cost=jc)
    tpop = tbatch.pack_population(tp, fu_cost=tc)
    jspec = jmachine.MachineSpec(params=jpop.params,
                                 costs=jcosts.costs_by_name("hts_spec"),
                                 max_fu_per_class=4)
    rm = japi._population_slicer(jspec, jpop.max_prog)
    jargs = [jnp.asarray(x) for x in jpop.machine_args()]
    jcarry = rm.init(*jargs)
    m = _machine(tpop.params, 4, max_prog=tpop.max_prog)
    targs = tpop.machine_args()
    tcarry = m.init(*targs)
    for b in budgets:
        jcarry = rm.run_slice(jcarry, *jargs, jnp.asarray(b, jnp.int32))
        tcarry = m.run_slice(tcarry, *targs, budget=b)
        for k, v in jcarry.items():
            assert np.array_equal(np.asarray(v), tcarry[k].numpy()), (b, k)


def test_trips_is_the_slowest_lanes_steps():
    """``trips`` is the largest number of steps any lane advanced, not the
    host loop's trips rounded up to ``CHECK_EVERY``."""
    progs, fu_cost = _population(tworkloads)
    r = thts.run_many(progs, fu_cost=fu_cost, device="cpu")
    assert r.trips == int(r.steps.max())
    assert r.trips % machine.CHECK_EVERY != 0
    one = thts.run(programs.all_benches()[0], device="cpu")
    assert one.raw["steps"] > 0
    pop = tbatch.pack_population(progs, fu_cost=fu_cost)
    m = _machine(pop.params, 4, max_prog=pop.max_prog)
    args = pop.machine_args()
    carry = m.run_slice(m.init(*args), *args, budget=7)
    m.stats["trips"] = 0
    before = carry["steps"].clone()
    after = m.run_slice(carry, *args, budget=20)
    assert m.stats["trips"] == int((after["steps"] - before).max())


# ---------------------------------------------------------------------------
# the kernel's source under emulation
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """``hts_run.cu``'s kernel built for the CPU: its C entries (which
    launch on the card) are cut off and the runner above takes their
    place."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernel")
    kernel = SOURCE[:SOURCE.index('extern "C" {')]
    swaps = (("#include <cuda_runtime.h>", '#include "cuda_emu.h"'),
             ("extern __shared__ __align__(16) unsigned char smem[];",
              "unsigned char* smem = emu_smem();"))
    for old, new in swaps:
        assert kernel.count(old) == 1, old
        kernel = kernel.replace(old, new)
    out = tmp_path_factory.mktemp("hts_run_emu")
    (out / "emu.cpp").write_text(kernel + EMU_RUNNER)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         f"-I{Path(__file__).parent}", "-o", str(out / "libemu.so"),
         str(out / "emu.cpp")], capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(out / "libemu.so"))
    lib.emu_hts_run.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.c_void_p]
    return lib


def _launch_emulated(lib, m, st, a, budget):
    """``cuda_run.run_slice``'s card route, the launch emulated."""
    n, NS = cuda_run._check_all(m, st, a)
    cuda_run.check_fits(m, NS)
    d = cuda_run.dims(m, n, NS, budget)
    ptrs = cuda_run.pointers(st, a, st["cycle"].device)
    assert lib.emu_hts_run(d.data_ptr(), d.numel(), ptrs.data_ptr()) == 0
    return st


def _main_mix(seeds, params=HtsParams()):
    """chip_smoke's main-path scenario kinds (by seed % 4), ``n_fu=2``."""
    progs, fu_cost = [], []
    for seed in seeds:
        kind = seed % 4
        sc = tworkloads.generate_scenario(
            seed, **[dict(mixed_priority=True),
                     dict(frontends=True, arrivals=True),
                     dict(heterogeneous_fus=True), {}][kind])
        progs.append(sc.multi if kind == 1 else sc.merged)
        fu_cost.append(sc.fu_cost if kind == 2 else None)
    return tbatch.pack_population(progs, n_fu=2, fu_cost=fu_cost,
                                  params=params)


def _emu_case(name):
    """(machine, machine args, budgets) of one emulation case."""
    if name.startswith("mix-"):
        progs, fu_cost = _population(tworkloads)
        pop = tbatch.pack_population(progs, fu_cost=fu_cost)
        return (_machine(pop.params, 4, name[4:], pop.max_prog),
                pop.machine_args(), (1, 2, 16, machine.BIG))
    if name == "noskip":
        progs, fu_cost = _population(tworkloads)
        pop = tbatch.pack_population(progs, fu_cost=fu_cost)
        spec = machine.MachineSpec(params=pop.params,
                                   costs=tcosts.costs_by_name("hts_spec"),
                                   max_fu_per_class=4, event_skip=False,
                                   max_cycles=300)
        return (machine.make_machine(spec, pop.max_prog, "cpu"),
                pop.machine_args(), (7, machine.BIG))
    if name == "fig10":
        params, wc = FIG10
        pop = tbatch.pack_population([programs.audio_compression(8, False)],
                                     params=params, max_prog=64)
        lanes = thts.api._cross_points(pop, [tbatch.norm_n_fu(k)
                                             for k in (2, 16)])
        return (_machine(params, wc, "hts_spec", lanes.max_prog),
                lanes.machine_args(), (5, machine.BIG))
    if name == "narrow":
        pop = tbatch.pack_population(programs.all_benches(), n_fu=4)
        return (_machine(pop.params, 4, NARROW, pop.max_prog),
                pop.machine_args(), (9, machine.BIG))
    pop = _main_mix(range(40, 48), HtsParams(cdb_entries=1))   # overflow
    return (_machine(pop.params, 4, "hts_spec", pop.max_prog),
            pop.machine_args(), (3, machine.BIG))


@pytest.mark.parametrize("case", ["mix-naive", "mix-software",
                                  "mix-hts_nospec", "mix-hts_spec",
                                  "noskip", "fig10", "overflow",
                                  "narrow"])
def test_kernel_source_matches_the_per_phase_loop_under_emulation(emulated,
                                                                   case):
    """Slice after slice from a fresh carry, the emulated ``hts_run`` and
    the per-phase loop leave every carry array equal."""
    m, args, budgets = _emu_case(case)
    a = machine.norm_args(m, *args)
    carry = m.init(*args)
    for budget in budgets:
        got = _launch_emulated(emulated, m, {k: v.clone()
                                             for k, v in carry.items()},
                               a, budget)
        want = machine._loop(m, {k: v.clone() for k, v in carry.items()},
                             a, budget)
        for k in want:
            assert torch.equal(got[k], want[k]), (case, budget, k)
        carry = want
    if case == "overflow":
        assert 0 < int(carry["overflow"].sum()) < len(carry["overflow"])
    else:
        assert bool((carry["halted"] | (carry["cycle"] >= 300)).all())
