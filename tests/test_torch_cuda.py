"""Card only: the CUDA kernels against their plain torch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode; the CPU tests hold the plain
versions to the reference).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only torch and the port, so it runs where JAX is not
installed.  The step kernels' state is int32/bool: tolerance zero.  The
DSP kernels are float32, held to the reference tests' tolerances (1e-5;
1e-4 for the DCT and K6–K8; 1e-3 for the FFT; ``vector_add`` and
``vector_max`` bit for bit, NaN in the same places), at ragged batches
that leave part of the last block empty (the FFT also at 17 and 1000
frames of 256, 8 frames a block).  K15 and K16 take float32 and
bfloat16: K16 within 1e-5 in float32 and 2e-2 in bfloat16, K15 within
1e-5 and 2e-2, at ragged lengths and every head dim (96 and 112
included), and in bfloat16 at the models' block-aligned lengths (2048,
1024) and a chunk of 100 queries at q_offset 512; head dim 256
(paligemma-3b's, also at its two calls a layer and in its smoke model at
that head dim); head dim 96 at chip_smoke 13a's shapes and 256 at
12a's, each of 256's two bfloat16 instances on its own; phi3-mini-3.8b's smoke model
at head dim 96; head dim 64 at whisper-base's three calls (the encoder's
and the cross attention unmasked, the decoder's causal), and its smoke
model at head dim 64.  The packed decode (``decode_gqa_packed``) against
the float32-cast form it replaces: its products within 1e-5 normwise, a
smoke model's decode logits within 1e-5 (float32) and 2e-2 (bfloat16).  K17
and K18 in float32 within 1e-5 normwise (largest difference over the
largest plain magnitude: their sums run in another order than the plain
version's), in bfloat16 at rtol = atol = 2e-2 (about one output ulp), at
ragged T.  Each smoke model's kernel path (Qwen2, rwkv6, zamba2) within
1e-1 normwise of its plain path (rwkv6 and zamba2 over 8 token draws, or
within a one-ulp witness's spread on the draw); in float32 every smoke
model's (the MoE and VLM families too) within 1e-3, a control failing
it.
"""
import dataclasses
import math
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import hts
from repro_torch.core.hts import (HtsParams, api, batch, costs, cuda_run,
                                  cuda_step, machine, programs, shard,
                                  workloads)
from repro_torch.examples import dsp_pipeline
from repro_torch.kernels import common as dsp
from repro_torch.kernels import dsp_fir, dsp_spectral, dsp_vector, ops, ref
from repro_torch.kernels import attention, mamba2, rmsnorm, rwkv6
from repro_torch.models import layers, registry

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the card check's plain versions, controls)

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
    """The whole population on the card (one ``hts_run`` launch, no K1–K4
    launch) equals it on the CPU (the plain per-phase loop)."""
    pop, spec = _population()
    args = pop.machine_args()
    cpu = machine.make_machine(spec, pop.max_prog, "cpu")
    ref = cpu.run(*args)
    m = machine.make_machine(spec, pop.max_prog, card)
    cuda_step.reset_launches()
    cuda_run.reset_launches()
    out = m.run(*args)
    torch.cuda.synchronize()
    assert cuda_run.launches == {"run": 1}
    assert not any(cuda_step.launches.values()), cuda_step.launches
    assert m.stats["trips"] == int(out["steps"].max())
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


# ---------------------------------------------------------------------------
# hts_run, the persistent step loop, against the per-phase loop on the card
# ---------------------------------------------------------------------------
def _persistent_vs_per_phase(m, args, carry, budget):
    """One ``Machine.run_slice`` (a single ``hts_run`` launch, no K1–K4
    launch) against ``machine._loop`` (the per-phase loop, K1–K4 kernels)
    from the same carry: every carry array equal.  Returns hts_run's."""
    a = machine.norm_args(m, *args)
    cuda_run.reset_launches()
    cuda_step.reset_launches()
    got = m.run_slice(carry, *args, budget=budget)
    torch.cuda.synchronize()
    assert cuda_run.launches == {"run": 1}
    assert not any(cuda_step.launches.values()), cuda_step.launches
    want = machine._loop(m, {k: v.clone() for k, v in carry.items()}, a,
                         budget)
    torch.cuda.synchronize()
    for k in want:
        assert torch.equal(got[k], want[k]), (budget, k)
    return got


def _main_mix(monkeypatch, lanes, params=HtsParams()):
    """The first ``lanes`` scenarios of chip_smoke's main-path population
    (every kind: mixed priority, frontends with arrivals, heterogeneous
    units, plain), on a machine of ``params``."""
    monkeypatch.setattr(chip_smoke, "LANES", lanes)
    _pop, progs, fu_cost = chip_smoke.main_population(workloads, batch)
    pop = batch.pack_population(progs, n_fu=2, fu_cost=fu_cost,
                                params=params)
    spec = machine.MachineSpec(params=pop.params,
                               costs=costs.costs_by_name("hts_spec"),
                               max_fu_per_class=4)
    return pop, spec


@pytest.mark.parametrize("budget", [1, 2, 16, 1000, machine.BIG])
def test_persistent_matches_per_phase_on_the_main_mix(card, monkeypatch,
                                                      budget):
    pop, spec = _main_mix(monkeypatch, 64)
    m = machine.make_machine(spec, pop.max_prog, card)
    args = pop.machine_args()
    got = _persistent_vs_per_phase(m, args, m.init(*args), budget)
    if budget == machine.BIG:
        assert bool(got["halted"].all())


@pytest.mark.parametrize("event_skip", [True, False], ids=["skip", "noskip"])
@pytest.mark.parametrize("scheduler", costs.ALL_SCHEDULERS + ("narrow",))
def test_persistent_matches_per_phase_on_benches(card, scheduler,
                                                 event_skip):
    """Every paper bench, as one population, to completion (event-skip
    off: to a cycle ceiling, one step a cycle).  ``narrow``: four units a
    class, hts_spec issuing one entry a cycle and granting two broadcasts,
    so that the issue-width cap and K2's second grant bind."""
    wide = scheduler == "narrow"
    pop = batch.pack_population(programs.all_benches(),
                                n_fu=4 if wide else 1)
    cost = (dataclasses.replace(costs.costs_by_name("hts_spec"),
                                issue_width=1, cdb_width=2) if wide
            else costs.costs_by_name(scheduler))
    spec = machine.MachineSpec(
        params=pop.params, costs=cost,
        max_fu_per_class=4, event_skip=event_skip,
        max_cycles=5_000_000 if event_skip else 1500)
    m = machine.make_machine(spec, pop.max_prog, card)
    args = pop.machine_args()
    _persistent_vs_per_phase(m, args, m.init(*args), machine.BIG)


@pytest.mark.parametrize("scheduler", ["naive", "hts_spec"])
def test_persistent_matches_per_phase_on_fig10_pool(card, scheduler):
    """Fig 10's pool: 16 units a class (160 units), n_fu 1..16, 64 RS
    entries (two a lane of the arbiter's warp)."""
    params = HtsParams(max_tasks=256, mem_words=2048, tracker_entries=256,
                       rs_entries=64)
    pop = batch.pack_population([programs.audio_compression(8, False)],
                                params=params, max_prog=64)
    lanes = api._cross_points(pop, [batch.norm_n_fu(k)
                                    for k in range(1, 17)])
    spec = machine.MachineSpec(params=params,
                               costs=costs.costs_by_name(scheduler),
                               max_fu_per_class=16)
    m = machine.make_machine(spec, lanes.max_prog, card)
    args = lanes.machine_args()
    _persistent_vs_per_phase(m, args, m.init(*args), machine.BIG)


def test_persistent_matches_per_phase_when_lanes_overflow(card,
                                                          monkeypatch):
    """A one-slot CDB: lanes overflow, and the flags (and every other
    array) are the per-phase loop's."""
    pop, spec = _main_mix(monkeypatch, 64, HtsParams(cdb_entries=1))
    m = machine.make_machine(spec, pop.max_prog, card)
    args = pop.machine_args()
    got = _persistent_vs_per_phase(m, args, m.init(*args), machine.BIG)
    assert 0 < int(got["overflow"].sum()) < 64


def test_persistent_resumes_a_carry_taken_mid_run(card, monkeypatch):
    """A carry the per-phase loop left mid-run, finished by hts_run."""
    pop, spec = _main_mix(monkeypatch, 64)
    m = machine.make_machine(spec, pop.max_prog, card)
    args = pop.machine_args()
    carry = machine._loop(m, m.init(*args), machine.norm_args(m, *args), 50)
    got = _persistent_vs_per_phase(m, args, carry, machine.BIG)
    assert bool(got["halted"].all())


def test_persistent_refuses_a_spec_past_shared_memory(card):
    """60000 words of memory do not fit in a CTA's 227 KB: ``hts_run``
    itself raises ValueError before any launch (``Machine.run`` takes the
    per-phase route instead: the tests below)."""
    p = HtsParams(mem_words=60_000)
    pop = batch.pack_population(programs.all_benches()[:2], params=p)
    spec = machine.MachineSpec(params=p, costs=costs.costs_by_name("naive"),
                               max_fu_per_class=4)
    m = machine.make_machine(spec, pop.max_prog, card)
    args = pop.machine_args()
    a = machine.norm_args(m, *args)
    assert not cuda_run.fits(m, pop.streams.shape[1])
    cuda_run.reset_launches()
    with pytest.raises(ValueError, match="shared memory"):
        cuda_run.run_slice(m, m.init(*args), a, machine.BIG)
    assert cuda_run.launches == {"run": 0}


#: specs ``hts_run`` cannot hold: an RS past its 64 entries, a lane state
#: past 227 KB of shared memory
UNFIT = {"rs_entries128": HtsParams(rs_entries=128),
         "past_smem": HtsParams(mem_words=60_000)}


@pytest.mark.parametrize("name", list(UNFIT))
def test_a_spec_hts_run_cannot_hold_takes_the_per_phase_route(card, name):
    """``hts.run`` and ``run_many`` on such a spec equal golden, through
    the per-phase loop with the K1–K4 kernels: the launch counters show
    K1–K4 and no ``hts_run``."""
    p = UNFIT[name]
    progs = programs.all_benches()[:3]
    cuda_run.reset_launches()
    cuda_step.reset_launches()
    one = api.run(progs[0], params=p, device=card)
    many = api.run_many(progs, params=p, device=card)
    assert cuda_run.launches == {"run": 0}
    assert all(n > 0 for n in cuda_step.launches.values()), \
        cuda_step.launches
    for i, prog in enumerate(progs):
        g = api.run(prog, params=p, backend="golden")
        for got in ([one] if i == 0 else []) + [many[i]]:
            assert got.cycles == g.cycles, (name, prog.name)
            assert got.schedule_tuple() == g.schedule_tuple(), prog.name


def test_a_spec_hts_run_holds_takes_one_launch(card):
    """At ``HtsParams()`` a ``run_many`` call is still one ``hts_run``
    launch, and no K1–K4."""
    progs = programs.all_benches()[:3]
    cuda_run.reset_launches()
    cuda_step.reset_launches()
    r = api.run_many(progs, device=card)
    assert cuda_run.launches == {"run": 1}
    assert not any(cuda_step.launches.values()), cuda_step.launches
    for i, prog in enumerate(progs):
        assert r[i].cycles == api.run(prog, backend="golden").cycles


def _frames(card, seed, *shape):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(card)


def _counted(name, fn, *args):
    """Call a DSP wrapper once; it must launch its kernel exactly once."""
    before = dsp.launches[name]
    out = fn(*args)
    torch.cuda.synchronize()
    assert dsp.launches[name] == before + 1, name
    return out


RAGGED = pytest.mark.parametrize("b", [1, 7, 300])
WIDTHS = pytest.mark.parametrize("n", [40, 256])


@RAGGED
@pytest.mark.parametrize("n", [40, 256, 42, 2056])
@pytest.mark.parametrize("k", [5, 8, 12, 33])
def test_real_fir_kernel_matches_plain(card, b, n, k):
    """Rows packed into blocks (40, 256), a row wider than a block (2056),
    the flat path (42 samples; 33 taps), taps in registers (5, 8) or
    shared memory (12)."""
    x, h = _frames(card, b * n, b, n), _frames(card, k, k)
    got = _counted("real_fir", dsp_fir.real_fir, x, h)
    torch.testing.assert_close(got, ref.real_fir(x, h), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,n", [(7, 40), (524288, 40)])
def test_real_fir_kernel_off_16_byte_alignment_and_at_table_ii(card, b, n):
    """x and y 4 bytes off 16-byte alignment take the flat path; Table II's
    524288 frames of 40 the packed one."""
    for off in (1, 0):
        buf = _frames(card, b, b * n + off)
        x = buf[off:].view(b, n)
        y = torch.empty(b * n + off, device=card)[off:].view(b, n)
        h = _frames(card, 8, 8)
        before = dsp.launches["real_fir"]
        dsp.launch("real_fir", b, n, 8, x, h, y)
        torch.cuda.synchronize()
        assert dsp.launches["real_fir"] == before + 1
        torch.testing.assert_close(y, ref.real_fir(x, h), rtol=1e-5,
                                   atol=1e-5)


@RAGGED
@WIDTHS
def test_vector_dot_kernel_matches_plain(card, b, n):
    x, y = _frames(card, b, b, n), _frames(card, b + 1, b, n)
    got = _counted("vector_dot", dsp_vector.vector_dot, x, y)
    torch.testing.assert_close(got, ref.vector_dot(x, y), rtol=1e-5,
                               atol=1e-5)
    # rows 4 bytes past a 16-byte boundary take the scalar loads
    xs = _frames(card, b + 2, b * n + 1)[1:].view(b, n)
    got = _counted("vector_dot", dsp_vector.vector_dot, xs, xs)
    torch.testing.assert_close(got, ref.vector_dot(xs, xs), rtol=1e-5,
                               atol=1e-5)


@RAGGED
@WIDTHS
@pytest.mark.parametrize("lag", [4, 10])
def test_correlation_kernel_matches_plain(card, b, n, lag):
    x, y = _frames(card, b * lag, b, n), _frames(card, b * lag + 1, b, n)
    got = _counted("correlation", dsp_vector.correlation, x, y, lag)
    torch.testing.assert_close(got, ref.correlation(x, y, lag), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("b,n,lag", [
    (262144, 64, 4), (300, 64, 4), (1, 64, 4), (70, 256, 4), (33, 40, 10),
    (130, 128, 10), (3, 1024, 10), (9, 42, 4), (7, 64, 0)])
@pytest.mark.parametrize("alias", [True, False], ids=["y-is-x", "distinct"])
def test_correlation_kernel_routes_match_plain(card, b, n, lag, alias):
    """The image path's call (262144 tiles of 64, lag 4, y the same tensor
    as x) and the packed kernel's other shapes (a thread a row at 64 and
    40 samples, two and four at 128 and 256, lags 4 and 10, ragged last
    blocks), each with y is x and with a distinct y; rows of 1024 at lag
    10 (packed when y is x, flat otherwise), the flat path at 42 samples
    and lag 0."""
    x = _frames(card, b + n + lag, b, n)
    y = x if alias else _frames(card, b + n + lag + 1, b, n)
    got = _counted("correlation", dsp_vector.correlation, x, y, lag)
    torch.testing.assert_close(got, ref.correlation(x, y, lag), rtol=1e-5,
                               atol=1e-5)
    if alias and b == 262144:          # the dispatch entry itself
        entry = ops.dsp_dispatch_table()["correlation"]
        got = _counted("correlation", entry, x)
        want = ops.plain_dispatch_table()["correlation"](x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("alias", [True, False], ids=["y-is-x", "distinct"])
def test_correlation_kernel_off_16_byte_alignment(card, alias):
    """Rows 4 bytes past a 16-byte boundary take the flat path."""
    x = _unaligned(card, 31, 300, 64)
    y = x if alias else _unaligned(card, 32, 300, 64)
    got = _counted("correlation", dsp_vector.correlation, x, y, 4)
    torch.testing.assert_close(got, ref.correlation(x, y, 4), rtol=1e-5,
                               atol=1e-5)


def _unaligned(card, seed, b, n):
    """(b, n) rows 4 bytes past a 16-byte boundary: the scalar loads."""
    return _frames(card, seed, b * n + 1)[1:].view(b, n)


def _same(got, want):
    """Bit for bit, NaN where the plain version has NaN."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@RAGGED
@pytest.mark.parametrize("n", [40, 64, 256])
def test_vector_add_kernel_matches_plain(card, b, n):
    x, y = _frames(card, b + 3, b, n), _frames(card, b + 4, b, n)
    _same(_counted("vector_add", dsp_vector.vector_add, x, y),
          ref.vector_add(x, y))
    _same(_counted("vector_add", dsp_vector.vector_add, x, x), x + x)
    xs = _unaligned(card, b + 5, b, n)
    _same(_counted("vector_add", dsp_vector.vector_add, xs, xs), xs + xs)


@RAGGED
@pytest.mark.parametrize("n", [40, 64, 256])
def test_vector_max_kernel_matches_plain(card, b, n):
    x = _frames(card, b + 6, b, n)
    _same(_counted("vector_max", dsp_vector.vector_max, x),
          ref.vector_max(x))
    xs = _unaligned(card, b + 7, b, n)
    _same(_counted("vector_max", dsp_vector.vector_max, xs),
          ref.vector_max(xs))
    x[b // 2, n // 3] = float("nan")
    got = _counted("vector_max", dsp_vector.vector_max, x)
    assert bool(torch.isnan(got[b // 2]))
    _same(got, ref.vector_max(x))


def _dct_plain(x):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return ref.dct(x)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.parametrize("b", [1, 7, 65, 300, 100003])
@pytest.mark.parametrize("n", [1, 40, 64, 100, 128])
def test_dct_kernel_matches_plain(card, b, n):
    """The persistent kernel: fewer tiles than its grid (b up to 300), and
    many tiles a CTA with a ragged last one (100003 rows); N of 1 and 100
    (not a multiple of 4) take the 4-byte copies."""
    x = _frames(card, b + n, b, n)
    got = _counted("dct", dsp_spectral.dct, x)
    torch.testing.assert_close(got, _dct_plain(x), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n", [40, 64])
def test_dct_kernel_on_rows_off_16_byte_alignment(card, n):
    """x 4 bytes past a 16-byte boundary: the kernel copies 4 bytes at a
    time and gives the same values as on aligned rows."""
    flat = _frames(card, n, 5000 * n + 1)
    x = flat[1:].view(5000, n)
    assert x.data_ptr() % 16 == 4
    got = _counted("dct", dsp_spectral.dct, x)
    torch.testing.assert_close(got, _dct_plain(x), rtol=1e-4, atol=1e-4)
    assert torch.equal(got, dsp_spectral.dct(x.clone()))


@RAGGED
@pytest.mark.parametrize("n", [2, 64, 256, 4096])
def test_fft_kernel_matches_plain(card, b, n):
    x = _frames(card, b + n, b, n, 2)
    got = _counted("fft", dsp_spectral.fft, x)
    torch.testing.assert_close(got, ref.fft(x), rtol=1e-3, atol=1e-3)
    want = torch.fft.fft(torch.view_as_complex(x))
    torch.testing.assert_close(torch.view_as_complex(got), want, rtol=1e-3,
                               atol=1e-3 * max(1.0, n / 256))


@pytest.mark.parametrize("b", [17, 1000])
def test_fft_kernel_matches_plain_over_many_frames_a_block(card, b):
    """At N = 256 a block holds 8 frames of 16 threads: ragged batches that
    leave part of the last block empty, against the plain version and
    torch.fft at the tolerances above."""
    x = _frames(card, b + 11, b, 256, 2)
    got = _counted("fft", dsp_spectral.fft, x)
    torch.testing.assert_close(got, ref.fft(x), rtol=1e-3, atol=1e-3)
    want = torch.fft.fft(torch.view_as_complex(x))
    torch.testing.assert_close(torch.view_as_complex(got), want, rtol=1e-3,
                               atol=1e-3)


@pytest.mark.parametrize("b", [1, 64, 300])
@pytest.mark.parametrize("n,k", [(40, 8), (96, 12)])
def test_complex_fir_kernel_matches_plain(card, b, n, k):
    x, h = _frames(card, b + n, b, n, 2), _frames(card, k, k, 2)
    got = _counted("complex_fir", dsp_fir.complex_fir, x, h)
    torch.testing.assert_close(got, ref.complex_fir(x, h), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("b", [1, 32, 300])
@pytest.mark.parametrize("n,k", [(40, 8), (64, 4), (100, 8), (40, 16),
                                 (100, 3), (20, 33)])
def test_adaptive_fir_kernel_matches_plain(card, b, n, k):
    """K 4 and 8 in registers (packed, flat at 100 samples), any other K
    through the flat kernel's generic instance (16 taps, 3 on rows of
    four chunks, 33 on rows shorter than the filter)."""
    x, d = _frames(card, b + n, b, n), _frames(card, b + n + 1, b, n)
    got = _counted("adaptive_fir", dsp_fir.adaptive_fir, x, d, 0.01, k)
    torch.testing.assert_close(got, ref.adaptive_fir(x, d, 0.01, k),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("b,n,k", [
    (524288, 40, 8), (300, 40, 8), (1, 40, 8), (130, 64, 4), (5, 136, 8),
    (260, 200, 4), (7, 42, 8)])
@pytest.mark.parametrize("alias", [True, False], ids=["d-is-x", "distinct"])
def test_adaptive_fir_kernel_routes_match_plain(card, b, n, k, alias):
    """Table II's 524288 frames of 40 and the packed kernel's other
    shapes (ragged row groups over a persistent grid, rows of 136 and 200
    walked in 64-sample tiles with the weights carried), each with d the
    same tensor as x (the dispatch entry's call) and a distinct d; the
    flat path at 42 samples."""
    x = _frames(card, b + n + k, b, n)
    d = x if alias else _frames(card, b + n + k + 1, b, n)
    got = _counted("adaptive_fir", dsp_fir.adaptive_fir, x, d, 0.01, k)
    torch.testing.assert_close(got, ref.adaptive_fir(x, d, 0.01, k),
                               rtol=1e-4, atol=1e-4)
    if alias and b == 524288:          # the dispatch entry itself
        entry = ops.dsp_dispatch_table()["adaptive_fir"]
        got = _counted("adaptive_fir", entry, x)
        want = ops.plain_dispatch_table()["adaptive_fir"](x)
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("alias", [True, False], ids=["d-is-x", "distinct"])
def test_adaptive_fir_kernel_off_16_byte_alignment(card, alias):
    """x, d 4 bytes past a 16-byte boundary take the flat path, which
    agrees with the packed one bit for bit (the same arithmetic)."""
    x = _unaligned(card, 33, 300, 40)
    d = x if alias else _unaligned(card, 34, 300, 40)
    got = _counted("adaptive_fir", dsp_fir.adaptive_fir, x, d, 0.01, 8)
    torch.testing.assert_close(got, ref.adaptive_fir(x, d, 0.01, 8),
                               rtol=1e-4, atol=1e-4)
    xa = x.clone()                     # 16-byte aligned copies: packed
    da = xa if alias else d.clone()
    packed = _counted("adaptive_fir", dsp_fir.adaptive_fir, xa, da, 0.01, 8)
    assert torch.equal(got, packed)


def _iir_coefficients(card, kb, ka):
    """(b, a) with ``kb`` and ``ka`` coefficients: the dispatch entry's at
    (2, 2), the JAX tests' at (3, 3), else drawn from a seed with
    sum |a[1:]| = 0.9 (a stable filter)."""
    fixed = {(2, 2): ([0.2, 0.3], [1.0, -0.5]),
             (3, 3): ([0.2, 0.3, 0.1], [1.0, -0.4, 0.05])}
    if (kb, ka) in fixed:
        return tuple(torch.tensor(c, device=card) for c in fixed[kb, ka])
    g = torch.Generator().manual_seed(100 * kb + ka)
    b = torch.randn(kb, generator=g) / kb
    a = torch.rand(ka - 1, generator=g) * 2 - 1
    a = torch.cat([torch.ones(1), 0.9 * a / a.abs().sum()])
    return b.to(card), a.to(card)


def _iir_routes(card, x, bc, ac):
    """K8 on ``x`` (16-byte aligned: the packed kernel where N % 4 == 0
    and the filter fits its registers) and on the same frames 4 bytes off
    16-byte alignment (the flat kernel), each call one counted launch."""
    b, n = x.shape
    off = torch.empty(b * n + 1, device=card)[1:].view(b, n)
    off.copy_(x)
    return (_counted("iir", dsp_fir.iir, x, bc, ac),
            _counted("iir", dsp_fir.iir, off, bc, ac))


@pytest.mark.parametrize("b", [1, 33, 300])
@pytest.mark.parametrize("n", [40, 80])
@pytest.mark.parametrize("coef", [([0.2, 0.3, 0.1], [1.0, -0.4, 0.05]),
                                  ([0.2, 0.3], [1.0, -0.5])])
def test_iir_kernel_matches_plain(card, b, n, coef):
    """The packed and the flat kernel on the same frames: each within 1e-4
    of the plain version, and the two equal bit for bit (the same
    arithmetic, each rounding an explicit intrinsic)."""
    x = _frames(card, b * n, b, n)
    bc, ac = (torch.tensor(c, device=card) for c in coef)
    packed, flat = _iir_routes(card, x, bc, ac)
    torch.testing.assert_close(packed, ref.iir(x, bc, ac), rtol=1e-4,
                               atol=1e-4)
    assert torch.equal(packed, flat)


@pytest.mark.parametrize("b,n,taps", [
    (524288, 40, (2, 2)), (300, 40, (1, 2)), (300, 40, (3, 3)),
    (300, 40, (8, 8)), (5, 136, (2, 2)), (260, 200, (3, 3)),
    (7, 42, (3, 3))],
    ids=["table-ii-entry", "300x40-kb1", "300x40-k3", "300x40-k8",
         "row-of-3-tiles", "260x200-k3", "flat-42"])
def test_iir_kernel_routes_agree_bit_for_bit(card, b, n, taps):
    """Table II's 524288 x 40 with the dispatch entry's filter (and the
    entry itself), ragged row groups over the persistent grid, each
    packed instance (2 for first order, else 8, up to (8, 8)), rows
    walked in 64-sample tiles with the histories carried, and N = 42 (flat
    both ways): packed and flat equal bit for bit, both within 1e-4 of the
    plain version."""
    x = _frames(card, b + n, b, n)
    bc, ac = _iir_coefficients(card, *taps)
    packed, flat = _iir_routes(card, x, bc, ac)
    assert torch.equal(packed, flat)
    torch.testing.assert_close(packed, ref.iir(x, bc, ac), rtol=1e-4,
                               atol=1e-4)
    if b == 524288:                    # the dispatch entry itself
        entry = _counted("iir", ops.dsp_dispatch_table()["iir"], x)
        assert torch.equal(entry, packed)


@pytest.mark.parametrize("taps", [(9, 12), (12, 9), (33, 2)])
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
def test_iir_kernel_takes_filters_past_eight_coefficients(card, taps,
                                                          offset):
    """Past 8 coefficients in b or a the flat kernel's generic instance
    runs (on aligned rows too) and matches the plain version within 1e-4
    on frames of three chunks and a ragged row group."""
    b, n = 130, 80
    x = _frames(card, 7 + offset, b * n + offset)[offset:].view(b, n)
    bc, ac = _iir_coefficients(card, *taps)
    got = _counted("iir", dsp_fir.iir, x, bc, ac)
    torch.testing.assert_close(got, ref.iir(x, bc, ac), rtol=1e-4,
                               atol=1e-4)


def test_complex_fir_entry_is_exactly_zero_on_the_card(card):
    x = _frames(card, 11, 300, 40)
    got = _counted("complex_fir", ops.dsp_dispatch_table()["complex_fir"], x)
    assert torch.equal(got, torch.zeros_like(x))


def test_fir_kernels_refuse_what_they_do_not_take(card):
    """K7 takes any K >= 1 but holds at most ``LMS_MAX_TAPS`` weights a
    frame (``min(K, N)``): past that, and for K < 1, the card route raises
    and nothing launches."""
    before = dict(dsp.launches)
    x = _frames(card, 1, 4, 40)
    with pytest.raises(ValueError, match="K must be"):
        dsp_fir.adaptive_fir(x, x, 0.01, 0)
    wide = _frames(card, 2, 1, dsp_fir.LMS_MAX_TAPS + 1)
    with pytest.raises(ValueError, match="weights a frame"):
        dsp_fir.adaptive_fir(wide, wide, 0.01, dsp_fir.LMS_MAX_TAPS + 1)
    assert dsp.launches == before
    got = _counted("adaptive_fir", dsp_fir.adaptive_fir, x, x, 0.01, 5)
    torch.testing.assert_close(got, ref.adaptive_fir(x, x, 0.01, 5),
                               rtol=1e-4, atol=1e-4)


def test_kernels_refuse_sizes_past_their_shared_memory(card):
    """Past a kernel's shared-memory limit the card route raises, and
    nothing launches; the plain versions on the CPU take these sizes."""
    before = dict(dsp.launches)
    n = dsp_vector.CORR_MAX_SPAN
    x = _frames(card, 1, 1, n)
    with pytest.raises(ValueError, match="N \\+ max_lag"):
        dsp_vector.correlation(x, x, 1)
    with pytest.raises(ValueError, match="at most"):
        dsp_spectral.fft(_frames(card, 2, 1, 2 * dsp_spectral.FFT_MAX_N, 2))
    with pytest.raises(ValueError, match="N <= 128"):
        dsp_spectral.dct(_frames(card, 3, 2, dsp_spectral.DCT_MAX_N + 1))
    assert dsp.launches == before


@pytest.mark.parametrize("time_domain", [False, True])
def test_audio_pipeline_on_card_matches_plain(card, time_domain):
    """The schedule on the card runs each DSP kernel once per live task of
    its function, and its output equals the plain table's within 1e-3."""
    bench = programs.audio_compression(2, time_domain)
    x = _frames(card, 5, 300, 256)
    dsp.reset_launches()
    r, executed, out = dsp_pipeline.run_pipeline(bench, x)
    torch.cuda.synchronize()
    counts = dict(dsp.launches)
    live = {}
    for _uid, name in executed:
        kernel = "fft" if name == "fft_256" else name
        live[kernel] = live.get(kernel, 0) + 1
    assert counts == {k: live.get(k, 0) for k in counts}
    plain = dsp_pipeline.execute(dsp_pipeline.issued_tasks(r), x,
                                 ops.plain_dispatch_table())
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out, plain, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("tiles", [6, 40])
def test_image_and_shared_pipelines_on_card_match_plain(card, tiles):
    """The image program alone and merged with the unrolled audio program:
    each DSP kernel launches once per live task of its function, and the
    output equals the plain table's within 1e-3."""
    params = dsp_pipeline.SHARED_PARAMS
    x = _frames(card, 6, 300, 64)
    for bench in (programs.image_compression(tiles),
                  programs.merge_benches([programs.audio_straightline(2),
                                          programs.image_compression(tiles)])):
        dsp.reset_launches()
        r, executed, out = dsp_pipeline.run_pipeline(bench, x, params=params)
        torch.cuda.synchronize()
        counts = dict(dsp.launches)
        live = {k: 0 for k in counts}
        for _uid, name in executed:
            live["fft" if name == "fft_256" else name] += 1
        assert counts == live
        assert live["dct"] == live["vector_max"] == live["vector_add"] == tiles
        plain = dsp_pipeline.execute(dsp_pipeline.issued_tasks(r), x,
                                     ops.plain_dispatch_table())
        assert bool(torch.isfinite(out).all())
        torch.testing.assert_close(out, plain, rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# the transformer's K15 and K16
# ---------------------------------------------------------------------------
TF_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2e-2, 2e-2)}
                                           # (rmsnorm, attention)
def _tf_counted(name, fn, *args, **kw):
    """Call a transformer wrapper once; it must launch its kernel once."""
    lib = dsp.TRANSFORMER_LIB
    before = lib.launches[name]
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    assert lib.launches[name] == before + 1
    return out


@pytest.mark.parametrize("rows", [1, 7, 33, 300])
@pytest.mark.parametrize("d", [32, 100, 1536, 2560, 3584])
@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_rmsnorm_kernel_matches_plain(card, rows, d, dtype):
    """The register path at the models' widths (1536, 2560, 3584: 6, 10,
    14 vectors a lane in bf16) and at 32; the masked scalar path at 100
    (200 bytes a bf16 row, no whole 16-byte vectors)."""
    x = _frames(card, rows * d, rows, d).to(dtype)
    w = _frames(card, d, d).to(dtype)
    got = _tf_counted("rmsnorm", rmsnorm.rmsnorm, x, w, 1e-6)
    tol = TF_TOL[dtype][0]
    torch.testing.assert_close(got, ref.rmsnorm(x, w, 1e-6), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_rmsnorm_kernel_on_rows_off_16_byte_alignment(card, dtype):
    """Rows that start 2 (bf16) or 4 (float32) bytes past a 16-byte
    boundary take the masked scalar path."""
    rows, d = 33, 1536
    buf = _frames(card, 77, rows * d + 1).to(dtype)
    x = buf[1:].view(rows, d)
    assert x.data_ptr() % 16 != 0
    w = _frames(card, 78, d).to(dtype)
    got = _tf_counted("rmsnorm", rmsnorm.rmsnorm, x, w, 1e-6)
    tol = TF_TOL[dtype][0]
    torch.testing.assert_close(got, ref.rmsnorm(x, w, 1e-6), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("tq,tk,q_offset", [(1, 77, 76), (5, 9, 4),
                                            (200, 200, 0), (64, 300, 236),
                                            (1000, 1000, 0)])
@pytest.mark.parametrize("d", [32, 64, 96, 112, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(card, tq, tk, q_offset, d,
                                              causal, dtype):
    """Ragged query and key lengths (no multiple of the kernel's blocks),
    q_offset, every head dim: held against the plain version.  q and k are
    unscaled, so the scores' spread is about 1 and each query attends to a
    few keys: a wrong mask, or probabilities rounded to bfloat16 before
    P·V, lands well outside the float32 tolerance."""
    q = _frames(card, tq + d, 3, tq, d).to(dtype)
    k = _frames(card, tk + d + 1, 3, tk, d).to(dtype)
    v = _frames(card, tk + d + 2, 3, tk, d).to(dtype)
    got = _tf_counted("flash_attention", attention.flash_attention, q, k, v,
                      causal=causal, q_offset=q_offset)
    want = ref.flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=causal, q_offset=q_offset)[:, 0]
    assert bool(torch.isfinite(got).all())
    tol = TF_TOL[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,tq,tk,d,q_offset", [
    (4, 2048, 2048, 128, 0), (4, 1024, 1024, 128, 0),
    (4, 2048, 2048, 112, 0), (4, 1024, 1024, 112, 0),
    (3, 100, 612, 128, 512), (4, 2048, 2048, 256, 0),
    (16, 1792, 2048, 256, 256)])
def test_flash_attention_bf16_kernel_matches_plain_at_full_blocks(
        card, bh, tq, tk, d, q_offset):
    """The bfloat16 kernel at block-aligned model lengths (the prefill's
    2048 and zamba2-7b's 1024, at head dims 128 and 112), causal,
    and at a query length that is not a multiple of 64 with q_offset > 0
    (a chunk appended to a cache): the tolerance of the ragged cases."""
    q = _frames(card, tq + d + 7, bh, tq, d).to(torch.bfloat16)
    k = _frames(card, tk + d + 8, bh, tk, d).to(torch.bfloat16)
    v = _frames(card, tk + d + 9, bh, tk, d).to(torch.bfloat16)
    got = _tf_counted("flash_attention", attention.flash_attention, q, k, v,
                      causal=True, q_offset=q_offset)
    want = ref.flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=True, q_offset=q_offset)[:, 0]
    assert bool(torch.isfinite(got).all())
    tol = TF_TOL[torch.bfloat16][1]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("bh,tq,tk,q_offset", [
    (13, 1, 77, 76), (13, 7, 300, 293), (13, 7, 7, 0), (13, 200, 200, 0),
    (1, 129, 129, 0)])
@pytest.mark.parametrize("d", [112, 128, 256])
def test_flash_attention_bf16_kernel_at_short_and_odd_shapes(
        card, bh, tq, tk, q_offset, d):
    """The tensor-core kernel (a CTA of 128 query rows, 64 a warpgroup;
    at head dim 256 one warpgroup of 64 rows and 64-key stages) at
    decode-like Tq = 1 and Tq = 7, at an odd BH and at query lengths one
    row past a CTA (129) or inside a warpgroup's rows (200), at the
    models' head dims (112 zero-padded to 128)."""
    q = _frames(card, tq + d + 3, bh, tq, d).to(torch.bfloat16)
    k = _frames(card, tk + d + 4, bh, tk, d).to(torch.bfloat16)
    v = _frames(card, tk + d + 5, bh, tk, d).to(torch.bfloat16)
    got = _tf_counted("flash_attention", attention.flash_attention, q, k, v,
                      causal=True, q_offset=q_offset)
    want = ref.flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=True, q_offset=q_offset)[:, 0]
    assert bool(torch.isfinite(got).all())
    tol = TF_TOL[torch.bfloat16][1]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


#: chip_smoke 13a's K15 cases at head dim 96 and 12a's at 256, in bf16
#: (at 256 through the instance the wrapper chooses and through each of
#: its two) and in float32
K15_INSTANCE_CASES = (
    [(shape, torch.bfloat16, None) for shape in chip_smoke.ATTN_96_CASES]
    + [(shape, torch.bfloat16, inst) for shape in chip_smoke.ATTN_256_CASES
       for inst in (None, "one_warpgroup", "two_warpgroups")]
    + [(shape, torch.float32, None) for shape in
       chip_smoke.ATTN_96_CASES + chip_smoke.ATTN_256_CASES])


@pytest.mark.parametrize("shape,dtype,instance", K15_INSTANCE_CASES,
                         ids=lambda x: str(x).replace(" ", ""))
def test_flash_attention_instances_match_plain(card, shape, dtype, instance):
    """Head dim 96 (phi3-mini-3.8b's prefill 128 × 2048², a ragged Tk, a
    chunk at q_offset 1000, Tq = 5) and 256 (paligemma-3b's prefix and
    text calls, a causal square, ragged lengths; each bf16 instance on
    its own): one counted launch, within the tolerance of the ragged
    cases."""
    bh, tq, tk, d, causal, q_offset = shape
    q = _frames(card, tq + d + 11, bh, tq, d).to(dtype)
    k = _frames(card, tk + d + 12, bh, tk, d).to(dtype)
    v = _frames(card, tk + d + 13, bh, tk, d).to(dtype)
    got = _tf_counted("flash_attention", attention.flash_attention, q, k, v,
                      causal=causal, q_offset=q_offset, instance=instance)
    want = ref.flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=causal, q_offset=q_offset)[:, 0]
    assert bool(torch.isfinite(got).all())
    tol = TF_TOL[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_flash_attention_kernel_at_paligemmas_two_calls(card, dtype):
    """paligemma-3b's prefix-LM layer at B = 2 (8 query heads on one KV
    head, repeated): the prefix's 256 queries against its 256 keys,
    bidirectional, and the 1792 text queries against all 2048 keys,
    causal from q_offset 256; one launch each, at head dim 256."""
    q = _frames(card, 31, 16, 2048, 256).to(dtype)
    k = _frames(card, 32, 16, 2048, 256).to(dtype)
    v = _frames(card, 33, 16, 2048, 256).to(dtype)
    P = 256
    for qq, kk, vv, kw in (
            (q[:, :P], k[:, :P], v[:, :P], dict(causal=False)),
            (q[:, P:], k, v, dict(causal=True, q_offset=P))):
        qq, kk, vv = (t.contiguous() for t in (qq, kk, vv))
        got = _tf_counted("flash_attention", attention.flash_attention, qq,
                          kk, vv, **kw)
        want = ref.flash_attention(qq[:, None], kk[:, None], vv[:, None],
                                   **kw)[:, 0]
        assert bool(torch.isfinite(got).all())
        tol = TF_TOL[dtype][1]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


#: whisper-base's three K15 calls at B = 2 (8 heads of 64), (BH, Tq, Tk,
#: causal): the encoder's over its 1500 frames, unmasked; the cross
#: attention, 448 decoder positions on 1500 frames, unmasked; the
#: decoder's causal self-attention over 448
WHISPER_ATTN = [(16, 1500, 1500, False), (16, 448, 1500, False),
                (16, 448, 448, True)]


@pytest.mark.parametrize("bh,tq,tk,causal", WHISPER_ATTN,
                         ids=["encoder", "cross", "decoder"])
@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_flash_attention_kernel_at_whispers_three_calls(card, bh, tq, tk,
                                                       causal, dtype):
    """Head dim 64 (the bfloat16 (64, 2) instance, the float32 CUDA-core
    kernel) at whisper-base's three calls: one launch each, within K15's
    tolerance of the plain version."""
    q = _frames(card, 41 + tq, bh, tq, 64).to(dtype)
    k = _frames(card, 42 + tk, bh, tk, 64).to(dtype)
    v = _frames(card, 43 + tk, bh, tk, 64).to(dtype)
    got = _tf_counted("flash_attention", attention.flash_attention, q, k, v,
                      causal=causal)
    want = ref.flash_attention(q[:, None], k[:, None], v[:, None],
                               causal=causal)[:, 0]
    assert bool(torch.isfinite(got).all())
    tol = TF_TOL[dtype][1]
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


def test_transformer_kernels_refuse_what_they_do_not_take(card):
    q = torch.zeros(2, 8, 48, device=card)
    with pytest.raises(ValueError, match="head dims"):
        attention.flash_attention(q, q, q)
    with pytest.raises(TypeError, match="float64"):
        rmsnorm.rmsnorm(torch.zeros(2, 8, device=card, dtype=torch.float64),
                        torch.zeros(8, device=card, dtype=torch.float64))


#: float32 logits of a smoke model, kernels against plain, normwise: the
#: limit lies between the kernels' readings (at most 4.2e-5, zamba2) and
#: the controls' (at least 0.0157, rwkv6), which must fail it
#: (chip_smoke.py's controls: K15 with its scores rounded to bfloat16;
#: K17/K18 with a bfloat16 state; PERF.md §6)
FP32_SMOKE_TOL = 1e-3


def _swap_plain(monkeypatch, attn=None, rec=None):
    """The model's ops call the plain versions (or the controls ``attn``
    and ``rec``) in place of the K15–K18 wrappers."""
    attn = attn or chip_smoke.plain_attention
    rec = rec or chip_smoke.rec_plain
    monkeypatch.setattr(rmsnorm, "rmsnorm", ref.rmsnorm)
    monkeypatch.setattr(attention, "flash_attention",
                        lambda q, k, v, **kw: attn(ref, q, k, v, **kw))
    monkeypatch.setattr(rwkv6, "wkv6",
                        lambda *a, **kw: rec(ref, "wkv6", a))
    monkeypatch.setattr(mamba2, "ssd", lambda *a, **kw: rec(ref, "ssd", a))


def _normwise(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def test_smoke_model_kernel_path_matches_plain_path(card, monkeypatch):
    """Qwen2-1.5B's smoke config on the card: prefill and decode steps
    launch K15 (once a layer, prefill only) and K16 (twice a layer and
    once more, every call), and the logits agree with the plain ops."""
    m = registry.build_smoke("qwen2-1.5b")
    p = m.init(0)
    tok = torch.randint(0, m.cfg.vocab, (2, 100), device=card)
    lib = dsp.TRANSFORMER_LIB
    lib.reset_launches()
    logits, cache = m.prefill(p, tok, 128)
    step, cache = m.decode_step(p, cache, tok[:, :1], 100)
    torch.cuda.synchronize()
    L = m.cfg.n_layers
    want = {"flash_attention": L, "rmsnorm": 2 * (2 * L + 1), "wkv6": 0,
            "ssd": 0}
    assert lib.launches == want
    # the plain path: ops calls the plain versions in place of the wrappers
    _swap_plain(monkeypatch)
    plain, pcache = m.prefill(p, tok, 128)
    pstep, _ = m.decode_step(p, pcache, tok[:, :1], 100)
    torch.cuda.synchronize()
    assert lib.launches == want
    for got, want in ((logits, plain), (step, pstep)):
        err = _normwise(got, want)
        assert err <= 1e-1, err


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b", "zamba2-7b",
                                  "olmoe-1b-7b", "qwen2-moe-a2.7b",
                                  "paligemma-3b"])
def test_smoke_model_float32_kernel_path_matches_plain_path(card, arch,
                                                            monkeypatch):
    """The smoke models in float32: the logits on the kernels (the
    transformer families: prefill, paligemma's after its 8-position
    prefix, and a decode step; rwkv6, zamba2: forward at a ragged T)
    within FP32_SMOKE_TOL normwise of the plain ops', and a control that
    must fail the same limit: the plain attention with its scores rounded
    to bfloat16 in place of K15 (the transformer families), the plain
    recurrence with a bfloat16 state in place of K17/K18 (rwkv6,
    zamba2)."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    m = registry.build_smoke(arch)
    p = m.init(0)
    # a generator of its own: the card's default one stays as the bf16
    # smoke tests after this one found it
    gen = torch.Generator().manual_seed(0)
    tok = torch.randint(0, m.cfg.vocab, (2, 100), generator=gen).to(card)
    transformer_family = m.cfg.family in ("dense", "moe", "vlm")
    prefix = None
    if m.cfg.prefix_len:
        prefix = torch.randn(2, m.cfg.prefix_len, m.cfg.d_model,
                             generator=gen).to(card)

    def logits():
        if not transformer_family:
            return [m.forward(p, tok)]
        out, cache = m.prefill(p, tok, 128, prefix)
        pos = out.shape[1]
        return [out, m.decode_step(p, cache, tok[:, :1], pos)[0]]

    lib = dsp.TRANSFORMER_LIB
    lib.reset_launches()
    kern = logits()
    torch.cuda.synchronize()
    assert lib.launches["rmsnorm"] > 0 and all(
        x.dtype == torch.float32 for x in kern)
    with monkeypatch.context() as mp:
        _swap_plain(mp)
        plain = logits()
    with monkeypatch.context() as mp:
        if transformer_family:
            _swap_plain(mp, attn=chip_smoke.attention_bf16_scores)
        else:
            _swap_plain(mp, rec=chip_smoke.rec_bf16_state)
        control = logits()
    err = max(_normwise(a, b) for a, b in zip(kern, plain))
    c_err = max(_normwise(a, b) for a, b in zip(control, plain))
    assert err <= FP32_SMOKE_TOL < c_err, (err, c_err)


@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_vlm_at_head_dim_256_runs_its_prefix_lm_attention_on_k15(
        card, dtype, monkeypatch):
    """paligemma-3b's smoke config at its own head dim, 256: a prefill
    after the 8-position prefix makes two K15 launches a layer at head dim
    256 (the prefix bidirectional, the text causal from q_offset 8), a
    decode step none, and the logits agree with the plain path's (float32
    within FP32_SMOKE_TOL, bf16 within 1e-1, normwise)."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", dtype)
    cfg = dataclasses.replace(registry.get_config("paligemma-3b").smoke(),
                              d_head=256)
    m = registry.build(cfg)
    p = m.init(0)
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (2, 100), generator=gen).to(card)
    prefix = torch.randn(2, cfg.prefix_len, cfg.d_model,
                         generator=gen).to(card)
    calls = []
    wrapper = attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append((q.shape[-1], kw.get("causal"), kw.get("q_offset")))
        return wrapper(q, k, v, **kw)

    lib = dsp.TRANSFORMER_LIB
    lib.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(attention, "flash_attention", spy)
        out, cache = m.prefill(p, tok, 128, prefix)
        step, _ = m.decode_step(p, cache, tok[:, :1], out.shape[1])
    torch.cuda.synchronize()
    L = cfg.n_layers
    assert lib.launches["flash_attention"] == 2 * L
    assert calls == [(256, False, 0), (256, True, cfg.prefix_len)] * L
    with monkeypatch.context() as mp:
        _swap_plain(mp)
        plain, pcache = m.prefill(p, tok, 128, prefix)
        pstep, _ = m.decode_step(p, pcache, tok[:, :1], plain.shape[1])
    tol = FP32_SMOKE_TOL if dtype == torch.float32 else 1e-1
    for got, want in ((out, plain), (step, pstep)):
        err = _normwise(got, want)
        assert err <= tol, err


@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_phi3_smoke_at_head_dim_96_runs_k15(card, dtype, monkeypatch):
    """phi3-mini-3.8b's smoke config at its own head dim, 96: a prefill
    launches K15 once a layer at head dim 96, a decode step none, and the
    logits of the prefill and of a decode step agree with the plain
    path's.  float32 at the reference's draw within FP32_SMOKE_TOL, where
    the control (the plain attention with its scores rounded to bfloat16)
    must fail it; bfloat16 within 1e-1 with the weight matrices at
    1/sqrt(their input width) (``chip_smoke.scale_to_width``: at the
    reference's draw the bfloat16 floor of this model is near that limit,
    and says nothing of the kernel)."""
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", dtype)
    cfg = dataclasses.replace(registry.get_config("phi3-mini-3.8b").smoke(),
                              d_head=96)
    m = registry.build(cfg)
    p = m.init(0)
    if dtype == torch.bfloat16:
        chip_smoke.scale_to_width(p["layers"], cfg.n_layers)
    gen = torch.Generator().manual_seed(2)
    tok = torch.randint(0, cfg.vocab, (2, 100), generator=gen).to(card)
    calls = []
    wrapper = attention.flash_attention

    def spy(q, k, v, **kw):
        calls.append(q.shape[-1])
        return wrapper(q, k, v, **kw)

    def logits():
        out, cache = m.prefill(p, tok, 128)
        return [out, m.decode_step(p, cache, tok[:, :1], 100)[0]]

    lib = dsp.TRANSFORMER_LIB
    lib.reset_launches()
    with monkeypatch.context() as mp:
        mp.setattr(attention, "flash_attention", spy)
        kern = logits()
    torch.cuda.synchronize()
    assert lib.launches["flash_attention"] == cfg.n_layers
    assert calls == [96] * cfg.n_layers
    with monkeypatch.context() as mp:
        _swap_plain(mp)
        plain = logits()
    err = max(_normwise(a, b) for a, b in zip(kern, plain))
    if dtype == torch.bfloat16:
        assert err <= 1e-1, err
        return
    with monkeypatch.context() as mp:
        _swap_plain(mp, attn=chip_smoke.attention_bf16_scores)
        control = logits()
    c_err = max(_normwise(a, b) for a, b in zip(control, plain))
    assert err <= FP32_SMOKE_TOL < c_err, (err, c_err)


@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_whisper_smoke_at_head_dim_64_runs_k15(card, dtype, monkeypatch):
    """whisper-base's smoke config at its own head dim, 64: ``forward``
    (frames in) launches K15 once an encoder layer and twice a decoder
    layer (causal self-attention, unmasked cross attention, Tq ≠ Tk) and
    K16 at every norm; then cross K/V from the encoder states and decode
    steps.  The logits agree with the plain path's: float32 within
    FP32_SMOKE_TOL, a control (the plain attention with its scores
    rounded to bfloat16) failing it; bfloat16 within 1e-1 with the weight
    matrices at 1/sqrt(their input width)."""
    from repro_torch.models import whisper
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", dtype)
    cfg = dataclasses.replace(registry.get_config("whisper-base").smoke(),
                              d_head=64)
    m = registry.build(cfg)
    p = m.init(0)
    if dtype == torch.bfloat16:
        for key in ("enc_layers", "dec_layers"):
            chip_smoke.scale_to_width(p[key], len(p[key]))
    gen = torch.Generator().manual_seed(3)
    frames = torch.randn(2, 100, cfg.d_model, generator=gen).to(card)
    tok = torch.randint(0, cfg.vocab, (2, 40), generator=gen).to(card)

    def logits():
        out = [m.forward(p, tok, frames=frames)]
        enc = whisper.encode(p, cfg, frames)
        cache = whisper.fill_cross_cache(p, cfg, m.init_cache(2, 100), enc)
        for t in range(3):
            out.append(m.decode_step(p, cache, tok[:, t:t + 1], t)[0])
        return out

    lib = dsp.TRANSFORMER_LIB
    lib.reset_launches()
    m.forward(p, tok, frames=frames)
    torch.cuda.synchronize()
    E, D = cfg.enc_layers, cfg.n_layers
    assert lib.launches["flash_attention"] == E + 2 * D
    assert lib.launches["rmsnorm"] == (2 * E + 1) + (3 * D + 1)
    kern = logits()
    with monkeypatch.context() as mp:
        _swap_plain(mp)
        plain = logits()
    err = max(_normwise(a, b) for a, b in zip(kern, plain))
    if dtype == torch.bfloat16:
        assert err <= 1e-1, err
        return
    with monkeypatch.context() as mp:
        _swap_plain(mp, attn=chip_smoke.attention_bf16_scores)
        control = logits()
    c_err = max(_normwise(a, b) for a, b in zip(control, plain))
    assert err <= FP32_SMOKE_TOL < c_err, (err, c_err)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.int8])
def test_packed_products_match_the_float32_cast_form(card, cache_dtype):
    """The card's packed decode products (the scores by ``bmm`` with
    ``out_dtype`` float32 on the bfloat16 keys, M = G rows a KV head; P·V
    on the values cast once) against the float32-cast form they replace,
    at Qwen2-1.5B's 32-slot shape (2 KV heads of 128, 6 query heads each,
    512 positions): within 1e-5 normwise (float32 sums in another order).
    An int8 cache is read widened to bfloat16, exactly."""
    N, G, T, D = 64, 6, 512, 128
    q = _frames(card, 51, N, G, D).to(torch.bfloat16)
    if cache_dtype == torch.int8:
        k = (_frames(card, 52, N, T, D) * 40).round().clamp(-127, 127)
        v = (_frames(card, 53, N, T, D) * 40).round().clamp(-127, 127)
        k, v = k.to(torch.int8), v.to(torch.int8)
        s = layers.grouped_scores(q, k.to(torch.bfloat16))
    else:
        k = _frames(card, 52, N, T, D).to(torch.bfloat16)
        v = _frames(card, 53, N, T, D).to(torch.bfloat16)
        s = layers.grouped_scores(q, k)
    want_s = torch.bmm(q.float(), k.float().transpose(1, 2))
    assert s.dtype == torch.float32 and _normwise(s, want_s) <= 1e-5
    w = torch.softmax(want_s * D ** -0.5, dim=-1)
    o = layers.grouped_values(w, v)
    want_o = torch.einsum("ngt,ntd->ngd", w, v.float())
    assert o.dtype == torch.float32 and _normwise(o, want_o) <= 1e-5


@pytest.mark.parametrize("dtype", list(TF_TOL))
def test_packed_decode_matches_the_unpacked_decode_on_the_card(
        card, dtype, monkeypatch):
    """Qwen2-1.5B's smoke config on the card: decode steps at per-lane
    positions with ``decode_gqa_packed`` against the same steps without
    it (the float32-cast, repeated form), the logits within 1e-5
    normwise in float32 and 2e-2 in bfloat16 (the attention output is
    rounded to bfloat16 once, after float32 sums in another order); and
    an int8 rollout at one position runs, its logits finite."""
    from repro_torch.runtime import flags
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", dtype)
    m = registry.build_smoke("qwen2-1.5b")
    p = m.init(0)
    gen = torch.Generator().manual_seed(4)
    tok = torch.randint(0, m.cfg.vocab, (4, 12), generator=gen).to(card)
    out = {}
    for packed in (False, True):
        c = m.init_cache(4, 32)
        with flags.use_flags(decode_gqa_packed=packed):
            out[packed] = [m.decode_step(
                p, c, tok[:, t:t + 1],
                torch.tensor([t, t + 3, t + 9, 2 * t], device=card))[0]
                for t in range(12)]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    err = max(_normwise(a, b) for a, b in zip(out[True], out[False]))
    assert err <= tol, err
    with flags.use_flags(decode_kv_int8=True, decode_gqa_packed=True):
        c = m.init_cache(4, 32)
        assert c["k"].dtype == torch.int8
        for t in range(12):
            lg, c = m.decode_step(p, c, tok[:, t:t + 1], t)
            assert bool(torch.isfinite(lg).all())


# ---------------------------------------------------------------------------
# the recurrences K17 and K18
# ---------------------------------------------------------------------------
REC_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _rec_close(got, want, dtype):
    assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
    if dtype == torch.float32:
        err = (got - want).abs().max() / want.abs().max()
        assert float(err) <= REC_TOL[dtype], float(err)
    else:
        tol = REC_TOL[dtype]
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _model_decays(card, seed, bh, t, kd, dtype):
    """w as rwkv6's time mixing makes it: ``exp(-exp(x))``, x ~ N(0, 2),
    in ``dtype`` (some underflow to 0 and, in bf16, some round to 1), with
    channel 0 exactly 0 and channel 1 exactly 1 in every row, and the last
    row (given two or more) exactly 1 throughout."""
    w = torch.exp(-torch.exp(2.0 * _frames(card, seed, bh, t, kd)))
    w[..., 0], w[..., 1] = 0.0, 1.0
    if bh > 1:
        w[-1] = 1.0
    return w.to(dtype)


@pytest.mark.parametrize("bh,t,kd,vd", [(2, 64, 32, 32), (8, 128, 64, 64),
                                        (1, 96, 64, 128), (3, 1000, 64, 64),
                                        (5, 33, 16, 200), (2, 70, 100, 24),
                                        (3, 1, 64, 64), (2, 129, 64, 64),
                                        (80, 1024, 64, 64)])
@pytest.mark.parametrize("decay", ["drawn", "model"])
@pytest.mark.parametrize("dtype", list(REC_TOL))
def test_wkv6_kernel_matches_plain(card, bh, t, kd, vd, decay, dtype):
    """Ragged T (one step, one past two chunks, no multiple of the
    chunk), a K padded to its register width, V split over CTAs, rwkv6-3b's
    forward rows; w in (0.5, 1) as the JAX test draws it, or as the model
    does (exact 0 and 1 among them).  One counted launch, against the
    step-by-step plain scan and its chunked mirror."""
    r = (_frames(card, 1, bh, t, kd) * 0.5).to(dtype)
    k = (_frames(card, 2, bh, t, kd) * 0.5).to(dtype)
    v = (_frames(card, 3, bh, t, vd) * 0.5).to(dtype)
    if decay == "model":
        w = _model_decays(card, 4, bh, t, kd, dtype)
    else:
        w = (torch.sigmoid(_frames(card, 4, bh, t, kd)) * 0.5 + 0.5).to(dtype)
    u = (_frames(card, 5, bh, kd) * 0.3).to(dtype)
    lib = dsp.TRANSFORMER_LIB
    before = lib.launches["wkv6"]
    got = rwkv6.wkv6(r, k, v, w, u)
    torch.cuda.synchronize()
    assert lib.launches["wkv6"] == before + 1
    rows = [x.transpose(0, 1)[None] for x in (r, k, v, w)]
    want = ref.rwkv6_scan(*rows, u)[0].transpose(0, 1)
    _rec_close(got, want, dtype)
    mirror = ref.rwkv6_scan_chunked(*rows, u, rwkv6.KERNEL_CHUNK)
    _rec_close(got, mirror[0].transpose(0, 1), dtype)


def _ssd_checked(x, a, bb, c, dtype):
    """One K18 call: one counted launch, held against the step-by-step
    plain recurrence and its chunked mirror."""
    lib = dsp.TRANSFORMER_LIB
    before = lib.launches["ssd"]
    got = mamba2.ssd(x, a, bb, c)
    torch.cuda.synchronize()
    assert lib.launches["ssd"] == before + 1
    _rec_close(got, ref.mamba2_ssd(x, a, bb, c), dtype)
    _rec_close(got, ref.mamba2_ssd_chunked(x, a, bb, c), dtype)


@pytest.mark.parametrize("b,t,h,p,n", [(1, 64, 2, 32, 16), (2, 128, 4, 64, 64),
                                       (1, 80, 3, 16, 32), (2, 1000, 5, 64, 64),
                                       (1, 33, 2, 200, 100), (1, 1, 2, 32, 16),
                                       (1, 63, 3, 64, 64), (1, 65, 3, 64, 64),
                                       (2, 1024, 112, 64, 64)])
@pytest.mark.parametrize("dtype", list(REC_TOL))
def test_ssd_kernel_matches_plain(card, b, t, h, p, n, dtype):
    """Ragged T (one step, one past a chunk, chunks' ragged ends), odd N
    and P, zamba2-7b's forward shape; a <= 0 in float32 whatever x's
    dtype."""
    x = (_frames(card, 6, b, t, h, p) * 0.5).to(dtype)
    a = -(_frames(card, 7, b, t, h) * 0.5).abs()
    bb = (_frames(card, 8, b, t, n) * 0.5).to(dtype)
    c = (_frames(card, 9, b, t, n) * 0.5).to(dtype)
    _ssd_checked(x, a, bb, c, dtype)


@pytest.mark.parametrize("dtype", list(REC_TOL))
def test_ssd_kernel_at_a_steep_decay(card, dtype):
    """a ≈ −5 a step: within a chunk exp(A_i − A_j) for j > i would be
    ~e^320, so the mask must come before the exp (inf · 0 is NaN)."""
    b, t, h, p, n = 2, 200, 3, 64, 64
    x = (_frames(card, 10, b, t, h, p) * 0.5).to(dtype)
    a = -5.0 + 0.1 * _frames(card, 11, b, t, h)
    bb = (_frames(card, 12, b, t, n) * 0.5).to(dtype)
    c = (_frames(card, 13, b, t, n) * 0.5).to(dtype)
    _ssd_checked(x, a, bb, c, dtype)


def test_ssd_kernel_adds_no_bf16_drift_to_the_smoke_model(card):
    """zamba2's bf16 smoke model amplifies a flipped output ulp through its
    layers, so its kernel path sits near the 1e-1 limit of the smoke test
    below for many token draws.  K18 computes in another order than the
    plain loop (chunked); its chunk cumsum in float64 keeps the segment
    sums, and so its bf16 outputs, as close to the loop's as the
    step-by-step kernel was.  Over 24 seeded draws the logits on all the
    kernels lie, on average, within 0.01 normwise of where they lie with
    K18 alone swapped for the plain loop."""
    m = registry.build_smoke("zamba2-7b")
    p = m.init(0)
    mods = (attention, rmsnorm, rwkv6, mamba2)
    kern, k18_plain = [], []
    for seed in range(24):
        g = torch.Generator(device=card).manual_seed(seed)
        tok = torch.randint(0, m.cfg.vocab, (2, 100), device=card,
                            generator=g)
        with chip_smoke.plain_path(True, ref, *mods):
            want = m.forward(p, tok)
        with chip_smoke.plain_path(True, ref, *mods, only=("ssd",)):
            floor = m.forward(p, tok)
        kern.append(_normwise(m.forward(p, tok), want))
        k18_plain.append(_normwise(floor, want))
    assert sum(kern) / 24 <= sum(k18_plain) / 24 + 0.01, (kern, k18_plain)


def test_recurrence_kernels_refuse_a_state_past_their_registers(card):
    r = torch.zeros(1, 4, 129, device=card)
    with pytest.raises(ValueError, match="K <= 128"):
        rwkv6.wkv6(r, r, r, r, torch.zeros(1, 129, device=card))
    x, b = torch.zeros(1, 4, 1, 8, device=card), torch.zeros(1, 4, 129,
                                                           device=card)
    with pytest.raises(ValueError, match="N <= 128"):
        mamba2.ssd(x, torch.zeros(1, 4, 1, device=card), b, b)


#: the ssm smoke models' bf16 kernel path against their plain path: token
#: draws, and the factor on each draw's witness spread (below).  On the
#: H100 (PERF.md §6) the witness read 0.10-0.15 (rwkv6) and 0.67-1.14
#: (zamba2) over the 8 draws, the kernels 0-0.018 and 0.006-0.233
SSM_DRAWS, WITNESS_FACTOR = 8, 1.0


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-7b"])
def test_ssm_smoke_model_kernel_path_matches_plain_path(card, arch,
                                                        monkeypatch):
    """rwkv6's and zamba2's smoke configs on the card: ``forward`` at a
    ragged T launches K17 once a layer (rwkv6), or K18 once a Mamba layer
    and K15 once a group (zamba2), K16 for every norm.  Over SSM_DRAWS
    token draws from a generator of its own, each draw's bf16 logits on
    the kernels lie within 1e-1 normwise of the plain ops', or no farther
    from them than the witness on the same draw: the plain ops on the
    embedding one bf16 ulp up (2^-8 relative), a perturbation on no
    kernel at all, which measures how far this random-weight model
    carries a last-bit difference from that token draw (zamba2's kernel
    path read 0.137-0.342 on draws of the card's global generator, whose
    state depends on the tests before it).  The readings are printed."""
    m = registry.build_smoke(arch)
    p = m.init(0)
    L = m.cfg.n_layers
    if arch == "rwkv6-3b":
        want = {"flash_attention": 0, "rmsnorm": 2 * L + 1, "wkv6": L,
                "ssd": 0}
    else:
        groups = L // m.cfg.shared_attn_period
        want = {"flash_attention": groups, "rmsnorm": L + 2 * groups + 1,
                "wkv6": 0, "ssd": L}
    emb = p["embed"]
    up = torch.nextafter(emb.cpu(), emb.new_tensor(math.inf).cpu()).to(card)
    lib = dsp.TRANSFORMER_LIB
    gen = torch.Generator(device=card).manual_seed(0)
    readings = []
    for _ in range(SSM_DRAWS):
        tok = torch.randint(0, m.cfg.vocab, (2, 100), device=card,
                            generator=gen)
        lib.reset_launches()
        logits = m.forward(p, tok)
        torch.cuda.synchronize()
        assert lib.launches == want
        with monkeypatch.context() as mp:
            _swap_plain(mp)
            plain = m.forward(p, tok)
            witness = m.forward({**p, "embed": up}, tok)
        torch.cuda.synchronize()
        assert lib.launches == want
        readings.append((_normwise(logits, plain), _normwise(witness, plain)))
    print(f"{arch} bf16 smoke, (kernels, witness) vs plain, normwise, by "
          f"draw: {[(round(a, 4), round(b, 4)) for a, b in readings]}")
    for err, spread in readings:
        assert err <= max(1e-1, WITNESS_FACTOR * spread), readings


# ---------------------------------------------------------------------------
# the scenario server and sharding (core/hts/serve.py, shard.py)
# ---------------------------------------------------------------------------
def _serve_population(n):
    return [workloads.generate_scenario(s, n_tenants=2, **CHEAP).merged
            for s in range(n)]


@pytest.mark.parametrize("slice_steps", [None, 16, "auto"],
                         ids=["static", "sliced", "auto"])
def test_server_on_the_card_matches_run_many(card, slice_steps):
    """The server at 64 lanes on the card (96 requests: a full static
    batch and a padded one, or slices with refills): every result equals
    ``run_many``'s; ``hts_run`` launches once a static batch or a slice,
    K1-K4 never, and nothing is built after the first launch."""
    progs = _serve_population(96)
    want = api.run_many(progs, device=card)
    cuda_run.reset_launches()
    cuda_step.reset_launches()
    with hts.serve(max_batch=64, max_queue=128, deadline=99.0,
                   slice_steps=slice_steps, clock=hts.ManualClock(),
                   device=card) as srv:
        futs = [srv.submit(p) for p in progs]
        srv.drain()
        got = [f.result(timeout=0) for f in futs]
    for i, r in enumerate(got):
        assert r.cycles == int(want.cycles[i]), i
        assert r.schedule_tuple() == want[i].schedule_tuple(), i
    (b,) = srv.report().per_bucket.values()
    info = srv.cache_info()
    assert info.launches == (b.slices if slice_steps else b.batches)
    assert not any(cuda_step.launches.values())
    first = info.builds
    with hts.serve(max_batch=64, max_queue=128, deadline=99.0,
                   slice_steps=slice_steps, clock=hts.ManualClock(),
                   device=card) as srv:
        [srv.submit(p) for p in progs[:40]]
    assert srv.cache_info().builds == first


def test_run_many_devices1_matches_run_many(card):
    progs = _serve_population(40)
    want = api.run_many(progs, device=card)
    cuda_run.reset_launches()
    got = api.run_many(progs, devices=1, device=card)
    assert cuda_run.launches["run"] == 1
    assert (got.cycles == want.cycles).all() and got.trips == want.trips
    for i in range(len(progs)):
        assert got[i].schedule_tuple() == want[i].schedule_tuple()


def test_devices_past_the_cards_raise(card):
    n = shard.device_count()
    with pytest.raises(ValueError, match="CUDA device"):
        api.run_many(_serve_population(2), devices=n + 1, device=card)
    with pytest.raises(ValueError, match="CUDA device"):
        hts.serve(devices=n + 1, device=card)


@pytest.mark.parametrize("slice_steps", [None, 16], ids=["static", "sliced"])
@pytest.mark.parametrize("devices", [2, 4])
def test_several_cards_match_one(card, devices, slice_steps):
    """``devices=N``: the lanes split over N cards (70 lanes: padded to a
    multiple of N), one ``hts_run`` launch a card a call, or a slice,
    all launched before any is read back; equal to one card's results,
    in ``run_many`` and in the server."""
    if torch.cuda.device_count() < devices:
        pytest.skip(f"needs {devices} CUDA devices")
    progs = _serve_population(70)
    want = api.run_many(progs, device=card)
    cuda_run.reset_launches()
    got = api.run_many(progs, devices=devices, device=card)
    assert cuda_run.launches["run"] == devices
    assert (got.cycles == want.cycles).all() and got.trips == want.trips
    for i in range(len(progs)):
        assert got[i].schedule_tuple() == want[i].schedule_tuple()
    cuda_run.reset_launches()
    with hts.serve(max_batch=32, max_queue=128, deadline=99.0,
                   devices=devices, slice_steps=slice_steps,
                   clock=hts.ManualClock(), device=card) as srv:
        futs = [srv.submit(p) for p in progs]
        srv.drain()
    for i, f in enumerate(futs):
        r = f.result(timeout=0)
        assert r.cycles == int(want.cycles[i])
        assert r.schedule_tuple() == want[i].schedule_tuple()
    (b,) = srv.report().per_bucket.values()
    launches = b.slices if slice_steps else b.batches
    assert cuda_run.launches["run"] == devices * launches


# ---------------------------------------------------------------------------
# training: the gradient's Function, one train step a family
# ---------------------------------------------------------------------------
def _no_function(name, kernel, plain, *inputs):
    """``ops._apply`` without the gradient's Function: the op calls its
    kernel directly (the control: a raw kernel's output has no graph)."""
    return kernel(*inputs)


def _op_grads(fn, inputs, card):
    """Gradients of ((fn(1.5 x...) + bias) c).sum() with respect to the
    leaves x and bias, None where the graph does not reach one."""
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    out = fn(*(1.5 * t for t in leaves))
    bias = torch.zeros((), device=card, requires_grad=True)
    c = torch.randn(out.shape, device=card, generator=torch.Generator(
        device=card).manual_seed(1)).to(out.dtype)
    loss = ((out + bias) * c).float().sum()
    return torch.autograd.grad(loss, leaves + [bias], allow_unused=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("op", ["rmsnorm", "flash_attention", "rwkv6_scan",
                                "mamba2_ssd"])
def test_gradient_function_on_the_card_equals_plain_bit_for_bit(
        card, op, dtype, monkeypatch):
    """Each op's Function launches its kernel once and gives plain
    autograd's gradients bit for bit (both the plain version's VJP of the
    same inputs); the raw kernel without the Function leaves every
    upstream gradient None."""
    g = torch.Generator(device=card).manual_seed(3)

    def rn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=card)
                * scale).to(dtype)
    cases = {
        "rmsnorm": (lambda x, w: ops.rmsnorm(x, w, 1e-6),
                    lambda x, w: ref.rmsnorm(x, w, 1e-6),
                    [rn(300, 1536), 1 + 0.2 * rn(1536)], "rmsnorm"),
        "flash_attention": (
            lambda q, k, v: ops.flash_attention(q, k, v, q_offset=5),
            lambda q, k, v: ref.flash_attention(
                q, k.repeat_interleave(6, 1), v.repeat_interleave(6, 1),
                q_offset=5),
            [rn(2, 12, 300, 128), rn(2, 2, 305, 128), rn(2, 2, 305, 128)],
            "flash_attention"),
        "rwkv6_scan": (ops.rwkv6_scan, ref.rwkv6_scan,
                       [rn(2, 70, 4, 16), rn(2, 70, 4, 16), rn(2, 70, 4, 16),
                        torch.exp(-torch.exp(rn(2, 70, 4, 16, scale=0.5))),
                        rn(4, 16)], "wkv6"),
        "mamba2_ssd": (ops.mamba2_ssd, ref.mamba2_ssd,
                       [rn(2, 70, 16, 16), -torch.exp(rn(2, 70, 16).float()),
                        rn(2, 70, 16), rn(2, 70, 16)], "ssd"),
    }
    fn, plain, inputs, counter = cases[op]
    lib = dsp.TRANSFORMER_LIB
    lib.reset_launches()
    got = _op_grads(fn, inputs, card)
    assert lib.launches[counter] == 1
    want = _op_grads(plain, inputs, card)
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)
    monkeypatch.setattr(ops, "_apply", _no_function)
    ctl = _op_grads(fn, inputs, card)
    assert all(a is None for a in ctl[:-1]) and ctl[-1] is not None


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "olmoe-1b-7b", "paligemma-3b",
                                  "rwkv6-3b", "zamba2-7b", "whisper-base"])
def test_smoke_train_step_on_kernels_matches_plain(card, arch, monkeypatch):
    """One train step's loss and gradients of each family's smoke model
    in float32 on the kernels (their gradients through the Function)
    within chip_smoke's forward gate (FP32_LOGIT_TOL, at its draw) of
    plain autograd on the plain versions, the MoE routing forced to the
    plain run's; the
    kernels without the Function (missing gradients as zeros) must fail
    it; then ``make_train_step`` takes the step."""
    from repro_torch.data import pipeline as data_lib
    from repro_torch.models import transformer
    from repro_torch.runtime import train as train_rt
    monkeypatch.setattr(layers, "COMPUTE_DTYPE", torch.float32)
    m = registry.build_smoke(arch)
    params = m.init_masters(0)
    if arch in chip_smoke.WIDTH_DRAW_GATES:     # as their forward gates
        for key in m.impl.STACKED:
            chip_smoke.scale_to_width(params[key], len(params[key]))
    batch = data_lib.SyntheticLM(data_lib.DataConfig(
        vocab=m.cfg.vocab, seq_len=64, global_batch=2, seed=0)).batch(0)
    gen = torch.Generator().manual_seed(0)
    if m.cfg.prefix_len:
        batch["prefix_embeds"] = torch.randn(2, m.cfg.prefix_len,
                                             m.cfg.d_model, generator=gen)
    if m.cfg.family == "audio":
        batch["frames"] = torch.randn(2, 64, m.cfg.d_model, generator=gen)
    batch = data_lib.shard_batch(batch, card)
    leaves = layers.tree_leaves(params)

    def grads():
        loss, got = train_rt.loss_and_grads(m, params, batch)
        return float(loss), [torch.zeros_like(p) if x is None else x
                             for p, x in zip(leaves, got)]

    with monkeypatch.context() as mp:
        _swap_plain(mp)
        mp.setattr(ops, "_apply", _no_function)
        with chip_smoke.record_routing(transformer) as routes:
            pl_loss, pl = grads()
    tol = chip_smoke.FP32_LOGIT_TOL[arch]

    def worst(gs):
        return max(float((a - b).abs().max() / b.abs().max())
                   for a, b in zip(gs, pl) if b.abs().max() > 0)
    with chip_smoke.force_routing(transformer, routes):
        k_loss, kg = grads()
    with monkeypatch.context() as mp, \
            chip_smoke.force_routing(transformer, routes):
        mp.setattr(ops, "_apply", _no_function)
        _, cg = grads()
    assert abs(k_loss - pl_loss) <= tol * abs(pl_loss)
    assert worst(kg) <= tol, worst(kg)
    assert worst(cg) > tol
    state = {"params": params, "opt": train_rt.adamw.init(params)}
    state, met = train_rt.make_train_step(m, train_rt.TrainConfig(
        warmup_steps=0, total_steps=10))(state, batch)
    assert math.isfinite(float(met["loss"])) and int(state["opt"]["step"]) == 1
