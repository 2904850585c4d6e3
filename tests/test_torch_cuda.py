"""Card only: the CUDA kernels against their plain torch versions.

Every test here carries the ``cuda`` marker and skips without a CUDA
device (the kernels have no CPU mode; the CPU tests hold the plain
versions to the reference).  On a machine with a card and ``nvcc``:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

This file imports only torch and the port, so it runs where JAX is not
installed.  The step kernels' state is int32/bool: tolerance zero.  The
DSP kernels are float32, held to the reference tests' tolerances (1e-5;
1e-3 for the FFT), at ragged batches that leave part of the last block
empty.
"""
import pytest
import torch

from repro_torch.core.hts import (batch, costs, cuda_step, machine, programs,
                                  workloads)
from repro_torch.examples import dsp_pipeline
from repro_torch.kernels import common as dsp
from repro_torch.kernels import dsp_fir, dsp_spectral, dsp_vector, ops, ref

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
@WIDTHS
@pytest.mark.parametrize("k", [5, 8])
def test_real_fir_kernel_matches_plain(card, b, n, k):
    x, h = _frames(card, b * n, b, n), _frames(card, k, k)
    got = _counted("real_fir", dsp_fir.real_fir, x, h)
    torch.testing.assert_close(got, ref.real_fir(x, h), rtol=1e-5, atol=1e-5)


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


@RAGGED
@pytest.mark.parametrize("n", [2, 64, 256, 4096])
def test_fft_kernel_matches_plain(card, b, n):
    x = _frames(card, b + n, b, n, 2)
    got = _counted("fft", dsp_spectral.fft, x)
    torch.testing.assert_close(got, ref.fft(x), rtol=1e-3, atol=1e-3)
    want = torch.fft.fft(torch.view_as_complex(x))
    torch.testing.assert_close(torch.view_as_complex(got), want, rtol=1e-3,
                               atol=1e-3 * max(1.0, n / 256))


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
