"""The port's K6–K8 filters, Table II and the nine synthetic schedules held
against the JAX reference.

Inputs are made from a seed with numpy and handed to both packages.  The
JAX side runs its Pallas ops in interpret mode (as
``tests/test_kernels_dsp.py`` runs them); the port runs on the CPU, where
each wrapper computes its plain torch version.  The K6–K8 tolerance is the
reference tests' own, 1e-4; the other Table II entries keep theirs (1e-5
for the FIR, the dot product and the correlation, 1e-4 for the DCT, 1e-3
for the FFT, ``vector_add`` and ``vector_max`` exact up to the subnormals
XLA's CPU backend flushes).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.hts as jhts
from repro.core.hts import programs as jprograms
from repro.kernels import ops as jops

from repro_torch.core import hts as thts
from repro_torch.core.hts import costs as tcosts
from repro_torch.core.hts import programs as tprograms
from repro_torch.examples import dsp_pipeline as pipeline
from repro_torch.kernels import dsp_fir
from repro_torch.kernels import ops as tops

TOL = {"real_fir": 1e-5, "complex_fir": 1e-4, "adaptive_fir": 1e-4,
       "iir": 1e-4, "vector_dot": 1e-5, "vector_add": 0, "vector_max": 0,
       "fft_256": 1e-3, "dct": 1e-4, "correlation": 1e-5}
#: XLA's CPU backend flushes subnormal floats to zero; torch keeps them
SUBNORMAL = float(np.finfo(np.float32).tiny)
#: the JAX golden oracle's cycles at ``HtsParams()``, ``hts_spec``, two
#: units a class
SYNTHETIC_CYCLES = {
    "no_dependency": 18692, "same_dependency": 21932,
    "diff_dependency": 20503, "random_dependency": 39813,
    "loop_no_dependency": 17560, "loop_dependency": 28476,
    "branch_taken_no_dep": 18880, "branch_not_taken_no_dep": 4390,
    "branch_taken_dependency": 19434,
}
IIR_B = np.asarray([0.2, 0.3, 0.1], np.float32)
IIR_A = np.asarray([1.0, -0.4, 0.05], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def frames(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def close(got, want, tol):
    if tol == 0:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=SUBNORMAL)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# K6–K8 plain versions at the JAX tests' shapes (tests/test_kernels_dsp.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b", [1, 64])
@pytest.mark.parametrize("n,k", [(40, 8), (96, 12)])
def test_complex_fir_matches_jax(b, n, k):
    x, h = frames(b * n + k, b, n, 2), frames(k, k, 2)
    got = dsp_fir.complex_fir(T(x), T(h))
    assert got.shape == (b, n, 2)
    close(got, jops.complex_fir(jnp.asarray(x), jnp.asarray(h)), 1e-4)


@pytest.mark.parametrize("b", [1, 32])
@pytest.mark.parametrize("n,k", [(40, 8), (64, 4)])
def test_adaptive_fir_matches_jax(b, n, k):
    x, d = frames(b + n, b, n), frames(b + n + 1, b, n)
    got = dsp_fir.adaptive_fir(T(x), T(d), 0.01, k)
    close(got, jops.adaptive_fir(jnp.asarray(x), jnp.asarray(d), 0.01, k),
          1e-4)


@pytest.mark.parametrize("b", [1, 33])
@pytest.mark.parametrize("n", [40, 80])
def test_iir_matches_jax(b, n):
    x = frames(b * n, b, n)
    got = dsp_fir.iir(T(x), T(IIR_B), T(IIR_A))
    close(got, jops.iir(jnp.asarray(x), jnp.asarray(IIR_B),
                        jnp.asarray(IIR_A)), 1e-4)


def test_fir_wrappers_reject_bad_inputs():
    x = T(frames(1, 4, 40))
    with pytest.raises(ValueError, match="at least 2 coefficients"):
        dsp_fir.iir(x, T(IIR_B), T(IIR_A[:1]))
    with pytest.raises(ValueError, match=r"\(B, N, 2\)"):
        dsp_fir.complex_fir(x, T(frames(2, 8, 2)))
    with pytest.raises(ValueError, match="K must be"):
        dsp_fir.adaptive_fir(x, x, 0.01, 0)
    with pytest.raises(TypeError, match="float32"):
        dsp_fir.adaptive_fir(x, x.double(), 0.01, 8)
    with pytest.raises(ValueError, match=r"a \(Ka,\)"):
        dsp_fir.iir(x, T(IIR_B), T(IIR_A)[None])
    with pytest.raises(ValueError, match="contiguous"):
        dsp_fir.iir(x.t().contiguous().t(), T(IIR_B), T(IIR_A))


# ---------------------------------------------------------------------------
# the dispatch entries and Table II
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["complex_fir", "adaptive_fir", "iir"])
def test_dispatch_entries_match_jax(name):
    x = frames(64, 64, 40)
    got = tops.dsp_dispatch_table()[name](T(x))
    assert got.shape == (64, 40)
    close(got, jops.dsp_dispatch_table()[name](jnp.asarray(x)), TOL[name])
    assert torch.equal(tops.plain_dispatch_table()[name](T(x)), got)


def test_complex_fir_entry_is_exactly_zero_in_both_packages():
    """The entry filters x + jx with taps (1 + j)/8 and keeps the real
    part, x/8 - x/8: both packages give exact zeros (the reference caveat
    of ROADMAP Queue 3), so every later task of a chain sees zeros."""
    x = frames(7, 64, 40)
    assert not np.asarray(jops.dsp_dispatch_table()["complex_fir"](
        jnp.asarray(x))).any()
    assert torch.equal(tops.dsp_dispatch_table()["complex_fir"](T(x)),
                       torch.zeros(64, 40))


def test_table_ii_matches_jax():
    """Every Table II entry once, on its own frames at its Table II width,
    against the JAX entry on the same frames."""
    rows = pipeline.table_ii(64, seed=3, device="cpu")
    assert list(rows) == list(tcosts.FUNCTIONS)
    jtable = jops.dsp_dispatch_table()
    for name, x in pipeline.table_ii_frames(64, 3).items():
        y, sec = rows[name]
        assert x.shape == (64, tcosts.FUNCTIONS[name][1]) and sec >= 0
        close(y, jtable[name](jnp.asarray(x)), TOL[name])


# ---------------------------------------------------------------------------
# the nine synthetic schedules
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def synthetic_on_port():
    """The nine schedules as one population on the port's CPU machine."""
    benches = [g() for g in tprograms.ALL_SYNTHETIC]
    return thts.run_many(benches, scheduler="hts_spec", n_fu=2,
                         device="cpu")


@pytest.mark.parametrize("i,name", list(enumerate(SYNTHETIC_CYCLES)))
def test_synthetic_schedule_matches_jax_golden(synthetic_on_port, i, name):
    gen = jprograms.ALL_SYNTHETIC[i]
    assert gen.__name__ == name
    g = jhts.run(gen(), scheduler="hts_spec", n_fu=2, backend="golden")
    port = synthetic_on_port[i]
    assert port.cycles == g.cycles == SYNTHETIC_CYCLES[name]
    assert port.schedule_tuple() == g.schedule_tuple()


def test_synthetic_schedules_issue_the_fir_functions():
    """Across the nine schedules: 145 live tasks, 18 complex_fir, 18
    adaptive_fir and 17 iir, as the JAX golden oracle issues them."""
    live: dict = {}
    for gen in tprograms.ALL_SYNTHETIC:
        r = thts.run(gen(), scheduler="hts_spec", n_fu=2, backend="golden")
        for t in pipeline.issued_tasks(r):
            live[t.func_name] = live.get(t.func_name, 0) + 1
    assert sum(live.values()) == 145
    assert (live["complex_fir"], live["adaptive_fir"], live["iir"]) == \
        (18, 18, 17)


@pytest.mark.parametrize("name", ["random_dependency", "loop_dependency"])
def test_executed_synthetic_schedule_matches_jax_chain(name):
    """On 8 frames of 40 samples: the port's executed schedule against the
    JAX dispatch table run over the JAX golden schedule, with the same
    renormalisation, within 1e-3; the per-task checks hold every entry to
    its plain version (equal on the CPU, where both are the plain
    version).  These two schedules keep their frames non-zero (no
    complex_fir)."""
    x0 = frames(len(name), 8, pipeline.TABLE_II_SAMPLES)
    checks = []
    r, executed, out = pipeline.run_pipeline(
        pipeline.SYNTHETIC[name](), T(x0), device="cpu", checks=checks)
    g = jhts.run(getattr(jprograms, name)(), scheduler="hts_spec", n_fu=2,
                 backend="golden")
    issued = sorted((t for t in g.schedule if not t.aborted),
                    key=lambda t: t.issue)
    assert executed == [(t.uid, t.func_name) for t in issued]
    assert [(c.uid, c.func) for c in checks] == executed
    assert all(c.max_err == 0 and not c.input_zero and not c.output_zero
               for c in checks)
    jtable, xj = jops.dsp_dispatch_table(), jnp.asarray(x0)
    for _uid, fname in executed:
        xj = jtable[fname](xj)
        xj = xj / jnp.maximum(jnp.max(jnp.abs(xj)), 1e-6)
    assert out.shape == (8, pipeline.TABLE_II_SAMPLES)
    assert bool(torch.isfinite(out).all())
    close(out, xj, 1e-3)


def test_checks_see_the_zero_chain_after_complex_fir():
    """In ``no_dependency`` the second task is complex_fir: its output,
    and every later task's input, is all zeros."""
    checks = []
    pipeline.run_pipeline(pipeline.SYNTHETIC["no_dependency"](),
                          T(frames(2, 4, 40)), device="cpu", checks=checks)
    first = next(i for i, c in enumerate(checks) if c.output_zero)
    assert checks[first].func == "complex_fir" and first == 1
    assert all(c.input_zero for c in checks[first + 1:])


def test_main_runs_table2_and_a_synthetic_program(capsys):
    pipeline.main(["--program", "table2", "--frames", "4",
                   "--device", "cpu"])
    out = capsys.readouterr().out
    assert all(name in out for name in tcosts.FUNCTIONS)
    pipeline.main(["--program", "synthetic", "--bench", "no_dependency",
                   "--frames", "4", "--device", "cpu"])
    assert "18692 cycles" in capsys.readouterr().out
