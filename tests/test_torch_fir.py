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


# ---------------------------------------------------------------------------
# K5 real_fir: the kernel's source under emulation (csrc/dsp.cu's K5 span
# built with g++ against tests/cuda_emu.h)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def emulated_fir(tmp_path_factory):
    """K5's span (both kernels and the launcher) built for the CPU, with a
    C entry that runs it as ``dsp_real_fir`` does."""
    import ctypes

    import emu_build
    from repro_torch.kernels import common
    code = emu_build.span(common.LIB.source.read_text(), "K5")
    code = code.replace("extern __shared__ __align__(16) unsigned char "
                        "fir_raw[];", "unsigned char* fir_raw = emu_smem();")
    code += r"""
extern "C" int emu_real_fir(int B, int N, int K, void* x, void* h, void* y) {
  return launch_real_fir(B, N, K, (const float*)x, (const float*)h,
                         (float*)y, nullptr);
}
"""
    P, I = ctypes.c_void_p, ctypes.c_int
    return emu_build.build(tmp_path_factory.mktemp("fir_emu"), code,
                           {"emu_real_fir": [I] * 3 + [P] * 3})


@pytest.mark.parametrize("b,n,k,offset", [
    (1, 40, 8, 0), (300, 40, 5, 0), (300, 256, 8, 0), (33, 40, 8, 0),
    (3, 40, 12, 0), (7, 2056, 8, 0), (2, 4, 32, 0), (9, 64, 1, 0),
    (5, 42, 8, 0), (6, 40, 8, 1), (4, 40, 33, 0)],
    ids=["1x40", "300x40-k5", "300x256", "33x40", "k12", "tiled-2056",
         "halo-past-row", "k1", "flat-42", "flat-misaligned", "flat-k33"])
def test_real_fir_kernel_source_matches_plain_under_emulation(
        emulated_fir, b, n, k, offset):
    """Rows packed into blocks (25 rows of 40, 4 of 256, a ragged last
    block), a row wider than a block (three tiles, halos from the row), a
    halo wider than the row, the taps in registers (8, 5) or shared memory
    (12, 32, 1); the flat path for N not a multiple of 4, a base 4 bytes
    off 16-byte alignment and K past 32.  Against the plain version within
    the reference tests' 1e-5."""
    x = torch.from_numpy(frames(n * 31 + k, b * n + offset))[offset:]
    x = x.view(b, n)
    h = torch.from_numpy(frames(k, k)) / k
    y = torch.full((b * n + offset,), float("nan"))[offset:].view(b, n)
    assert emulated_fir.emu_real_fir(b, n, k, x.data_ptr(), h.data_ptr(),
                                     y.data_ptr()) == 0
    close(y, dsp_fir.real_fir(x, h), TOL["real_fir"])


# ---------------------------------------------------------------------------
# K7 adaptive_fir: the kernel's source under emulation (csrc/dsp.cu's
# helpers and K7 spans built with g++ against tests/cuda_emu.h)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def emulated_lms(tmp_path_factory):
    """K7's span (both kernels and the launcher) built for the CPU, with a
    C entry that runs it as ``dsp_adaptive_fir`` does.  The flat kernel's
    static ``__shared__`` arrays become function statics: one object
    shared by the block's threads, as the emulated blocks run one at a
    time."""
    import ctypes

    import emu_build
    from repro_torch.kernels import common
    source = common.LIB.source.read_text()
    code = emu_build.span(source, "helpers") + emu_build.span(source, "K7")
    code = code.replace("extern __shared__ __align__(16) unsigned char "
                        "lms_raw[];", "unsigned char* lms_raw = emu_smem();")
    code = "#define __shared__ static\n" + code + r"""
extern "C" int emu_adaptive_fir(int B, int N, int K, float mu, void* x,
                                void* d, void* y) {
  return launch_adaptive_fir(B, N, K, mu, (const float*)x, (const float*)d,
                             (float*)y, nullptr);
}
"""
    P, I = ctypes.c_void_p, ctypes.c_int
    return emu_build.build(tmp_path_factory.mktemp("lms_emu"), code,
                           {"emu_adaptive_fir": [I] * 3 + [ctypes.c_float]
                            + [P] * 3})


@pytest.mark.parametrize("b,n,k,alias,offset", [
    (1, 40, 8, False, 0), (300, 40, 8, False, 0), (300, 40, 8, True, 0),
    (130, 64, 4, False, 0), (130, 64, 4, True, 0), (5, 136, 8, False, 0),
    (260, 200, 4, True, 0), (7, 42, 8, False, 0), (7, 42, 4, True, 0),
    (6, 40, 8, False, 1), (6, 40, 8, True, 1)],
    ids=["1x40", "300x40", "300x40-d-is-x", "130x64-k4", "130x64-k4-d-is-x",
         "row-of-3-tiles", "260x200-d-is-x", "flat-42", "flat-42-d-is-x",
         "flat-misaligned", "flat-misaligned-d-is-x"])
def test_adaptive_fir_kernel_source_matches_plain_under_emulation(
        emulated_lms, b, n, k, alias, offset):
    """The packed kernel's persistent walk (two emulated SMs: each block
    takes several row groups, a ragged last one), whole rows of 40 and 64
    and rows longer than a tile (64 + 64 + 8 samples; 200 in four tiles,
    the weights carried across), d the same tensor as x and a distinct
    one; the flat path for N not a multiple of 4 and for x, d, y 4 bytes
    off 16-byte alignment.  Against the plain version within the
    reference tests' 1e-4."""
    x = torch.from_numpy(frames(n * 7 + k, b * n + offset))[offset:]
    x = x.view(b, n)
    d = x if alias else torch.from_numpy(
        frames(n * 7 + k + 1, b * n + offset))[offset:].view(b, n)
    y = torch.full((b * n + offset,), float("nan"))[offset:].view(b, n)
    assert emulated_lms.emu_adaptive_fir(b, n, k, 0.01, x.data_ptr(),
                                         d.data_ptr(), y.data_ptr()) == 0
    close(y, dsp_fir.adaptive_fir(x, d, 0.01, k), TOL["adaptive_fir"])


# ---------------------------------------------------------------------------
# K8 iir: the kernel's source under emulation (csrc/dsp.cu's helpers and K8
# spans built with g++ against tests/cuda_emu.h)
# ---------------------------------------------------------------------------
#: the packed kernel's store of a float4 of outputs (walk_row_tiles, in
#: the helpers span), and the same outputs one sample early: the mutation
#: the packed cases must catch
IIR_STORE = "make_float4(yq[0], yq[1], yq[2], yq[3])"
IIR_EARLY = "make_float4(yq[1], yq[2], yq[3], yq[3])"


def _build_iir(tmp_path_factory, mutate: bool):
    """K8's span (both kernels and the launcher) after the helpers, built
    for the CPU with a C entry that runs it as ``dsp_iir`` does; the flat
    kernel's static ``__shared__`` array becomes a function static (the
    emulated blocks run one at a time).  ``mutate``: the packed kernel
    stores each float4 of outputs one sample early."""
    import ctypes

    import emu_build
    from repro_torch.kernels import common
    source = common.LIB.source.read_text()
    code = emu_build.span(source, "helpers") + emu_build.span(source, "K8")
    code = code.replace("extern __shared__ __align__(16) unsigned char "
                        "iir_raw[];", "unsigned char* iir_raw = emu_smem();")
    if mutate:
        assert code.count(IIR_STORE) == 1
        code = code.replace(IIR_STORE, IIR_EARLY)
    code = "#define __shared__ static\n" + code + r"""
extern "C" int emu_iir(int B, int N, int Kb, int Ka, void* x, void* b,
                       void* a, void* y) {
  return launch_iir(B, N, Kb, Ka, (const float*)x, (const float*)b,
                    (const float*)a, (float*)y, nullptr);
}
"""
    P, I = ctypes.c_void_p, ctypes.c_int
    tag = "iir_mutant" if mutate else "iir_emu"
    return emu_build.build(tmp_path_factory.mktemp(tag), code,
                           {"emu_iir": [I] * 4 + [P] * 4})


@pytest.fixture(scope="module")
def emulated_iir(tmp_path_factory):
    return _build_iir(tmp_path_factory, mutate=False)


@pytest.fixture(scope="module")
def mutated_iir(tmp_path_factory):
    return _build_iir(tmp_path_factory, mutate=True)


def iir_coefficients(kb, ka):
    """(b, a) with ``kb`` and ``ka`` coefficients: the dispatch entry's at
    (2, 2), the JAX tests' at (3, 3), else drawn from a seed with
    sum |a[1:]| = 0.9, so that the filter is stable."""
    if (kb, ka) == (2, 2):
        return (np.asarray([0.2, 0.3], np.float32),
                np.asarray([1.0, -0.5], np.float32))
    if (kb, ka) == (3, 3):
        return IIR_B, IIR_A
    rng = np.random.default_rng(100 * kb + ka)
    b = rng.standard_normal(kb).astype(np.float32) / kb
    a = rng.uniform(-1.0, 1.0, ka - 1)
    a = np.concatenate([[1.0], 0.9 * a / np.abs(a).sum()]).astype(np.float32)
    return b, a


#: (B, N, (Kb, Ka), offset): the packed kernel's persistent walk (two
#: emulated SMs: three row groups of 300 rows, the last ragged), rows
#: longer than a tile (136 = 64 + 64 + 8; 200 in four tiles), the packed
#: instance 2 (first order: (2, 2), (1, 2)) and 8 ((3, 3), (8, 8), the
#: bound); the flat kernel at N = 42, on x and y
#: 4 bytes off 16-byte alignment, and its generic instance (9, 12) on a
#: frame of three chunks (the y history reaches into stored chunks)
IIR_CASES = [(300, 40, (2, 2), 0), (300, 40, (3, 3), 0),
             (300, 40, (1, 2), 0), (300, 40, (8, 8), 0),
             (5, 136, (2, 2), 0), (260, 200, (3, 3), 0),
             (7, 42, (2, 2), 0), (7, 42, (8, 8), 0), (6, 40, (2, 2), 1),
             (6, 40, (3, 3), 1), (33, 80, (9, 12), 0), (5, 42, (12, 9), 1)]
IIR_IDS = ["300x40-entry", "300x40-k3", "300x40-kb1", "300x40-k8",
           "row-of-3-tiles", "260x200-k3", "flat-42", "flat-42-k8",
           "flat-misaligned", "flat-misaligned-k3", "generic-9-12",
           "generic-12-9-misaligned"]


def _iir_packed(n, kb, ka, offset):
    return n % 4 == 0 and offset == 0 and max(kb, ka) <= 8


def _run_emulated_iir(lib, b, n, taps, offset):
    """(kernel output, plain output) on frames made from a seed, x and y
    ``offset`` floats past a 16-byte boundary."""
    kb, ka = taps
    x = torch.from_numpy(frames(n * 11 + kb, b * n + offset))[offset:]
    x = x.view(b, n)
    bc, ac = (T(c) for c in iir_coefficients(kb, ka))
    y = torch.full((b * n + offset,), float("nan"))[offset:].view(b, n)
    assert lib.emu_iir(b, n, kb, ka, x.data_ptr(), bc.data_ptr(),
                       ac.data_ptr(), y.data_ptr()) == 0
    return y, dsp_fir.iir(x, bc, ac)


@pytest.mark.parametrize("b,n,taps,offset", IIR_CASES, ids=IIR_IDS)
def test_iir_kernel_source_matches_plain_under_emulation(
        emulated_iir, b, n, taps, offset):
    """Both kernels and every instance (packed 2 and 8; flat 8 and the
    generic one for filters past 8 coefficients) against the plain version
    within the reference tests' 1e-4."""
    got, want = _run_emulated_iir(emulated_iir, b, n, taps, offset)
    close(got, want, TOL["iir"])


@pytest.mark.parametrize("b,n,taps,offset", IIR_CASES, ids=IIR_IDS)
def test_iir_kernel_mutation_fails_exactly_the_packed_cases(
        mutated_iir, b, n, taps, offset):
    """With the packed kernel's outputs stored one sample early, every
    packed case differs from the plain version and every flat case still
    agrees: the cases above reach the route they name."""
    got, want = _run_emulated_iir(mutated_iir, b, n, taps, offset)
    ok = np.allclose(np.asarray(got), np.asarray(want), rtol=TOL["iir"],
                     atol=TOL["iir"])
    assert ok != _iir_packed(n, *taps, offset)
