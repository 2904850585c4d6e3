"""The port's DSP kernel layer and audio pipeline held against the JAX
reference.

Inputs are made from a seed with numpy and handed to both packages.  The
JAX side runs its Pallas ops in interpret mode (as
``tests/test_kernels_dsp.py`` runs them); the port runs on the CPU, where
each wrapper computes its plain torch version.  Tolerances are the
reference tests' own: 1e-5 for the FIR, the dot product and the
correlation, 1e-4 for the DCT, 1e-3 for the FFT; ``vector_add`` and
``vector_max`` are exact (the reference's default ``assert_allclose``,
rtol 1e-7, atol 0).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.hts as jhts
from repro.core.hts import programs as jprograms
from repro.kernels import dsp_spectral as jspectral
from repro.kernels import ops as jops
from repro.kernels import ref as jref

from repro_torch.core.hts import programs as tprograms
from repro_torch.examples import dsp_pipeline as pipeline
from repro_torch.kernels import common, dsp_fir, dsp_spectral, dsp_vector
from repro_torch.kernels import ops as tops

TOL = {"real_fir": 1e-5, "vector_dot": 1e-5, "correlation": 1e-5,
       "fft_256": 1e-3, "dct": 1e-4, "vector_max": 0, "vector_add": 0}
BATCHES = [1, 7, 300]


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
    """Within ``tol`` (rtol = atol); tolerance 0 is the reference's default
    ``assert_allclose`` (rtol 1e-7, atol 0)."""
    if tol == 0:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want))
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", [40, 256])
@pytest.mark.parametrize("k", [5, 8])
def test_real_fir_matches_jax(b, n, k):
    x, h = frames(b * n + k, b, n), frames(k, k)
    got = dsp_fir.real_fir(torch.from_numpy(x), torch.from_numpy(h))
    close(got, jops.real_fir(jnp.asarray(x), jnp.asarray(h)), 1e-5)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", [40, 256])
def test_vector_dot_matches_jax(b, n):
    x, y = frames(b, b, n), frames(b + 1, b, n)
    got = dsp_vector.vector_dot(torch.from_numpy(x), torch.from_numpy(y))
    close(got, jops.vector_dot(jnp.asarray(x), jnp.asarray(y)), 1e-5)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", [40, 64, 256])
def test_vector_add_matches_jax(b, n):
    x, y = frames(b + 2, b, n), frames(b + 3, b, n)
    got = dsp_vector.vector_add(torch.from_numpy(x), torch.from_numpy(y))
    assert got.shape == (b, n)
    close(got, jops.vector_add(jnp.asarray(x), jnp.asarray(y)), 0)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", [40, 64, 256])
def test_vector_max_matches_jax(b, n):
    x = frames(b + 4, b, n)
    got = dsp_vector.vector_max(torch.from_numpy(x))
    assert got.shape == (b,)
    close(got, jops.vector_max(jnp.asarray(x)), 0)


@pytest.mark.parametrize("b", [1, 65, 300])
@pytest.mark.parametrize("n", [40, 64, 128])
def test_dct_matches_jax(b, n):
    x = frames(b + n, b, n)
    got = dsp_spectral.dct(torch.from_numpy(x))
    assert got.shape == (b, n)
    close(got, jops.dct(jnp.asarray(x)), 1e-4)


@pytest.mark.parametrize("n", [40, 64, 128])
def test_dct_matrix_equals_reference(n):
    """The DCT's matrix is the state it carries: copied exactly."""
    mine = dsp_spectral.dct_matrix(n)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine, np.asarray(jref.dct_matrix(n)))


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("n", [40, 256])
@pytest.mark.parametrize("lag", [4, 10])
def test_correlation_matches_jax(b, n, lag):
    x, y = frames(b * lag, b, n), frames(b * lag + 1, b, n)
    got = dsp_vector.correlation(torch.from_numpy(x), torch.from_numpy(y),
                                 lag)
    assert got.shape == (b, 2 * lag + 1)
    close(got, jops.correlation(jnp.asarray(x), jnp.asarray(y), lag), 1e-5)


@pytest.mark.parametrize("b", BATCHES)
def test_fft_256_matches_jax(b):
    x = frames(b, b, 256, 2)
    got = dsp_spectral.fft_256(torch.from_numpy(x))
    close(got, jops.fft_256(jnp.asarray(x)), 1e-3)


@pytest.mark.parametrize("n", [2, 64, 256])
def test_fft_matches_numpy(n):
    x = frames(n, 4, n, 2)
    want = np.fft.fft(x[..., 0] + 1j * x[..., 1], axis=-1)
    got = dsp_spectral.fft(torch.from_numpy(x)).numpy()
    close(got[..., 0], want.real, 1e-3)
    close(got[..., 1], want.imag, 1e-3)


@pytest.mark.parametrize("n", [2, 64, 256])
def test_fft_constants_equal_reference(n):
    """The DSP layer learns nothing: its taps and twiddles are the state
    it carries, and the twiddles and bit-reversal are copied exactly."""
    np.testing.assert_array_equal(dsp_spectral._bitrev(n),
                                  jspectral._bitrev(n))
    for mine, theirs in zip(dsp_spectral._twiddle_tables(n),
                            jspectral._twiddle_tables(n)):
        assert mine.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(mine, theirs)


@pytest.mark.parametrize("n", [2 ** b for b in range(1, 13)])
def test_every_twiddle_row_is_a_stride_of_the_kernels_row(n):
    """The fft kernel takes only the last row of the twiddle tables and
    reads stage s's entry j at j * 2^(stages-1-s): for every frame size it
    takes (2 to 4096) that entry is row s's entry j bit for bit."""
    tables = dsp_spectral._twiddle_tables(n)
    rows = dsp_spectral.kernel_twiddles(n, torch.device("cpu"))
    stages = tables[0].shape[0]
    for table, row in zip(tables, rows):
        row = row.numpy()
        assert row.shape == (n // 2,)
        for s in range(stages):
            m = 1 << s
            np.testing.assert_array_equal(
                table[s, :m].view(np.uint32),
                row[::1 << (stages - 1 - s)][:m].view(np.uint32))


@pytest.mark.parametrize("name", sorted(TOL))
@pytest.mark.parametrize("n", [40, 64, 256])
def test_dispatch_entry_matches_jax(name, n):
    """Each dispatch-table entry composes its kernel as the reference's
    entry does (taps, broadcast, the FFT's fit to 256 and real part, the
    DCT's fit to 64: a 256-wide batch comes back 64 wide)."""
    x = frames(n, 9, n)
    got = tops.dsp_dispatch_table()[name](torch.from_numpy(x))
    width = min(n, 64) if name == "dct" else n
    assert got.shape == (9, width)
    close(got, jops.dsp_dispatch_table()[name](jnp.asarray(x)), TOL[name])
    plain = tops.plain_dispatch_table()[name](torch.from_numpy(x))
    assert torch.equal(got, plain)


@pytest.mark.parametrize("time_domain", [False, True])
def test_audio_pipeline_matches_jax(time_domain):
    """The slice as a whole, on 8 frames of 256 samples: the port's schedule
    equals the JAX package's golden oracle, each executed task's output on
    the same input is within its kernel's tolerance of the reference's
    table, and the final outputs agree within 1e-3.  Largest absolute
    differences seen (torch 2.13 CPU, jax 0.9 interpret mode): per task,
    BNT vector_dot 1.5e-5 (on sums of about 100), correlation 4.8e-6,
    fft_256 0; BT correlation 3.8e-6, real_fir 0.  Final output: 2.5e-23
    (BNT) and 4.2e-7 (BT); each task's renormalisation keeps the chain
    from growing them."""
    x0 = frames(12 + time_domain, 8, 256)
    r, executed, out = pipeline.run_pipeline(
        tprograms.audio_compression(2, time_domain), torch.from_numpy(x0),
        device="cpu")
    g = jhts.run(jprograms.audio_compression(2, time_domain),
                 scheduler="hts_spec", n_fu=2, backend="golden")
    assert r.cycles == g.cycles
    assert r.schedule_tuple() == g.schedule_tuple()
    issued = sorted((t for t in g.schedule if not t.aborted),
                    key=lambda t: t.issue)
    assert executed == [(t.uid, t.func_name) for t in issued]
    assert len(executed) == (7 if time_domain else 11)

    ttable, jtable = tops.dsp_dispatch_table(), jops.dsp_dispatch_table()
    xt, xj = torch.from_numpy(x0), jnp.asarray(x0)
    for _uid, name in executed:
        got = ttable[name](xt)
        close(got, jtable[name](jnp.asarray(xt.numpy())), TOL[name])
        xt = pipeline.renormalise(got)
        xj = jtable[name](xj)
        xj = xj / jnp.maximum(jnp.max(jnp.abs(xj)), 1e-6)
    assert torch.equal(xt, out)
    assert bool(torch.isfinite(out).all())
    close(out, xj, 1e-3)


def test_wrappers_send_cpu_tensors_to_plain_versions():
    """On CPU tensors each wrapper computes exactly its plain version and
    launches nothing."""
    from repro_torch.kernels import ref
    common.reset_launches()
    x, y = (torch.from_numpy(frames(s, 5, 256)) for s in (1, 2))
    h = torch.from_numpy(frames(3, 8))
    z = torch.from_numpy(frames(4, 5, 256, 2))
    assert torch.equal(dsp_fir.real_fir(x, h), ref.real_fir(x, h))
    assert torch.equal(dsp_vector.vector_dot(x, y), ref.vector_dot(x, y))
    assert torch.equal(dsp_vector.correlation(x, y, 4),
                       ref.correlation(x, y, 4))
    assert torch.equal(dsp_spectral.fft_256(z), ref.fft_256(z))
    assert torch.equal(dsp_vector.vector_add(x, y), ref.vector_add(x, y))
    assert torch.equal(dsp_vector.vector_add(x, x), x + x)
    assert torch.equal(dsp_vector.vector_max(x), ref.vector_max(x))
    t = x[:, :64].contiguous()
    assert torch.equal(dsp_spectral.dct(t), ref.dct(t))
    assert all(v == 0 for v in common.launches.values())


def test_wrappers_reject_bad_inputs():
    x = torch.from_numpy(frames(0, 4, 40))
    h = torch.ones(8)
    with pytest.raises(TypeError, match="float32"):
        dsp_fir.real_fir(x.double(), h.double())
    with pytest.raises(ValueError, match="contiguous"):
        dsp_fir.real_fir(x.t().contiguous().t(), h)
    with pytest.raises(ValueError, match="real_fir"):
        dsp_fir.real_fir(x, h[:0])
    with pytest.raises(ValueError, match="shape"):
        dsp_vector.vector_dot(x, x[:3])
    with pytest.raises(ValueError, match="unsupported device"):
        dsp_vector.vector_dot(x.to("meta"), x.to("meta"))
    with pytest.raises(ValueError, match="on cpu"):
        dsp_vector.vector_dot(x.to("meta"), x)
    with pytest.raises(ValueError, match="max_lag"):
        dsp_vector.correlation(x, x, -1)
    with pytest.raises(ValueError, match="power-of-two"):
        dsp_spectral.fft(torch.zeros(2, 40, 2))
    with pytest.raises(ValueError, match="256"):
        dsp_spectral.fft_256(torch.zeros(2, 64, 2))
    with pytest.raises(ValueError, match="shape"):
        dsp_vector.vector_add(x, x[:, :39])
    with pytest.raises(TypeError, match="float32"):
        dsp_vector.vector_add(x.double(), x.double())
    with pytest.raises(ValueError, match="contiguous"):
        dsp_vector.vector_max(x.t().contiguous().t())
    with pytest.raises(ValueError, match="at least one"):
        dsp_vector.vector_max(torch.zeros(3, 0))
    with pytest.raises(ValueError, match="unsupported device"):
        dsp_vector.vector_max(x.to("meta"))
    with pytest.raises(ValueError, match="\\(B, N\\)"):
        dsp_spectral.dct(torch.zeros(2, 8, 8))
    with pytest.raises(TypeError, match="float32"):
        dsp_spectral.dct(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        dsp_spectral.dct(torch.zeros(64, 4)[:, :2])


def test_plain_route_takes_sizes_past_the_kernels_shared_memory():
    """The kernels' shared-memory limits bind the card route only: on the
    CPU the plain versions take what the reference takes."""
    from repro_torch.kernels import ref
    n = dsp_vector.CORR_MAX_SPAN
    x, y = (torch.from_numpy(frames(s, 1, n)) for s in (5, 6))
    assert torch.equal(dsp_vector.correlation(x, y, 1),
                       ref.correlation(x, y, 1))
    z = torch.from_numpy(frames(7, 1, 2 * dsp_spectral.FFT_MAX_N, 2))
    want = np.fft.fft(z[..., 0].numpy() + 1j * z[..., 1].numpy(), axis=-1)
    got = dsp_spectral.fft(z).numpy()
    close(got[..., 0], want.real, 1e-3)
    close(got[..., 1], want.imag, 1e-3)
    w = torch.from_numpy(frames(8, 3, 2 * dsp_spectral.DCT_MAX_N))
    assert torch.equal(dsp_spectral.dct(w), ref.dct(w))


def test_dispatch_table_refuses_unported_functions():
    """Both tables hold exactly the ten Table II functions (every one has
    its kernel now); a name outside them stops with that name."""
    from repro_torch.core.hts.costs import FUNCTIONS
    table = tops.dsp_dispatch_table()
    assert list(table) == list(FUNCTIONS)
    assert list(tops.plain_dispatch_table()) == list(FUNCTIONS)
    for name in ("lms", "fft", "real_fir_8"):
        with pytest.raises(KeyError, match=f"{name}.*not an accelerator "
                                           "function of Table II"):
            table[name]


def test_run_pipeline_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    bench = tprograms.audio_compression(2, True)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.run_pipeline(bench, torch.zeros(2, 256))
    with pytest.raises(ValueError, match="float32"):
        pipeline.run_pipeline(bench, torch.zeros(2, 256, dtype=torch.int32),
                              device="cpu")


def test_dsp_build_paths_are_inside_the_checkout():
    root = common.SOURCE.parents[3]
    assert common.SOURCE.exists() and common.SOURCE.name == "dsp.cu"
    from repro_torch import _build
    assert _build.BUILD_DIR == root / "build" / "repro_torch"


# ---------------------------------------------------------------------------
# K12 correlation: the kernel's source under emulation (csrc/dsp.cu's
# helpers and K12 spans built with g++ against tests/cuda_emu.h)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def emulated_corr(tmp_path_factory):
    """K12's span (both kernels and the launcher) built for the CPU, with
    a C entry that runs it as ``dsp_correlation`` does."""
    import ctypes

    import emu_build
    source = common.LIB.source.read_text()
    code = emu_build.span(source, "helpers") + emu_build.span(source, "K12")
    code = code.replace("extern __shared__ __align__(16) unsigned char "
                        "corr_raw[];", "unsigned char* corr_raw = emu_smem();")
    code = code.replace("extern __shared__ float smem[];",
                        "float* smem = reinterpret_cast<float*>(emu_smem());")
    code += r"""
extern "C" int emu_correlation(int B, int N, int L, void* x, void* y,
                               void* out) {
  return launch_correlation(B, N, L, (const float*)x, (const float*)y,
                            (float*)out, nullptr);
}
"""
    P, I = ctypes.c_void_p, ctypes.c_int
    return emu_build.build(tmp_path_factory.mktemp("corr_emu"), code,
                           {"emu_correlation": [I] * 3 + [P] * 3})


@pytest.mark.parametrize("b,n,lag,alias,offset", [
    (1, 64, 4, False, 0), (300, 64, 4, False, 0), (300, 64, 4, True, 0),
    (70, 256, 4, False, 0), (70, 256, 4, True, 0), (33, 40, 10, False, 0),
    (130, 128, 10, True, 0), (3, 1024, 10, False, 0),
    (3, 1024, 10, True, 0), (7, 64, 0, False, 0), (9, 42, 4, False, 0),
    (9, 42, 4, True, 0), (6, 64, 4, False, 1), (6, 64, 4, True, 1)],
    ids=["1x64", "300x64", "300x64-y-is-x", "70x256", "70x256-y-is-x",
         "33x40-lag10", "130x128-lag10-y-is-x", "flat-1024-lag10",
         "1024-lag10-y-is-x", "flat-lag0", "flat-42", "flat-42-y-is-x",
         "flat-misaligned", "flat-misaligned-y-is-x"])
def test_correlation_kernel_source_matches_plain_under_emulation(
        emulated_corr, b, n, lag, alias, offset):
    """The packed kernel at a thread a row (64 and 40 samples: a ragged
    last block, one row), two and four threads a row (128, 256 samples),
    lags 4 and 10, y the same tensor as x and a distinct one; rows of
    1024 at lag 10, packed when y is x and flat when the second array
    would pass the packed kernel's shared memory; the flat path for lag
    0, for N not a multiple of 4 and for rows 4 bytes off 16-byte
    alignment.  Against the plain version within the reference tests'
    1e-5."""
    x = torch.from_numpy(frames(n * 3 + lag, b * n + offset))[offset:]
    x = x.view(b, n)
    y = x if alias else torch.from_numpy(
        frames(n * 3 + lag + 1, b * n + offset))[offset:].view(b, n)
    out = torch.full((b, 2 * lag + 1), float("nan"))
    assert emulated_corr.emu_correlation(b, n, lag, x.data_ptr(),
                                         y.data_ptr(), out.data_ptr()) == 0
    close(out, dsp_vector.correlation(x, y, lag), TOL["correlation"])
