"""The image-compression slice held against the JAX reference: the image
program alone, and merged with the unrolled audio program so that the two
applications share one accelerator pool.

Both packages schedule under ``HtsParams(mem_words=4096,
tracker_entries=128)``, as the reference's ``benchmarks/extensions.py``
and ``tests/test_extensions.py`` run these programs.  Inputs are made from
a seed with numpy; the JAX side runs its Pallas ops in interpret mode and
its golden oracle, the port runs on the CPU through the kernels' plain
versions.
"""
import math
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import repro.core.hts as jhts
from repro.core.hts import programs as jprograms
from repro.kernels import ops as jops

from repro_torch.core import hts as thts
from repro_torch.core.hts import programs as tprograms
from repro_torch.examples import dsp_pipeline as pipeline
from repro_torch.kernels import ops as tops

TOL = {"dct": 1e-4, "vector_max": 0, "vector_add": 0, "correlation": 1e-5,
       "vector_dot": 1e-5, "fft_256": 1e-3}
#: XLA's CPU backend flushes subnormal floats to zero, torch (and the CUDA
#: kernels, built without fast math) keep them: the exact kernels are
#: held to the reference's default ``assert_allclose`` up to that flush
SUBNORMAL = float(np.finfo(np.float32).tiny)
JPARAMS = jhts.HtsParams(mem_words=4096, tracker_entries=128)
#: program → (its bench in a package's ``programs``, golden cycles, live
#: tasks by function); the cycles and counts are the JAX golden oracle's
PROGRAMS = {
    "image": (lambda p: p.image_compression(6), 3380,
              {"dct": 6, "vector_max": 6, "correlation": 5,
               "vector_add": 6}),
    "shared": (lambda p: p.merge_benches([p.audio_straightline(2),
                                          p.image_compression(6)]), 37510,
               {"dct": 6, "vector_max": 6, "correlation": 6,
                "vector_add": 6, "fft_256": 4, "vector_dot": 6}),
}


@pytest.fixture(autouse=True)
def _one_thread():
    """Small eager ops: one intra-op thread is faster than eight."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiles(seed):
    return np.random.default_rng(seed).standard_normal((8, 64)).astype(
        np.float32)


def close(got, want, tol):
    if tol == 0:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=SUBNORMAL)
    else:
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_image_pipeline_matches_jax(name):
    """On 8 tiles of 64 pixels: the port's schedule equals the JAX golden
    oracle's, each executed task's output on the same input is within its
    kernel's tolerance of the reference's table, and the final outputs
    agree within 1e-3.  Largest absolute differences seen (torch 2.13 CPU,
    jax 0.9 interpret mode), per task: image: dct, vector_max and
    vector_add 0, correlation 1.1e-5 (within 1e-5 relative of its sums);
    shared: correlation 5.7e-6, fft_256 9.5e-7, vector_dot 1.2e-7,
    vector_max 0, and dct 3.4e-40 and vector_add 7.1e-40, subnormals that
    the JAX side flushes to zero.  Final output: 1.5e-8 in both; each
    task's renormalisation keeps the chain from growing them."""
    make, cycles, live = PROGRAMS[name]
    x0 = tiles(13 + len(name))
    r, executed, out = pipeline.run_pipeline(
        make(tprograms), torch.from_numpy(x0),
        params=pipeline.SHARED_PARAMS, device="cpu")
    g = jhts.run(make(jprograms), scheduler="hts_spec", n_fu=2,
                 params=JPARAMS, backend="golden")
    assert r.cycles == g.cycles == cycles
    assert r.schedule_tuple() == g.schedule_tuple()
    issued = sorted((t for t in g.schedule if not t.aborted),
                    key=lambda t: t.issue)
    assert executed == [(t.uid, t.func_name) for t in issued]
    counts: dict = {}
    for _uid, fname in executed:
        counts[fname] = counts.get(fname, 0) + 1
    assert counts == live

    ttable, jtable = tops.dsp_dispatch_table(), jops.dsp_dispatch_table()
    xt, xj = torch.from_numpy(x0), jnp.asarray(x0)
    for _uid, fname in executed:
        got = ttable[fname](xt)
        assert got.shape == (8, 64)
        close(got, jtable[fname](jnp.asarray(xt.numpy())), TOL[fname])
        xt = pipeline.renormalise(got)
        xj = jtable[fname](xj)
        xj = xj / jnp.maximum(jnp.max(jnp.abs(xj)), 1e-6)
    assert torch.equal(xt, out)
    assert bool(torch.isfinite(out).all())
    close(out, xj, 1e-3)


def test_image_program_under_default_params_runs_as_the_jax_machine():
    """Under ``HtsParams()`` the image program's regions (from word 0x800)
    lie past the 1280 memory words.  Both golden oracles raise
    ``IndexError``; the JAX machine clamps the out-of-range memory reads,
    as its gathers do, and runs on.  The port's machine, and so
    ``run_pipeline``, does exactly what the JAX machine does (same cycles
    and schedule): no fix and no new check of its own."""
    with pytest.raises(IndexError, match="2056"):
        jhts.run(jprograms.image_compression(6), backend="golden")
    with pytest.raises(IndexError, match="2056"):
        thts.run(tprograms.image_compression(6), backend="golden")
    j = jhts.run(jprograms.image_compression(6), scheduler="hts_spec",
                 n_fu=2)
    r, executed, out = pipeline.run_pipeline(
        tprograms.image_compression(6), torch.from_numpy(tiles(3)),
        device="cpu")
    assert r.cycles == j.cycles
    assert r.schedule_tuple() == j.schedule_tuple()
    assert bool(torch.isfinite(out).all())


def test_main_runs_the_shared_program(capsys):
    pipeline.main(["--program", "shared", "--bands", "2", "--tiles", "6",
                   "--frames", "8", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "in 37510 cycles" in text
    assert len(re.findall(r"^  task ", text, re.M)) == 34
    stats = re.search(r"mean=(\S+) std=(\S+)", text)
    assert stats and all(math.isfinite(float(v)) for v in stats.groups())
