"""End-to-end DSP pipeline: the port's HTS schedule executes the Hopper DSP
kernels.

Counterpart of the reference's ``examples/dsp_pipeline.py`` and of its
``benchmarks/paper_figs.py`` ``table2``.  A program is built with the
Program Builder, scheduled by the port's cycle-level machine
(``api.run``, a population of one), and then each issued, non-aborted task
runs its accelerator kernel (``kernels/dsp_*.py``, CUDA in
``csrc/dsp.cu``) over one batch of frames, in issue order, renormalising
the batch after each task.  This is the full loop: builder → ISA → OoO
schedule → Function accelerators.  Five programs:

* ``audio``: the audio-compression program (paper Algorithm 1) on
  (frames, 256) audio frames, under ``HtsParams()``;
* ``image``: ``image_compression(tiles)`` (DCT → vector_max → correlation
  → vector_add per 8×8 tile, the paper's Fig 2 example) on (frames, 64)
  tiles, under :data:`SHARED_PARAMS`;
* ``shared``: the unrolled audio program merged with the image program,
  the two applications sharing one accelerator pool (the reference's
  ``multi_app_sharing`` pairing), under :data:`SHARED_PARAMS`.  Its merged
  schedule runs on the one frame batch, task by task, as the reference's
  example runs any schedule; no stream per application;
* ``synthetic --bench NAME``: one of the paper's nine synthetic benchmarks
  (``programs.ALL_SYNTHETIC``, Figs 7 and 8, all ten Table II functions in
  their task mix) on (frames, 40) frames, Table II's dataframe, under
  ``HtsParams()``;
* ``table2``: no schedule — each of the ten dispatch entries once, at its
  Table II frame (:func:`table_ii`).

    python -m repro_torch.examples.dsp_pipeline --bands 8 --frames 65536
    python -m repro_torch.examples.dsp_pipeline --program shared \\
        --bands 2 --tiles 40 --frames 262144
    python -m repro_torch.examples.dsp_pipeline --program synthetic \\
        --bench random_dependency --frames 524288
    python -m repro_torch.examples.dsp_pipeline --program table2 \\
        --frames 524288
    PYTHONPATH=src python -m repro_torch.examples.dsp_pipeline \\
        --program shared --bands 2 --tiles 6 --frames 8 --device cpu

``--device`` defaults to the CUDA card (and raises without one);
``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..core.hts import api, machine, programs
from ..core.hts.costs import FUNCTIONS
from ..core.hts.golden import HtsParams
from ..kernels import ops

#: the capacities the image program needs (its regions start at word
#: 0x800, past the default 1280 memory words), as the reference's
#: ``benchmarks/extensions.py:16`` runs it
SHARED_PARAMS = HtsParams(mem_words=4096, tracker_entries=128)
#: the synthetic benchmarks by name (``programs.ALL_SYNTHETIC``)
SYNTHETIC = {gen.__name__: gen for gen in programs.ALL_SYNTHETIC}
#: Table II's dataframe: the synthetic programs run on frames this wide
TABLE_II_SAMPLES = 40


@dataclasses.dataclass(frozen=True)
class TaskCheck:
    """One executed task held against the plain table on the same input
    batch: ``max_err`` is the largest ``|kernel - plain|``, ``max_scaled``
    the largest ``|kernel - plain| / (1 + |plain|)`` (so the two agree
    within ``tol`` in ``allclose(rtol=tol, atol=tol)``'s sense exactly when
    ``max_scaled <= tol``); ``input_zero`` and ``output_zero`` say whether
    the task's input batch and its entry's output were all zeros."""
    uid: int
    func: str
    max_err: float
    max_scaled: float
    input_zero: bool
    output_zero: bool


def issued_tasks(result: api.Result) -> list[api.TaskRow]:
    """The tasks that ran: non-aborted, in issue order (ties keep the
    schedule's uid order)."""
    return sorted((t for t in result.schedule if not t.aborted),
                  key=lambda t: t.issue)


def renormalise(x: torch.Tensor) -> torch.Tensor:
    """``x / max(max|x|, 1e-6)`` over the whole batch: raw filter chains
    amplify without bound."""
    return x / torch.clamp(x.abs().max(), min=1e-6)


def _check(task, x: torch.Tensor, got: torch.Tensor,
           want: torch.Tensor) -> TaskCheck:
    if got.shape != want.shape:
        raise ValueError(f"task {task.uid} ({task.func_name}): entry gave "
                         f"{tuple(got.shape)}, the plain entry "
                         f"{tuple(want.shape)}")
    diff = (got - want).abs()
    return TaskCheck(uid=task.uid, func=task.func_name,
                     max_err=float(diff.max()),
                     max_scaled=float((diff / (1 + want.abs())).max()),
                     input_zero=not bool(x.any()),
                     output_zero=not bool(got.any()))


def execute(tasks, x: torch.Tensor, table, checks=None) -> torch.Tensor:
    """Run each task's op on the frame batch in order, renormalising after
    each.  Given a list as ``checks``, each task's entry also runs through
    :func:`~repro_torch.kernels.ops.plain_dispatch_table` on the same
    input batch, and one :class:`TaskCheck` per task is appended."""
    plain = ops.plain_dispatch_table() if checks is not None else None
    for t in tasks:
        got = table[t.func_name](x)
        if plain is not None:
            checks.append(_check(t, x, got, plain[t.func_name](x)))
        x = renormalise(got)
    return x


def run_pipeline(bench, x, *, params=HtsParams(), device=None, checks=None):
    """Schedule ``bench`` on the port's machine (``hts_spec``, two units a
    class, capacities ``params``) and execute its issued tasks through the
    kernels' :func:`~repro_torch.kernels.ops.dsp_dispatch_table` on the
    (B, N) float32 frames ``x`` (``checks``: as :func:`execute`).

    ``device=None`` is the CUDA card (raises without one).  Returns
    ``(result, [(uid, func_name), ...], output)``.
    """
    dev = machine.resolve_device(device)
    x = torch.as_tensor(x, device=dev)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"frames must be (B, N) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    result = api.run(bench, scheduler="hts_spec", n_fu=2, params=params,
                     device=dev)
    tasks = issued_tasks(result)
    out = execute(tasks, x, ops.dsp_dispatch_table(), checks)
    return result, [(t.uid, t.func_name) for t in tasks], out


def table_ii_frames(batch: int, seed: int) -> dict[str, np.ndarray]:
    """Each Table II function's own (batch, frame) float32 frames, drawn in
    ``costs.FUNCTIONS`` order from one numpy generator seeded ``seed``."""
    rng = np.random.default_rng(seed)
    return {name: rng.standard_normal((batch, frame), np.float32)
            for name, (_fid, frame, _cyc) in FUNCTIONS.items()}


def table_ii(batch: int, seed: int = 0, device=None) -> dict:
    """The paper's Table II on the kernels: each of the ten dispatch
    entries (:func:`~repro_torch.kernels.ops.dsp_dispatch_table`) once, on
    its own :func:`table_ii_frames` at its Table II frame (40 samples; 256
    for ``fft_256``; 64 for ``dct``); the entries are not chained.

    Returns ``name → (output, seconds)``: the host wall clock of the one
    call, synchronised on the card.  ``device=None`` is the CUDA card."""
    dev = machine.resolve_device(device)
    table = ops.dsp_dispatch_table()
    out = {}
    for name, frames in table_ii_frames(batch, seed).items():
        x = torch.from_numpy(frames).to(dev)
        _sync(dev)
        t0 = time.perf_counter()
        y = table[name](x)
        _sync(dev)
        out[name] = (y, time.perf_counter() - t0)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program", choices=("audio", "image", "shared",
                                          "synthetic", "table2"),
                    default="audio")
    ap.add_argument("--bench", choices=sorted(SYNTHETIC),
                    default="random_dependency",
                    help="the synthetic program (with --program synthetic)")
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--tiles", type=int, default=40)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    if args.program == "table2":
        for name, (y, sec) in table_ii(args.frames, 0, args.device).items():
            _fid, frame, cyc = FUNCTIONS[name]
            print(f"  {name:<13} frame {frame:>3}  {args.frames} frames in "
                  f"{sec * 1e3:9.3f} ms  (paper: {cyc} cycles a frame)  "
                  f"max|y| {float(y.abs().max()):.4g}  on {y.device}")
            if not bool(torch.isfinite(y).all()):
                raise SystemExit(f"{name}: output is not finite")
        return

    params, width = SHARED_PARAMS, 64
    if args.program == "synthetic":
        bench = SYNTHETIC[args.bench]()
        params, width = HtsParams(), TABLE_II_SAMPLES
    elif args.program == "audio":
        bench = programs.audio_compression(args.bands, time_domain=False)
        params, width = HtsParams(), 256
    elif args.program == "image":
        bench = programs.image_compression(args.tiles)
    else:
        bench = programs.merge_benches([
            programs.audio_straightline(args.bands),
            programs.image_compression(args.tiles)])
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((args.frames, width),
                                             np.float32))
    r, executed, out = run_pipeline(bench, x, params=params,
                                    device=args.device)
    print(f"scheduled {r.n_tasks} tasks in {r.cycles} cycles "
          f"(aborted speculative: {r.spec_aborted}, "
          f"utilization {r.utilization:.1%}) on {out.device}")
    for uid, name in executed:
        print(f"  task {uid:>3} {name}")
    print("pipeline output stats: mean=%.4f std=%.4f"
          % (float(out.mean()), float(out.std())))
    if not bool(torch.isfinite(out).all()):
        raise SystemExit("pipeline output is not finite")


if __name__ == "__main__":
    main()
