"""End-to-end DSP pipeline: the port's HTS schedule executes the Hopper DSP
kernels.

Counterpart of the reference's ``examples/dsp_pipeline.py``.  A program
is built with the Program Builder, scheduled by the port's cycle-level
machine (``api.run``, a population of one), and then each issued,
non-aborted task runs its accelerator kernel (``kernels/dsp_*.py``, CUDA
in ``csrc/dsp.cu``) over one batch of frames, in issue order,
renormalising the batch after each task.  This is the full loop: builder
→ ISA → OoO schedule → Function accelerators.  Three programs:

* ``audio``: the audio-compression program (paper Algorithm 1) on
  (frames, 256) audio frames, under ``HtsParams()``;
* ``image``: ``image_compression(tiles)`` (DCT → vector_max → correlation
  → vector_add per 8×8 tile, the paper's Fig 2 example) on (frames, 64)
  tiles, under :data:`SHARED_PARAMS`;
* ``shared``: the unrolled audio program merged with the image program,
  the two applications sharing one accelerator pool (the reference's
  ``multi_app_sharing`` pairing), under :data:`SHARED_PARAMS`.  Its merged
  schedule runs on the one frame batch, task by task, as the reference's
  example runs any schedule; no stream per application.

    python -m repro_torch.examples.dsp_pipeline --bands 8 --frames 65536
    python -m repro_torch.examples.dsp_pipeline --program shared \\
        --bands 2 --tiles 40 --frames 262144
    PYTHONPATH=src python -m repro_torch.examples.dsp_pipeline \\
        --program shared --bands 2 --tiles 6 --frames 8 --device cpu

``--device`` defaults to the CUDA card (and raises without one);
``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.hts import api, machine, programs
from ..core.hts.golden import HtsParams
from ..kernels import ops

#: the capacities the image program needs (its regions start at word
#: 0x800, past the default 1280 memory words), as the reference's
#: ``benchmarks/extensions.py:16`` runs it
SHARED_PARAMS = HtsParams(mem_words=4096, tracker_entries=128)


def issued_tasks(result: api.Result) -> list[api.TaskRow]:
    """The tasks that ran: non-aborted, in issue order (ties keep the
    schedule's uid order)."""
    return sorted((t for t in result.schedule if not t.aborted),
                  key=lambda t: t.issue)


def renormalise(x: torch.Tensor) -> torch.Tensor:
    """``x / max(max|x|, 1e-6)`` over the whole batch: raw filter chains
    amplify without bound."""
    return x / torch.clamp(x.abs().max(), min=1e-6)


def execute(tasks, x: torch.Tensor, table) -> torch.Tensor:
    """Run each task's op on the frame batch in order, renormalising after
    each."""
    for t in tasks:
        x = renormalise(table[t.func_name](x))
    return x


def run_pipeline(bench, x, *, params=HtsParams(), device=None):
    """Schedule ``bench`` on the port's machine (``hts_spec``, two units a
    class, capacities ``params``) and execute its issued tasks through the
    kernels' :func:`~repro_torch.kernels.ops.dsp_dispatch_table` on the
    (B, N) float32 frames ``x``.

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
    out = execute(tasks, x, ops.dsp_dispatch_table())
    return result, [(t.uid, t.func_name) for t in tasks], out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--program", choices=("audio", "image", "shared"),
                    default="audio")
    ap.add_argument("--bands", type=int, default=4)
    ap.add_argument("--tiles", type=int, default=40)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    params, width = SHARED_PARAMS, 64
    if args.program == "audio":
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
