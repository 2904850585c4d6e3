#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all started together) and drives the port's paths on the card —
the population scheduler machine through ``run_many`` (one launch of the
persistent ``hts_run``); the audio, image
and shared pipelines, whose schedules run the DSP kernels; the paper's
evaluation (Table II, Figs 7, 8 and 10 through ``sweep``, the nine
synthetic schedules executed); Qwen2-1.5B at full width through
``prefill`` and the continuous-batching ``Server``; rwkv6-3b and zamba2-7b
at full width through ``forward`` and the ``Server`` — then checks them:

1. device and build: the card's name and power limit, the four kernel
   libraries' builds (time and ``-Xptxas -v`` report); the registers and
   spills of ``hts_run_kernel`` and of each instance of K5
   ``real_fir_packed<KT>``, K7 ``adaptive_fir_packed<K>``, K8
   ``iir_packed<MT>`` and ``iir_flat<MT>``, K12
   ``correlation_packed<LT>``, K13 ``fft_kernel<L>``, K14
   ``dct_kernel<C>``, bf16 K15 ``flash_attention_wgmma<DP>``, K16
   ``rmsnorm_vec<T, VPL>``/``rmsnorm_loop<T, VEC>``, K17's three kernels
   (``wkv6_chunk_state``, ``wkv6_state_passing``, ``wkv6_chunk_scan``)
   and K18's (``ssd_chunk_state``, ``ssd_state_passing``,
   ``ssd_chunk_scan``), and the ``HGMMA`` (tensor-core) instructions in
   K15's SASS: each bf16 instance must have them, each float32 one none;
2. kernels against plain: for the first 64 trips of the main-path
   population, and 64 trips from the middle of its run, every K1–K4 launch
   of the per-phase loop (``machine.step``) is checked against its plain
   torch version on a clone of the same carry (``torch.equal`` on every
   state array: the machine is int32/bool, the tolerance is zero); the run
   carries on from the kernel's result; K1–K4's launches are counted here
   (the kernels line's ``check_launches``, apart from the paths' counts:
   the main path launches them no time);
2c. persistent against per-phase: on the 1024 main-path lanes, every carry
   array after ``hts_run`` (``Machine.run_slice``, one launch a slice)
   equals the per-phase loop's (``machine._loop``, K1–K4 kernels) at
   budgets 1 and 16 from the start, at mid-run (half the slowest lane's
   steps) and at completion (from the start and resumed from mid-run); at
   budgets 1 and 16 also the plain per-phase loop's (``cuda_step.PLAIN``,
   plain torch); the per-phase loop's K1–K4 launches are counted;
3. main path: ``run_many`` on 1024 lanes at ``HtsParams()`` defaults,
   ``hts_spec``, ``n_fu=2``, event-skip on, over ``generate_scenario(seed)``
   for seeds 0..1023 (mixed priority / per-tenant frontends with arrivals /
   heterogeneous units / plain, by ``seed % 4``).  Every lane must halt
   without overflow, ``hts_run`` must launch once and K1–K4 not at all, and
   every 8th lane must match the golden oracle's cycles and schedule; the
   wall, scenarios/s, µs a step and, from a traced second run, the
   device's busy share are printed;
4. single lane: ``run`` on every paper bench under ``naive`` and
   ``hts_spec`` (one ``hts_run`` launch each), each against golden;
4b. specs past ``hts_run``'s limits (``rs_entries=128``; ``mem_words=
   60000``, a lane state past 227 KB of shared memory): ``run`` on the
   first three paper benches at each, equal to golden, through the
   per-phase loop on the card (``machine._advance`` chooses it by
   ``cuda_run.fits`` before any launch): ``hts_run`` must launch no time
   and each of K1–K4 at least once;
5. kernel times: each step kernel K1–K4 and its plain version timed with
   CUDA events on a mid-run carry of the main-path population, beside its
   bound; ``hts_run`` on a 16-step slice of the same carry (1024 lanes,
   and the slowest lane alone) against the plain per-phase loop, beside
   its bound (the arrays it holds in shared memory read and written once,
   the arguments read once, the trace elements the slice changes written
   once), with ptxas's registers
   and spills, its shared bytes and CTAs an SM
   (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); beside K1–K4's
   bytes bounds, the card's launch floor: the device time a launch of a
   one-element in-place ``add_`` (20 launches after 3 warm-ups);
6a. DSP kernels against plain: K5 ``real_fir`` (also at Table II's
   524288 frames of 40, rows of 2056 and 42 samples, 12 taps, and rows 4
   bytes off alignment), K9 ``vector_dot``, K12
   ``correlation`` and K13 ``fft`` at the audio pipeline's shape (65536
   frames of 256 samples, 8 taps, lag 4), K10 ``vector_add``, K11
   ``vector_max`` and K14 ``dct`` at the image pipeline's (262144 tiles of
   64 pixels), K6 ``complex_fir``, K7 ``adaptive_fir`` and K8 ``iir`` at
   Table II's (524288 frames of 40 samples) and at the JAX tests' shapes,
   all at ragged edge shapes too; K12 also at the image path's call
   (262144 × 64, lag 4, y the same tensor as x) and K7 at Table II's with
   d the same tensor as x (the dispatch entries' calls), each also at the
   shapes of their packed and flat kernels (threads a row, rows longer
   than a tile, rows 4 bytes off alignment); K8 likewise, and with
   filters of 9 and 12 coefficients (the flat kernel's generic
   instance); within the reference tests' tolerances (1e-5; 1e-4 for the DCT, with TF32 off for its plain
   version, and for K6–K8; 1e-3 for the FFT; K10 and K11 ``torch.equal``,
   also on rows 4 bytes off alignment, and K11 NaN where a row holds one);
   the
   ``complex_fir`` dispatch entry ``torch.equal`` to zeros;
6b. audio pipeline: ``audio_compression(8)``, both arms, scheduled on the
   card (equal to golden in cycles and schedule) and executed through
   ``run_pipeline`` on 65536 × 256 float32 frames; the schedule must take
   one ``hts_run`` launch, each DSP kernel must launch once per live task
   of its function, and the output must be
   finite and within 1e-3 of the same tasks run through the plain table;
7. image and shared pipelines: ``image_compression(40)``, and
   ``audio_straightline(2)`` merged with it (two applications sharing one
   accelerator pool), under ``SHARED_PARAMS``, scheduled on the card
   (equal to golden) and executed through ``run_pipeline`` on 262144 × 64
   float32 tiles (a 4096 × 4096 image in 8 × 8 tiles); ``audio_straightline
   (2)`` alone is scheduled too, for the sharing gain.  Each schedule
   must take one ``hts_run`` launch, DSP launches must
   equal live tasks, the output must be finite and within 1e-3 of the
   plain table's; the phase's peak device memory and each DSP kernel's
   device ms a launch inside the profiled schedules (K12's among them)
   are printed;
8. the paper's evaluation: (a) Table II — each of the ten dispatch
   entries once on 524288 frames at its Table II width, against the plain
   table, one launch each; (b) Figs 7 and 8 — the synthetic benchmarks
   under all four schedulers through ``sweep`` (Fig 7 at 1, 2 and 4 units
   a class, Fig 8 at 2), every point equal to golden, after the first 16
   trips of the Fig 7 ``hts_spec`` sweep's per-phase K1–K4 launches are
   held against their plain versions; (c) the nine synthetic schedules
   scheduled on the card (equal to golden, one ``hts_run`` launch each)
   and executed on 524288 × 40
   frames with every task's kernel entry held against its plain entry on
   the same input, launches equal to live tasks, frames/s; (d) Fig 10 —
   ``audio_compression`` at 8, 16 and 32 bands × 1–16 units, ``naive``
   and ``hts_spec``, one ``sweep``, the 8-band points equal to golden;
9. the model path, Qwen2-1.5B (28 layers, d_model 1536, 12 query and 2
   KV heads of 128, d_ff 8960, vocab 151936, QKV bias) with random
   bfloat16 weights from a seed: (a) K15 ``flash_attention`` and K16
   ``rmsnorm`` against their plain versions at the model's shapes, a
   ragged length of 1000, every head dim (112 too), ``q_offset`` and the decode
   shape, and at 8192, 32 and ragged rows of 1536, in bfloat16 (2e-2) and
   float32 (1e-5), q and k unscaled so that attention is peaked; (b)
   ``prefill`` of 4 × 2048 tokens into a 2560-position cache, then 32
   greedy ``decode_step``s, on the kernels (28 K15 and 57 K16 launches a
   prefill, 57 K16 a step) and on the plain ops (``plain_path``: the
   wrappers swapped for the plain versions, fed the kernel path's
   tokens), timed, their bfloat16 logits compared and reported (not
   gated: with random weights the scaled scores span ±300, attention is
   near one-hot, and any other rounding of S resolves near-ties otherwise
   through 28 layers); then two gates, each with a control that must fail
   it: (A) the same in float32 (the seed's draws unrounded), the
   prefill's and every decode step's logits on the kernels within
   ``FP32_LOGIT_TOL`` normwise of the plain ops', the control K15 swapped
   for the plain attention with its scaled scores rounded to bfloat16;
   (B) each of the 28 layers' attention inputs, caught in a bfloat16
   prefill on the plain ops, through K15 within its bf16 tolerance (2e-2)
   normwise of the plain attention, the same control beside it and
   SDPA's reading printed; (c) the ``Server``, 32
   slots of 512 positions, 64 requests (prompts of 16–128 tokens, 16–64
   new), under ``ooo`` and ``naive``: every request completes, 57 K16
   launches a step, ``ooo`` takes fewer steps; tokens/s, ms a step, a
   traced window's device busy share and peak memory are printed, and
   one staggered request against ``greedy_decode`` at B = 1 (not gated);
10. the ssm and hybrid families, rwkv6-3b (32 layers, d_model 2560, 40
   WKV heads of 64) and zamba2-7b (81 layers: 13 groups of 6 Mamba-2
   layers and a shared attention block, then 3; d_model 3584, 112 SSD
   heads of 64, attention head dim 112) with random weights from a seed,
   one model on the card at a time: (a) K17 ``wkv6`` and K18 ``ssd``
   against their plain versions at both models' forward shapes, the JAX
   tests' shapes and a ragged T of 1000 (K17 also at one step and at two
   chunks and one step, each with w as the JAX tests draw it and as the
   model makes it, exact 0 and 1 among them), in bfloat16 (rtol = atol = 2e-2)
   and float32 (1e-5 normwise), K15 at zamba2's head dim 112, and K16 at
   both forwards' and Servers' rows of 2560 and 3584 (2e-2, 1e-5), with
   the phase's peak device memory and K18's scratch at zamba2's shape; (b)
   ``forward`` on 2 × 1024 tokens: in bfloat16 on the kernels (32 K17 and
   65 K16 launches; 81 K18, 13 K15 and 108 K16; then timed five times
   more, the median printed), on the plain ops, and on
   the kernels but K16 (the bf16 floor: one exact op swapped), the
   divergences printed; then in float32, kernels against plain within
   the model's ``FP32_LOGIT_TOL`` normwise, the gate (the bf16 floor of
   these deep random-weight models is above any useful limit; the reading
   is printed beside the one before K18 was chunked), and a
   control, K17/K18 swapped for the plain recurrence with its state
   rounded to bfloat16, which must fail that gate; tokens/s and peak
   memory; (c) the
   ``Server``, 8 slots, 16 requests of 16 prompt and 16 new tokens: every
   request completes, 65 (108) K16 launches a step and no K15, K17 or
   K18 (decode is plain, as in the reference); ms a step and a traced
   window's busy share; (d) at the smoke configs in float32, ``forward``
   on the kernels against token-by-token ``decode_step`` over T = 100 at
   1e-3, the reference's own check;
5b. kernel times: device, call, plain and library times of the DSP
   kernels at each path's shape, of K15 and K16 at the prefill's (K15 and
   ``scaled_dot_product_attention`` at zamba2's too, K16 and ``rms_norm``
   at rwkv6's and zamba2's forward rows) and of K17 and K18 at the models'
   forward shapes (each one's device time the sum of its three kernels,
   split; their scratch bytes), K5 and ``conv1d`` also at Table II's 524288
   x 40, K12 and grouped ``conv1d`` also at the image path's call (262144
   x 64, y is x), K7 also with d is x, beside the bound (with the second
   array x itself, x read once; the bound reading it twice beside it).
   ``--only 5b`` times them
   all on their own (launches are counted only on the paths that ran).

The last lines are the card (``nvidia-smi``), one JSON object
``{"kernels": [...]}`` (the eighteen kernels and ``hts_run``), and
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without the last line; so does a machine without a card, or a directory
without the rest of the repository.  ``--only PREFIX ...`` runs the
build, the main path's set-up and the phases whose names start with a
prefix (``--only 2c``: ``hts_run`` against the per-phase loop; ``--only
3``: the main path; ``--only 9 "5b transformer"``: the dense model path;
``--only 10``: the ssm and hybrid families) and prints no kernels line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import math
import re
import shutil
import subprocess
import sys
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

LANES = 1024
DEVICE = "cuda"
GOLDEN_EVERY = 8
CHECK_TRIPS = 64
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (on-chip guide table)
FP32_OPS_PER_S = 67e12        # fp32 rate outside the tensor cores
INT32_OPS_PER_S = FP32_OPS_PER_S  # used as the 32-bit integer rate (no
                                  # table entry)
REPLACES = {
    "enqueue": "src/repro/core/hts/machine.py:1079",
    "grant": "src/repro/core/hts/machine.py:1082",
    "issue": "src/repro/core/hts/machine.py:1088",
    "traces": "src/repro/core/hts/machine.py:1092",
}
SOURCE = "src/repro_torch/csrc/hts_step.cu"
#: the persistent step loop: K1–K4 (which all reach this pallas_call) and
#: the phases between them
RUN_SOURCE = "src/repro_torch/csrc/hts_run.cu"
RUN_REPLACES = "src/repro/core/hts/pallas_step.py:87"
#: hts_run's timed slice (phase 5): steps from the mid-run carry
RUN_SLICE = 16
#: specs past hts_run's limits (phase 4b): an RS of 128 entries, and a
#: lane state past 227 KB of shared memory; the paper benches run at each
UNFIT_SPECS = {"rs_entries=128": dict(rs_entries=128),
               "mem_words=60000": dict(mem_words=60_000)}
UNFIT_BENCHES = 3

# the audio pipeline's DSP kernels (csrc/dsp.cu), by launch counter
DSP_SOURCE = "src/repro_torch/csrc/dsp.cu"
DSP_REPLACES = {
    "real_fir": "src/repro/kernels/dsp_fir.py:49",
    "complex_fir": "src/repro/kernels/dsp_fir.py:82",
    "adaptive_fir": "src/repro/kernels/dsp_fir.py:123",
    "iir": "src/repro/kernels/dsp_fir.py:160",
    "vector_dot": "src/repro/kernels/dsp_vector.py:22",
    "vector_add": "src/repro/kernels/dsp_vector.py:40",
    "vector_max": "src/repro/kernels/dsp_vector.py:57",
    "correlation": "src/repro/kernels/dsp_vector.py:83",
    "fft": "src/repro/kernels/dsp_spectral.py:78",
    "dct": "src/repro/kernels/dsp_spectral.py:110",
}
#: 1024 audio channels × 64 frames of 256 samples (64 MiB of float32,
#: beyond the 50 MB L2), the pipeline's 8 FIR taps and lag 4
FRAMES, SAMPLES, TAPS, MAX_LAG = 65536, 256, 8, 4
BANDS = 8
PIPELINE_SEED = 2019
#: 4096 × 4096 single-channel image in 8 × 8 tiles: 262144 tiles of 64
#: pixels (64 MiB of float32); the image program's 40 tiles; the audio
#: program it shares the pool with
TILES, PIXELS, IMAGE_TILES, SHARED_BANDS = 262144, 64, 40, 2
IMAGE_SEED = 2020
#: Table II and the synthetic schedules: 524288 frames of Table II's 40
#: samples (80 MiB of float32, past the 50 MB L2); the LMS step and the
#: IIR coefficients of the dispatch entries (b, a), and the JAX tests' IIR
TABLE_FRAMES, TABLE_SAMPLES = 524288, 40
TABLE_SEED, SYNTH_SEED = 2021, 2022
LMS_MU = 0.01
ENTRY_IIR = ([0.2, 0.3], [1.0, -0.5])
TEST_IIR = ([0.2, 0.3, 0.1], [1.0, -0.4, 0.05])
#: a filter past the 8 coefficients K8 keeps in registers (sum |a[1:]| =
#: 0.73: stable)
LONG_IIR = ([0.3, -0.2, 0.15, 0.1, -0.05, 0.05, 0.02, -0.02, 0.01],
            [1.0, -0.3, 0.1, 0.1, -0.05, 0.05, -0.04, 0.03, 0.02, -0.02,
             0.01, 0.01])
#: 0 is torch.equal (NaN where the plain version has NaN)
DSP_TOL = {"real_fir": 1e-5, "complex_fir": 1e-4, "adaptive_fir": 1e-4,
           "iir": 1e-4, "vector_dot": 1e-5, "vector_add": 0,
           "vector_max": 0, "correlation": 1e-5, "fft": 1e-3, "dct": 1e-4}
#: the same per dispatch entry (by Table II name)
ENTRY_TOL = {("fft_256" if k == "fft" else k): v for k, v in DSP_TOL.items()}
#: the golden oracle's cycles of the nine synthetic schedules
#: (``HtsParams()``, ``hts_spec``, two units a class)
SYNTH_CYCLES = {
    "no_dependency": 18692, "same_dependency": 21932,
    "diff_dependency": 20503, "random_dependency": 39813,
    "loop_no_dependency": 17560, "loop_dependency": 28476,
    "branch_taken_no_dep": 18880, "branch_not_taken_no_dep": 4390,
    "branch_taken_dependency": 19434}
FIG7_FU = (1, 2, 4)
FIG8_FU = (2,)
FIG10_BANDS = (8, 16, 32)
FIG10_FU = (1, 2, 4, 8, 16)
SWEEP_CHECK_TRIPS = 16
PIPELINE_TOL = 1e-3
EXEC_REPS = 5          # timed executions of each schedule (median kept)
#: (B, N, taps or lag) per kernel: the pipeline's shape, then ragged edges
DSP_CASES = {
    "real_fir": [(FRAMES, SAMPLES, TAPS), (TABLE_FRAMES, TABLE_SAMPLES, 8),
                 (1, 40, 8), (300, 40, 5), (300, 256, 8), (7, 2056, 8),
                 (300, 42, 8), (33, 40, 12)],
    "complex_fir": [(TABLE_FRAMES, TABLE_SAMPLES, 8), (1, 40, 8),
                    (64, 40, 8), (1, 96, 12), (64, 96, 12), (300, 40, 8)],
    "adaptive_fir": [(TABLE_FRAMES, TABLE_SAMPLES, 8), (1, 40, 8),
                     (32, 40, 8), (1, 64, 4), (32, 64, 4), (300, 40, 8),
                     (5, 136, 8), (260, 200, 4), (7, 42, 8)],
    "iir": [(TABLE_FRAMES, TABLE_SAMPLES, ENTRY_IIR), (1, 40, TEST_IIR),
            (33, 40, TEST_IIR), (1, 80, TEST_IIR), (33, 80, TEST_IIR),
            (300, 40, ENTRY_IIR), (5, 136, ENTRY_IIR), (260, 200, TEST_IIR),
            (7, 42, TEST_IIR), (130, 80, LONG_IIR)],
    "vector_dot": [(FRAMES, SAMPLES, None), (1, 40, None), (300, 40, None),
                   (300, 256, None)],
    "correlation": [(FRAMES, SAMPLES, MAX_LAG), (TILES, PIXELS, MAX_LAG),
                    (1, 40, 4), (300, 40, 10), (300, 256, 4), (130, 128, 10),
                    (3, 1024, 10), (9, 42, 4), (7, 64, 0)],
    "fft": [(FRAMES, SAMPLES, None), (1, 256, None), (300, 256, None),
            (300, 64, None)],
    "vector_add": [(TILES, PIXELS, None), (1, 40, None), (300, 64, None),
                   (300, 256, None), (7, 40, None)],
    "vector_max": [(TILES, PIXELS, None), (1, 40, None), (300, 64, None),
                   (300, 256, None), (7, 40, None)],
    "dct": [(TILES, PIXELS, None), (1, 40, None), (300, 64, None),
            (65, 128, None), (7, 40, None)],
}
#: the same with the second array the first (y is x, d is x), as the
#: dispatch entries call K12 and K7: the image path's shape first
ALIAS_CASES = {
    "correlation": [(TILES, PIXELS, MAX_LAG), (300, 64, 4), (70, 256, 4),
                    (33, 40, 10), (3, 1024, 10), (9, 42, 4)],
    "adaptive_fir": [(TABLE_FRAMES, TABLE_SAMPLES, 8), (300, 40, 8),
                     (130, 64, 4), (5, 136, 8), (7, 42, 8)],
}
#: the shape each DSP kernel is timed at (phase 5b): its pipeline's
DSP_SHAPE = {"vector_add": (TILES, PIXELS), "vector_max": (TILES, PIXELS),
             "dct": (TILES, PIXELS),
             "complex_fir": (TABLE_FRAMES, TABLE_SAMPLES),
             "adaptive_fir": (TABLE_FRAMES, TABLE_SAMPLES),
             "iir": (TABLE_FRAMES, TABLE_SAMPLES)}
#: more shapes each is timed at (phase 5b), beside its row's: (B, N, taps
#: or lag, second array the first): K5 at Table II's, K12 at the image
#: path's call (y is x), K7 at Table II's with d is x
DSP_EXTRA = {"real_fir": [(TABLE_FRAMES, TABLE_SAMPLES, 8, False)],
             "correlation": [(TILES, PIXELS, MAX_LAG, True)],
             "adaptive_fir": [(TABLE_FRAMES, TABLE_SAMPLES, 8, True)]}
#: the kernel a DSP wrapper launches, as the profiler names it (a
#: substring), where it is not ``<name>_kernel``: K5's, K7's, K8's and
#: K12's packed and flat kernels (one of them a call)
DSP_KERNEL = {"real_fir": "real_fir_", "adaptive_fir": "adaptive_fir_",
              "iir": "iir_", "correlation": "correlation_"}
#: taps, lag or (b, a) per kernel in phase 5b
DSP_PARAM = {"real_fir": TAPS, "complex_fir": 8, "adaptive_fir": 8,
             "iir": ENTRY_IIR, "correlation": MAX_LAG}
#: live tasks per DSP kernel in the 8-band audio schedules, by time_domain
LIVE_8_BANDS = {False: {"correlation": 1, "fft": 16, "vector_dot": 24},
                True: {"correlation": 1, "real_fir": 24}}
#: live tasks per DSP kernel in the image and shared schedules (golden)
LIVE_IMAGE = {"dct": 40, "vector_max": 40, "correlation": 39,
              "vector_add": 40}
LIVE_SHARED = {"dct": 40, "vector_max": 40, "correlation": 40,
               "vector_add": 40, "fft": 4, "vector_dot": 6}
#: golden cycles: the image program, the audio program alone, both shared
CYCLES = {"image": 18238, "audio": 37509, "shared": 37510}

# the model path (phase 9): K15 and K16 (csrc/transformer.cu)
TF_SOURCE = "src/repro_torch/csrc/transformer.cu"
TF_REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm.py:24",
               "flash_attention": "src/repro/kernels/attention.py:92",
               "wkv6": "src/repro/kernels/rwkv6.py:65",
               "ssd": "src/repro/kernels/mamba2.py:61"}
#: the kernel a transformer wrapper launches in bfloat16 (the dtype 5b
#: times), as the profiler names it (a substring), where it is not
#: ``<name>_kernel``: bf16 K15 and K16's register path at the models'
#: widths; K17 and K18 launch three each (``SPLIT_KERNELS``)
TF_KERNEL = {"flash_attention": "flash_attention_wgmma",
             "rmsnorm": "rmsnorm_vec"}
#: the kernels K17 and K18 each launch once a call, whose times 5b sums
SPLIT_KERNELS = {
    "wkv6": ("wkv6_chunk_state", "wkv6_state_passing", "wkv6_chunk_scan"),
    "ssd": ("ssd_chunk_state", "ssd_state_passing", "ssd_chunk_scan")}
BF16_TENSOR_OPS_PER_S = 989e12   # bf16 tensor cores, dense (on-chip guide)
ARCH = "qwen2-1.5b"
MODEL_SEED = 2024
#: prefill: 4 prompts of 2048 tokens into a 2560-position cache, then 32
#: greedy decode steps from it
PREFILL_B, PREFILL_T, PREFILL_MAX_LEN, DECODE_STEPS = 4, 2048, 2560, 32
#: the Server: 32 slots of 512 positions, 64 requests with prompts of
#: 16–128 tokens and 16–64 new tokens each, a traced window of 8 steps
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS = 32, 512, 64
PROMPT_LEN, MAX_NEW = (16, 128), (16, 64)
SERVE_SEED, TRACE_STEPS, STAGGERED = 2025, 8, 40
#: kernel against plain, by dtype: (rmsnorm, flash_attention)
TF_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
#: K15 cases (BH, Tq, Tk, D, causal, q_offset): the prefill's shape, a
#: ragged 1000, each head dim, q_offset, the decode shape
ATTN_CASES = [(48, 2048, 2048, 128, True, 0), (24, 1000, 1000, 128, True, 0),
              (24, 1000, 1000, 128, False, 0), (12, 1000, 1000, 64, True, 0),
              (12, 1000, 1000, 32, False, 0), (12, 1000, 1000, 112, True, 0),
              (12, 64, 300, 128, True, 236), (12, 1, 77, 128, True, 76),
              (7, 200, 200, 32, True, 0)]
#: K16 cases (R, D): the prefill's rows, the Server's, ragged rows
RMS_CASES = [(8192, 1536), (32, 1536), (33, 1536), (7, 100), (300, 1536)]

# the ssm and hybrid families (phase 10): K17 and K18 (csrc/transformer.cu),
# with K15 and K16 in zamba2's path
SSM_ARCHS = ("rwkv6-3b", "zamba2-7b")
#: forward over 2 sequences of 1024 tokens, kernels and plain
SSM_B, SSM_T = 2, 1024
#: the Server: 8 slots of 64 positions, 16 requests of 16 prompt tokens
#: (equal lengths: these families decode at one position) and 16 new
#: tokens, a traced window of 4 steps
SSM_SLOTS, SSM_MAX_LEN, SSM_REQUESTS, SSM_PROMPT, SSM_NEW = 8, 64, 16, 16, 16
SSM_TRACE_STEPS = 4
#: the float32 logic check: smoke configs, forward against token-by-token
#: decode over T = 100 (past a multiple of the kernels' 32-step staging
#: and of the reference's 64-step chunk) at rtol = atol = 1e-3
SSM_LOGIC_T, SSM_LOGIC_TOL = 100, 1e-3
#: synchronised bf16 forwards on the kernels timed after the first (10b),
#: the median kept: one forward's wall varies by a fifth from run to run
SSM_FORWARD_REPS = 5
#: K17 cases (B, T, H, K, V): rwkv6-3b's forward, the JAX tests', a ragged
#: T, one step, one past two chunks; each with w drawn as the JAX tests
#: draw it and as the model makes it (``WKV_DECAYS``); K18 cases (B, T, H,
#: P, N): zamba2-7b's forward, the JAX tests', a ragged T; K15 at
#: zamba2-7b's head dim 112, its forward's shape
WKV_CASES = [(2, 1024, 40, 64, 64), (1, 64, 2, 32, 32), (2, 128, 4, 64, 64),
             (1, 96, 1, 64, 128), (2, 1000, 40, 64, 64), (1, 1, 2, 64, 64),
             (1, 129, 4, 64, 64)]
WKV_DECAYS = ("drawn", "model")
SSD_CASES = [(2, 1024, 112, 64, 64), (1, 64, 2, 32, 16), (2, 128, 4, 64, 64),
             (1, 80, 3, 16, 32), (2, 1000, 112, 64, 64), (1, 65, 3, 64, 64),
             (1, 1, 2, 32, 16)]
ATTN_112 = (64, 1024, 1024, 112, True, 0)
#: K16 cases (R, D) at these paths' widths: each forward's 2 × 1024 rows
#: and each Server's 8 slots, at d_model 2560 and 3584
RMS_SSM_CASES = [(2048, 2560), (2048, 3584), (8, 2560), (8, 3584)]
#: float32 logits, kernels against plain, normwise (largest difference
#: over the largest plain logit), by model: each limit lies between the
#: kernels' reading and the control's, which must fail it (PERF.md §6).
#: The controls: for rwkv6-3b and zamba2-7b K17/K18 swapped for the plain
#: recurrence with its state rounded to bfloat16 (10b); for Qwen2-1.5B K15
#: swapped for the plain attention with its scaled scores rounded to
#: bfloat16 (9b, prefill and every decode step)
FP32_LOGIT_TOL = {"rwkv6-3b": 1e-3, "zamba2-7b": 0.1, "qwen2-1.5b": 1e-2}
#: 10b's float32 reading on the kernels before K17 and K18 were chunked
#: (a CTA a (sequence, head), PERF.md §6): printed beside this run's
FP32_LOGIT_BEFORE = {"rwkv6-3b": 2.58e-5, "zamba2-7b": 0.0154}
#: K17/K18 against plain: float32 normwise (largest difference over the
#: largest plain magnitude; the sums run in another order), bfloat16
#: rtol = atol (about one output ulp)
REC_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else f"nvidia-smi failed: {out.stderr.strip()}"


def main_population(workloads, batch):
    """The main path's 1024 scenarios, packed: (pack, programs, fu_cost)."""
    progs, fu_cost = [], []
    for seed in range(LANES):
        kind = seed % 4
        if kind == 0:
            sc = workloads.generate_scenario(seed, mixed_priority=True)
            progs.append(sc.merged)
        elif kind == 1:
            sc = workloads.generate_scenario(seed, frontends=True,
                                             arrivals=True)
            progs.append(sc.multi)
        elif kind == 2:
            sc = workloads.generate_scenario(seed, heterogeneous_fus=True)
            progs.append(sc.merged)
        else:
            sc = workloads.generate_scenario(seed)
            progs.append(sc.merged)
        fu_cost.append(sc.fu_cost if kind == 2 else None)
    pop = batch.pack_population(progs, n_fu=2, fu_cost=fu_cost)
    return pop, progs, fu_cost


class CheckedOps:
    """K1–K4 for ``machine.step``: each launch is held against its plain
    version on clones of the same carry and arguments; the kernel's result
    is what the run carries on with.  Keeps, per kernel, the largest
    absolute difference seen and the inputs of the last call."""

    def __init__(self, torch, cuda_step):
        self.torch, self.cs = torch, cuda_step
        self.max_err = {k: 0 for k in cuda_step.KERNELS}
        self.saved: dict = {}
        self.checks = 0

    def _run(self, name, st, *args):
        torch = self.torch
        wrapper, plain, _keys = self.cs.KERNELS[name]
        clone = lambda x: x.clone() if torch.is_tensor(x) else x  # noqa
        self.saved[name] = ({k: v.clone() for k, v in st.items()},
                            tuple(clone(a) for a in args))
        ref_st = {k: v.clone() for k, v in st.items()}
        ref_args = tuple(clone(a) for a in args)
        plain(ref_st, *ref_args)
        wrapper(st, *args)
        pairs = [(k, st[k], ref_st[k]) for k in st]
        pairs += [(f"arg{i}", a, b) for i, (a, b) in
                  enumerate(zip(args, ref_args)) if torch.is_tensor(a)]
        for k, got, want in pairs:
            if not torch.equal(got, want):
                diff = int((got.long() - want.long()).abs().max())
                self.max_err[name] = max(self.max_err[name], diff)
                raise AssertionError(f"{name}: {k} differs from the plain "
                                     f"version (max abs err {diff})")
        self.checks += 1

    def enqueue(self, st, *a):
        self._run("enqueue", st, *a)

    def grant(self, st, *a):
        self._run("grant", st, *a)

    def issue(self, st, *a):
        self._run("issue", st, *a)

    def traces(self, st, *a):
        self._run("traces", st, *a)


READS = {   # arrays each kernel must read whole (per lane), for its bound
    "enqueue": ("cdb_valid", "fu_uid", "fu_spec", "ticket", "overflow",
                "cycle"),
    "grant": ("cdb_valid", "cdb_ready", "cdb_ticket", "rs_dep", "trk_uid",
              "cycle", "br_active", "br_kind", "br_wait"),
    "issue": ("rs_valid", "rs_dep", "rs_pid", "rs_age", "rs_func", "rs_uid",
              "rs_exec", "rs_out_s", "rs_out_e", "rs_src", "rs_spec",
              "fu_busy", "fu_pid", "cycle"),
    "traces": ("cycle",),
}


def bound_of(torch, name, st0, args, st1, args1):
    """Least time for the in-place function on these inputs: the arrays it
    must read, read once, plus the words it changed, written once, over
    HBM bandwidth; against its integer operations at the 32-bit rate."""
    read = sum(st0[k].numel() * st0[k].element_size() for k in READS[name])
    read += sum(a.numel() * a.element_size() for a in args
                if torch.is_tensor(a))
    wrote = sum(int((st0[k] != st1[k]).sum()) * st0[k].element_size()
                for k in st0)
    wrote += sum(int((a != b).sum()) * a.element_size()
                 for a, b in zip(args, args1) if torch.is_tensor(a))
    n, S = st0["rs_valid"].shape
    NFU, C = st0["fu_busy"].shape[1], st0["cdb_valid"].shape[1]
    ops = {"enqueue": n * (3 * C + 4 * NFU),
           "grant": n * 4 * C,
           "issue": n * (6 * S * S + 5 * S * NFU + 3 * NFU * NFU // 10),
           "traces": n * 3 * (S + NFU)}[name]
    bytes_ms = (read + wrote) / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def _copies(torch, saved, n):
    """``n`` fresh copies of saved phase inputs (the phases work in place,
    so every call gets its own, made before any timed window)."""
    st0, args0 = saved
    return [({k: v.clone() for k, v in st0.items()},
             tuple(a.clone() if torch.is_tensor(a) else a for a in args0))
            for _ in range(n)]


def phase_calls(torch, fn, saved, n=23):
    """``n`` calls of an in-place phase, each on its own copy of the saved
    inputs (copies made before any timed window)."""
    return [functools.partial(fn, st, *a) for st, a in _copies(torch, saved, n)]


def events_ms(torch, calls, warm=3):
    """Mean ms per call over ``calls`` (zero-argument callables) after the
    first ``warm``, CUDA events around the rest: host work of the call
    (checks, launch) included wherever the device waits on it."""
    for c in calls[:warm]:
        c()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for c in calls[warm:]:
        c()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / (len(calls) - warm)


def traced_calls(torch, calls, warm=3):
    """The device activities of ``calls`` after the first ``warm``
    (torch.profiler's CUPTI trace, through ``trace_window``: a trace drops
    the device activities at the start of its window, so the calls run
    once as its discarded warm-up step and once as the counted one); None
    when the profiler is unavailable."""
    for c in calls[:warm]:
        c()

    def run():
        for c in calls[warm:]:
            c()
    try:
        events, _wall = trace_window(torch, run, run)
    except (RuntimeError, AssertionError, AttributeError) as e:
        log(f"profiler unavailable ({e}): device time not measured")
        return None
    return events


def profiled_ms(torch, calls, kernel: str, warm=3):
    """Mean device time per launch of ``kernel`` (a substring of the
    profiler's name) over ``calls`` after the first ``warm``; None when the
    profiler or its trace has no device time."""
    events = traced_calls(torch, calls, warm)
    times = [us for key, us in events or () if kernel in key]
    return sum(times) / len(times) / 1e3 if times else None


def profiled_call_ms(torch, calls, warm=3):
    """Device ms a call of ``calls`` (a library call, whose kernels' names
    are not ours) after the first ``warm``: each kernel's mean time a
    launch times its launches per launch of the most frequent one (a trace
    can drop activities, so only the counts' ratios are trusted); None
    without a trace."""
    events = traced_calls(torch, calls, warm)
    if not events:
        return None
    by_name: dict = {}
    for key, us in events:
        by_name.setdefault(key, []).append(us)
    top = max(len(v) for v in by_name.values())
    return sum(sum(v) / top for v in by_name.values()) / 1e3


def profiled_split(torch, calls, kernels, warm=3):
    """Mean device ms a launch of each of ``kernels`` (substrings of the
    profiler's names; an entry that launches each once a call) over
    ``calls`` after the first ``warm``; None when one has no device
    time."""
    events = traced_calls(torch, calls, warm) or ()
    split = {}
    for k in kernels:
        times = [us for key, us in events if k in key]
        if not times:
            return None
        split[k] = sum(times) / len(times) / 1e3
    return split


def device_events(prof):
    """(name, µs) of every device-side activity in a profile: kernels,
    copies and sets.  Counting these, and not the host ops that launched
    them, counts each microsecond of device work once.  A profiler
    schedule's ``ProfilerStep*`` range also lands on the device timeline;
    it spans the step, not device work, and is left out."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")]


def trace_window(torch, warm, run):
    """Device activities of ``run()`` and its host wall (µs), traced as the
    active step of a profiler schedule after ``warm()`` ran as its
    discarded warm-up step: a trace drops device activities at the start
    of its window (seen: a schedule's first task missing), so the window
    that counts starts with the tracer already running."""
    from torch.profiler import ProfilerActivity, profile, schedule
    out: dict = {}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: out.update(
                     events=device_events(p))) as prof:
        warm()
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        prof.step()
    if "events" not in out:
        raise RuntimeError("the profiler delivered no trace")
    return out["events"], wall_us


def trip_profile(torch, machine, m, st, a, trips=32):
    """Where a trip's time goes, over ``trips`` steps of a mid-run carry:
    wall per trip, device busy time per trip, device activities per trip,
    and the costliest kernels."""
    limit = torch.full_like(st["steps"], machine.BIG)

    def steps(n):
        for _ in range(n):
            machine.step(m, st, a, limit)

    events, wall_us = trace_window(torch, lambda: steps(4),
                                   lambda: steps(trips))
    busy_us = sum(us for _key, us in events)
    return (wall_us / trips, busy_us / trips, len(events) / trips,
            costliest(events, trips))


def costliest(events, per=1, n=8):
    """The ``n`` costliest device activities by name: (name, µs per ``per``,
    count per ``per``)."""
    by_name: dict = {}
    for key, us in events:
        tot, cnt = by_name.get(key, (0.0, 0))
        by_name[key] = (tot + us, cnt + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:n]
    return [(key[:60], tot / per, cnt // per) for key, (tot, cnt) in top]


# ---------------------------------------------------------------------------
# the DSP kernels (K5, K9–K14) and the audio, image and shared pipelines
# ---------------------------------------------------------------------------
def dsp_case(torch, kern, name, b, n, p, seed, alias=False):
    """(wrapper, plain version, args) of one call of DSP kernel ``name`` on
    float32 frames made from ``seed``; ``p`` is the FIR's tap count, the
    correlation's lag or the IIR's (b, a).  ``alias``: K12's y and K7's d
    are x itself, as the dispatch entries pass them.  ``kern`` holds the
    port's kernel modules."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(DEVICE)

    ref = kern["ref"]
    if name == "real_fir":
        return kern["fir"].real_fir, ref.real_fir, (f(b, n), f(p))
    if name == "complex_fir":
        return kern["fir"].complex_fir, ref.complex_fir, (f(b, n, 2),
                                                          f(p, 2))
    if name == "adaptive_fir":
        x = f(b, n)
        return (kern["fir"].adaptive_fir, ref.adaptive_fir,
                (x, x if alias else f(b, n), LMS_MU, p))
    if name == "iir":
        bc, ac = (torch.tensor(c, dtype=torch.float32, device=DEVICE)
                  for c in p)
        return kern["fir"].iir, ref.iir, (f(b, n), bc, ac)
    if name == "vector_dot":
        return kern["vec"].vector_dot, ref.vector_dot, (f(b, n), f(b, n))
    if name == "vector_add":
        return kern["vec"].vector_add, ref.vector_add, (f(b, n), f(b, n))
    if name == "vector_max":
        return kern["vec"].vector_max, ref.vector_max, (f(b, n),)
    if name == "correlation":
        x = f(b, n)
        return (kern["vec"].correlation, ref.correlation,
                (x, x if alias else f(b, n), p))
    if name == "dct":
        return kern["spec"].dct, ref.dct, (f(b, n),)
    return kern["spec"].fft, ref.fft, (f(b, n, 2),)


class Fp32Matmul:
    """Full-fp32 matrix products (TF32 off for matmul and cuDNN) inside the
    block, the settings restored after: the DCT's plain version and its
    library yardstick are held to 1e-4, which TF32 does not keep."""

    def __init__(self, torch):
        self.b = torch.backends

    def __enter__(self):
        self.saved = (self.b.cuda.matmul.allow_tf32, self.b.cudnn.allow_tf32)
        self.b.cuda.matmul.allow_tf32 = False
        self.b.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        self.b.cuda.matmul.allow_tf32, self.b.cudnn.allow_tf32 = self.saved


def same(torch, got, want, tol) -> bool:
    """Within ``tol`` (rtol = atol); tolerance 0 is ``torch.equal`` with NaN
    where the plain version has NaN."""
    if got.shape != want.shape:
        return False
    if tol == 0:
        nan = torch.isnan(want)
        return torch.equal(torch.isnan(got), nan) and \
            torch.equal(got[~nan], want[~nan])
    return torch.allclose(got, want, rtol=tol, atol=tol)


def dsp_bound(name, args, once=True):
    """Least time for the function on these inputs: each input byte read
    once and each output byte written once at HBM bandwidth, against the
    flops these inputs need (zero-fill terms not counted) at the fp32 rate
    outside the tensor cores; the larger, and which one it is.  Where K7's
    d or K12's y is x itself, x is one input, read once; ``once=False``
    counts it twice, as the figures before that case did."""
    if name == "real_fir":
        x, h = args
        (B, N), K = x.shape, h.shape[0]
        nbytes = 4 * (2 * B * N + K)
        ops = B * sum(2 * min(K, i + 1) - 1 for i in range(N))
    elif name == "complex_fir":
        x, h = args
        (B, N, _), K = x.shape, h.shape[0]
        nbytes = 4 * (4 * B * N + 2 * K)
        ops = B * sum(6 + 8 * (min(K, i + 1) - 1) for i in range(N))
    elif name == "adaptive_fir":
        x, d, _mu, K = args
        B, N = x.shape
        nbytes = 4 * (2 if once and d is x else 3) * B * N
        ops = B * N * (4 * K + 1)
    elif name == "iir":
        x, bc, ac = args
        B, N = x.shape
        Kb, Ka = bc.shape[0], ac.shape[0]
        nbytes = 4 * (2 * B * N + Kb + Ka)
        ops = B * N * (2 * Kb + 2 * Ka - 3)
    elif name == "vector_dot":
        x, _y = args
        B, N = x.shape
        nbytes = 4 * (2 * B * N + B)
        ops = B * (2 * N - 1)
    elif name == "vector_add":
        x, _y = args
        B, N = x.shape
        nbytes = 4 * 3 * B * N
        ops = B * N
    elif name == "vector_max":
        (x,) = args
        B, N = x.shape
        nbytes = 4 * (B * N + B)
        ops = B * (N - 1)
    elif name == "dct":
        (x,) = args
        B, N = x.shape
        nbytes = 4 * (2 * B * N + N * N)       # x, out, the matrix once
        ops = B * N * (2 * N - 1)
    elif name == "correlation":
        x, y, L = args
        B, N = x.shape
        reads = 1 if once and y is x else 2
        nbytes = 4 * (reads * B * N + B * (2 * L + 1))
        ops = B * sum(max(0, 2 * (N - abs(l - L)) - 1)
                      for l in range(2 * L + 1))
    else:
        (x,) = args
        B, N, _ = x.shape
        stages = N.bit_length() - 1
        nbytes = 4 * (2 * B * N * 2 + 2 * stages * (N // 2))
        ops = B * 5 * N * stages
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def library_call(torch, name, args, ref):
    """One PyTorch call that computes the same function on the same
    inputs: the yardstick, timed here and used nowhere in the port; None
    where there is none (LMS; the IIR, whose ``lfilter`` is torchaudio's).
    Layout copies are made here, outside the timed calls."""
    F = torch.nn.functional
    if name in ("adaptive_fir", "iir"):
        return None
    if name == "real_fir":
        x, h = args
        K, N = h.shape[0], x.shape[1]
        w = h.flip(0).view(1, 1, K)
        return lambda: F.conv1d(x[:, None], w, padding=K - 1)[:, 0, :N]
    if name == "complex_fir":
        x, h = args
        K, N = h.shape[0], x.shape[1]
        planes = x.permute(0, 2, 1).contiguous()         # (B, 2, N)
        hr, hi = h[:, 0], h[:, 1]
        w = torch.stack([torch.stack([hr, -hi]),
                         torch.stack([hi, hr])]).flip(-1).contiguous()
        return lambda: F.conv1d(planes, w, padding=K - 1)[:, :, :N] \
            .permute(0, 2, 1)
    if name == "vector_dot":
        x, y = args
        return lambda: torch.linalg.vecdot(x, y)
    if name == "vector_add":
        x, y = args
        return lambda: torch.add(x, y)
    if name == "vector_max":
        (x,) = args
        return lambda: torch.amax(x, dim=-1)
    if name == "dct":
        (x,) = args
        m = ref.dct_mat(x.shape[1], x.device)
        return lambda: torch.matmul(x, m.T)
    if name == "correlation":
        x, y, L = args
        w = x[:, None, :]
        return lambda: F.conv1d(y[None], w, padding=L, groups=x.shape[0])[0]
    (x,) = args
    return lambda: torch.view_as_real(torch.fft.fft(torch.view_as_complex(x)))


def max_err(got, want) -> float:
    """Largest absolute difference, NaN differences left out (``same``
    checks where the NaNs are)."""
    if not got.numel():
        return 0.0
    return float((got - want).abs().nan_to_num(nan=0.0).max())


# ---------------------------------------------------------------------------
# what the compiler made of the redesigned kernels
# ---------------------------------------------------------------------------
#: mangled template arguments, as the labels print them
MANGLED = {"f": "float", "13__nv_bfloat16": "bf16"}


def ptxas_facts(report: str, pattern: str, label: str) -> dict:
    """Registers and spill bytes of each kernel whose mangled name matches
    ``pattern`` (a group a template argument) in a ``-Xptxas -v``
    report, as ``{"label<args>": {"registers", "spill_stores",
    "spill_loads"}}``."""
    facts: dict = {}
    name = None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            t = re.search(pattern, m.group(1))
            name = None
            if t:
                args = ", ".join(MANGLED.get(g, g) for g in t.groups())
                name = f"{label}<{args}>" if args else label
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            facts.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            facts.setdefault(name, {})["registers"] = int(m.group(1))
    return facts


def sass_counts(lib_path, opcode: str, patterns: dict) -> dict:
    """How many ``opcode`` instructions ``cuobjdump -sass`` shows in each
    function of a built library whose mangled name matches a pattern (one
    group: its template argument), as ``{"label<arg>": count}``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    counts: dict = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = None
            for pattern, label in patterns.items():
                t = re.search(pattern, m.group(1))
                if t:
                    name = f"{label}<{t.group(1)}>"
                    counts.setdefault(name, 0)
            continue
        if name and re.search(rf"\b{opcode}\b", line):
            counts[name] += 1
    return counts


# ---------------------------------------------------------------------------
# the model path (K15, K16)
# ---------------------------------------------------------------------------
def attention_pairs(Tq, Tk, causal, q_offset) -> int:
    """(query, key) pairs the attention computes on: every key, or under
    the causal mask the keys at or before each query's position."""
    if not causal:
        return Tq * Tk
    return sum(min(Tk, i + q_offset + 1) for i in range(Tq))


def tf_bound(name, args):
    """Least time for K15 or K16 on these inputs: each input read once and
    the output written once at HBM bandwidth, against the operations these
    inputs need (K15: 4·D a (query, key) pair the mask keeps, at the bf16
    tensor-core rate; K16: 4 an element, at the fp32 rate); the larger,
    which one it is, and K15's time at the fp32 CUDA-core rate it runs
    on."""
    if name == "flash_attention":
        q, k, v, causal, q_offset = args
        BH, Tq, D = q.shape
        nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
        ops = BH * attention_pairs(Tq, k.shape[1], causal, q_offset) * 4 * D
        ops_ms = ops / BF16_TENSOR_OPS_PER_S * 1e3
        fp32_ms = ops / FP32_OPS_PER_S * 1e3
    else:
        x, w = args
        nbytes = x.element_size() * (2 * x.numel() + w.numel())
        ops_ms = 4 * x.numel() / FP32_OPS_PER_S * 1e3
        fp32_ms = ops_ms
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations", fp32_ms)


def tf_case(torch, name, shape, dtype, seed):
    """Inputs of one K15 or K16 call on the card, made from ``seed``:
    K15 (q, k, v, causal, q_offset), K16 (x, w), all standard normal.
    q and k are not scaled down: the scores' spread is about 1, so each
    query attends to a few keys, and a wrong mask or probabilities rounded
    to bfloat16 before P·V fall outside the float32 tolerance."""
    rng = np.random.default_rng(seed)

    def f(*sh):
        a = rng.standard_normal(sh, dtype=np.float32)
        return torch.from_numpy(a).to(DEVICE).to(dtype)

    if name == "flash_attention":
        BH, Tq, Tk, D, causal, q_offset = shape
        return (f(BH, Tq, D), f(BH, Tk, D), f(BH, Tk, D), causal, q_offset)
    R, D = shape
    return f(R, D), f(D)


@contextlib.contextmanager
def plain_path(on, ref, attention, rmsnorm, rwkv6, mamba2, only=None,
               rec=None, attn=None):
    """While ``on``, the model's ops call the plain versions in place of
    the K15–K18 wrappers (or of those named in ``only``); restored on
    exit.  ``rec`` stands for ``rec_plain`` as K17/K18's replacement and
    ``attn`` for the plain attention as K15's (the controls).  The package
    has no such switch: only this script builds the plain path it compares
    with."""
    rec = rec or rec_plain
    attn = attn or plain_attention
    swaps = {
        "flash_attention": (attention, lambda q, k, v, **kw:
                            attn(ref, q, k, v, **kw)),
        "rmsnorm": (rmsnorm, ref.rmsnorm),
        "wkv6": (rwkv6, lambda *args, **kw: rec(ref, "wkv6", args)),
        "ssd": (mamba2, lambda *args, **kw: rec(ref, "ssd", args)),
    }
    swaps = {n: v for n, v in swaps.items()
             if on and (only is None or n in only)}
    saved = {n: getattr(mod, n) for n, (mod, _) in swaps.items()}
    for n, (mod, fn) in swaps.items():
        setattr(mod, n, fn)
    try:
        yield
    finally:
        for n, (mod, _) in swaps.items():
            setattr(mod, n, saved[n])


def rec_case(torch, name, shape, dtype, seed, decay="drawn"):
    """Inputs of one K17 or K18 call on the card, made from ``seed`` as the
    JAX tests draw them: K17 (r, k, v, w, u) on (B·H, T, ·) rows, r, k, v
    0.5·N, w in (0.5, 1), u 0.3·N; K18 (x, a, b, c), x, b, c 0.5·N and a
    = -|0.5·N| in float32.  K17's ``decay="model"`` draws w as rwkv6's
    time mixing makes it, ``exp(-exp(x))`` with x ~ N(0, 2), rounded to
    ``dtype`` (some 0, and in bf16 some 1), with channel 0 exactly 0 and
    channel 1 exactly 1 in every row and the last row exactly 1."""
    rng = np.random.default_rng(seed)

    def f(*sh, scale=0.5, dt=dtype):
        a = rng.standard_normal(sh, dtype=np.float32) * scale
        return torch.from_numpy(a).to(DEVICE).to(dt)

    if name == "wkv6":
        B, T, H, K, V = shape
        x = f(B * H, T, K, scale=1.0, dt=torch.float32)
        if decay == "model":
            w = torch.exp(-torch.exp(2.0 * x))
            w[..., 0], w[..., 1], w[-1] = 0.0, 1.0, 1.0
        else:
            w = torch.sigmoid(x) * 0.5 + 0.5
        return (f(B * H, T, K), f(B * H, T, K), f(B * H, T, V),
                w.to(dtype), f(B * H, K, scale=0.3))
    B, T, H, P, N = shape
    return (f(B, T, H, P), -f(B, T, H, dt=torch.float32).abs(), f(B, T, N),
            f(B, T, N))


def rec_plain(ref, name, args):
    """The plain version of K17 (on rows: one sequence of B·H heads) or
    K18 on a wrapper's arguments."""
    if name == "wkv6":
        r, k, v, w, u = args
        return ref.rwkv6_scan(*(t.transpose(0, 1)[None]
                                for t in (r, k, v, w)), u)[0].transpose(0, 1)
    return ref.mamba2_ssd(*args)


def rec_bf16_state(ref, name, args):
    """The control of phase 10b's float32 gate: the plain recurrence of
    K17 or K18 (``ref``'s loop, step for step) with its state rounded to
    bfloat16 after every update, what a kernel keeping its state in
    bfloat16 would compute."""
    import torch
    bf = torch.bfloat16
    if name == "wkv6":
        r, k, v, w, u = (t.float() for t in args)
        S = torch.zeros(r.shape[0], r.shape[-1], v.shape[-1],
                        device=r.device)
        out = torch.empty(*v.shape, device=r.device)
        for t in range(r.shape[1]):
            kv = k[:, t, :, None] * v[:, t, None, :]
            out[:, t] = torch.einsum("rk,rkv->rv", r[:, t],
                                     S + u[:, :, None] * kv)
            S = (w[:, t, :, None] * S + kv).to(bf).float()
        return out.to(args[0].dtype)
    x, a, b, c = (t.float() for t in args)
    B, T, H, P = x.shape
    h = torch.zeros(B, H, b.shape[-1], P, device=x.device)
    y = torch.empty(B, T, H, P, device=x.device)
    for t in range(T):
        h = (torch.exp(a[:, t])[:, :, None, None] * h
             + b[:, t, None, :, None] * x[:, t, :, None, :]).to(bf).float()
        y[:, t] = torch.einsum("bn,bhnp->bhp", c[:, t], h)
    return y.to(args[0].dtype)


def plain_attention(ref, q, k, v, **kw):
    """K15's plain version on the wrapper's (BH, T, D) arguments."""
    return ref.flash_attention(q[:, None], k[:, None], v[:, None],
                               **kw)[:, 0]


def attention_bf16_scores(ref, q, k, v, *, causal=True, scale=None,
                          q_offset=0):
    """The control of phase 9b's gates: the plain attention (``ref``'s
    einsums, mask and softmax in float32) with the scaled scores S rounded
    to bfloat16 before the softmax, what a kernel keeping S in bfloat16
    would compute.  q: (BH, Tq, D); k, v: (BH, Tk, D)."""
    import torch
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = (torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
         ).to(torch.bfloat16).float()
    if causal:
        qi = torch.arange(q.shape[1], device=q.device)[:, None] + q_offset
        ki = torch.arange(k.shape[1], device=q.device)[None, :]
        s = s.masked_fill(ki > qi, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


@contextlib.contextmanager
def capture_attention(attention, ref):
    """While open, ``attention.flash_attention`` (which
    ``ops.flash_attention`` calls once a layer, heads flattened, GQA
    repeated and RoPE applied) records each call's ``(q, k, v, kwargs)``
    in the list it yields, and returns the plain attention of them."""
    calls = []
    saved = attention.flash_attention

    def record(q, k, v, **kw):
        calls.append((q, k, v, kw))
        return plain_attention(ref, q, k, v, **kw)

    attention.flash_attention = record
    try:
        yield calls
    finally:
        attention.flash_attention = saved


def rec_bound(name, args):
    """Least time for K17 or K18 on these inputs: each input read once and
    the output written once at HBM bandwidth, against the fp32 operations
    a step needs on each state element (K17: 7, the rank-1 product, the
    bonus term, the r-weighted sum and the decayed update; K18: 5, the
    decayed update and the c-weighted sum); the larger, and which."""
    if name == "wkv6":
        r, k, v, w, u = args
        BH, T, K = r.shape
        V = v.shape[-1]
        nbytes = r.element_size() * (3 * r.numel() + 2 * v.numel()
                                     + u.numel())
        ops = 7 * BH * T * K * V
    else:
        x, a, b, c = args
        B, T, H, P = x.shape
        N = b.shape[-1]
        nbytes = (x.element_size() * 2 * x.numel() + a.element_size()
                  * a.numel() + b.element_size() * (b.numel() + c.numel()))
        ops = 5 * B * T * H * N * P
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / FP32_OPS_PER_S * 1e3
    return (max(bytes_ms, ops_ms),
            "bytes" if bytes_ms >= ops_ms else "operations")


def normwise(got, want) -> float:
    """Largest absolute difference over the largest magnitude of ``want``."""
    g, w = got.float(), want.float()
    return float((g - w).abs().max() / w.abs().max())


def model_config(get_config):
    """The configuration phase 9 serves: ``ARCH`` at its published widths."""
    return get_config(ARCH)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    # ``--only PREFIX ...``: run the build and the phases whose names start
    # with a prefix, and print no kernels line (for iterating on one path;
    # the check itself runs with no arguments)
    only = tuple(argv[argv.index("--only") + 1:]) if "--only" in argv else ()
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this needs "
              "a CUDA card", file=sys.stderr)
        return 2
    try:
        from repro_torch.core.hts import (HtsParams, api, batch, costs,
                                          cuda_run, cuda_step, machine,
                                          programs, workloads)
        from repro_torch.examples import dsp_pipeline
        from repro_torch.kernels import common as dsp
        from repro_torch.kernels import (attention, dsp_fir, dsp_spectral,
                                         dsp_vector, mamba2, ops, ref,
                                         rmsnorm, rwkv6)
        from repro_torch.core.sched import serving, specdecode
        from repro_torch.models import layers, registry
    except ImportError as e:
        print(f"chip_smoke: the port is not importable from {ROOT / 'src'} "
              f"({e}); run from the root of a checkout", file=sys.stderr)
        return 2

    failures: list[str] = []
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"devices {torch.cuda.device_count()}")

    def phase(name, fn):
        if only and not name.startswith(("1 ", "setup") + only):
            return None
        log(f"=== {name}")
        t0 = time.perf_counter()
        try:
            out = fn()
            log(f"--- {name}: ok ({time.perf_counter() - t0:.1f} s)")
            return out
        except Exception:                           # noqa: BLE001
            traceback.print_exc(file=sys.stdout)
            failures.append(name)
            log(f"--- {name}: FAILED")
            return None

    # 1. build: one nvcc per source, all started together ----------------
    def build():
        libs = (cuda_step.LIB, cuda_run.LIB, dsp.LIB, dsp.TRANSFORMER_LIB)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(libs)) as pool:
            paths = list(pool.map(lambda lib: lib.build(), libs))
        log(f"{len(libs)} libraries ready in {time.perf_counter() - t0:.2f} "
            "s (built in parallel)")
        for lib, path in zip(libs, paths):
            lib.load()
            info = lib.info
            if not info:
                log(f"{path.name} was already built (cached)")
                continue
            log(f"built {path.name} in {info['seconds']:.2f} s")
            log(info["ptxas"].strip())
    phase("1 build", build)
    if failures:
        return 1

    # the redesigned kernels: ptxas's registers and spills of hts_run and
    # of each instance of K5, K7, K8, K12, K13, K14, bf16 K15, K16, K17's and
    # K18's three kernels,
    # and the
    # tensor-core instructions (HGMMA) in K15's SASS: the bf16 kernel must
    # have them, the float32 one none
    facts: dict = {}

    def build_facts():
        tf = dsp.TRANSFORMER_LIB
        dt = r"(f|13__nv_bfloat16)"
        for name, lib, pattern, label in (
                ("hts_run", cuda_run.LIB, r"hts_run_kernel",
                 "hts_run_kernel"),
                ("fft", dsp.LIB, r"fft_kernelILi(\d+)E", "fft_kernel"),
                ("dct", dsp.LIB, r"dct_kernelILi(\d+)E", "dct_kernel"),
                ("flash_attention", tf, r"flash_attention_wgmmaILi(\d+)E",
                 "flash_attention_wgmma"),
                ("rmsnorm", tf, rf"rmsnorm_vecI{dt}Li(\d+)E", "rmsnorm_vec"),
                ("rmsnorm", tf, rf"rmsnorm_loopI{dt}Lb([01])E",
                 "rmsnorm_loop"),
                ("ssd", tf, rf"ssd_chunk_stateI{dt}Li(\d+)E",
                 "ssd_chunk_state"),
                ("ssd", tf, r"ssd_state_passingILi(\d+)E",
                 "ssd_state_passing"),
                ("ssd", tf, rf"ssd_chunk_scanI{dt}Li(\d+)E",
                 "ssd_chunk_scan"),
                ("wkv6", tf, rf"wkv6_chunk_stateI{dt}Li(\d+)E",
                 "wkv6_chunk_state"),
                ("wkv6", tf, r"wkv6_state_passingILi(\d+)E",
                 "wkv6_state_passing"),
                ("wkv6", tf, rf"wkv6_chunk_scanI{dt}Li(\d+)E",
                 "wkv6_chunk_scan"),
                ("real_fir", dsp.LIB, r"real_fir_packedILi(\d+)E",
                 "real_fir_packed"),
                ("adaptive_fir", dsp.LIB, r"adaptive_fir_packedILi(\d+)E",
                 "adaptive_fir_packed"),
                ("iir", dsp.LIB, r"iir_packedILi(\d+)E", "iir_packed"),
                ("iir", dsp.LIB, r"iir_flatILi(\d+)E", "iir_flat"),
                ("correlation", dsp.LIB, r"correlation_packedILi(\d+)E",
                 "correlation_packed")):
            facts.setdefault(name, {})
            if not lib.info:
                log(f"{label}: cached build, no ptxas report")
                continue
            found = ptxas_facts(lib.info["ptxas"], pattern, label)
            assert found, f"no {label} in the ptxas report"
            facts[name].setdefault("ptxas", {}).update(found)
            for fn, f in found.items():
                log(f"ptxas {fn:32s} {f}")
        spilled = {k: f for k, f in facts["iir"].get("ptxas", {}).items()
                   if k.startswith("iir_packed")
                   and (f.get("spill_stores") or f.get("spill_loads"))}
        assert not spilled, f"K8's packed kernel spills: {spilled}"
        hgmma = sass_counts(tf.build(), "HGMMA", {
            r"flash_attention_wgmmaILi(\d+)E": "flash_attention_wgmma",
            r"flash_attention_kernelILi(\d+)E": "flash_attention_kernel"})
        facts["flash_attention"]["hgmma"] = hgmma
        log(f"HGMMA instructions in the SASS of K15: {hgmma}")
        bf16 = {k: n for k, n in hgmma.items() if "wgmma" in k}
        fp32 = {k: n for k, n in hgmma.items() if "wgmma" not in k}
        assert len(bf16) == 2 and all(bf16.values()), \
            f"bf16 K15 without tensor-core instructions: {bf16}"
        assert len(fp32) == 4 and not any(fp32.values()), fp32
    phase("1 ptxas of hts_run, K5, K7, K8, K12-K18, SASS of K15",
          build_facts)

    ctx: dict = {}

    def setup():
        t0 = time.perf_counter()
        pop, progs, fu_cost = main_population(workloads, batch)
        log(f"{LANES} scenarios generated and packed in "
            f"{time.perf_counter() - t0:.1f} s (max_prog {pop.max_prog}, "
            f"{pop.streams.shape[1]} stream rows)")
        spec = machine.MachineSpec(params=pop.params,
                                   costs=costs.costs_by_name("hts_spec"),
                                   max_fu_per_class=4)
        ctx.update(pop=pop, progs=progs, fu_cost=fu_cost, spec=spec)
    phase("setup", setup)
    if failures:
        return 1
    pop, spec = ctx.get("pop"), ctx.get("spec")
    checker = CheckedOps(torch, cuda_step)
    #: the per-phase loop's K1–K4 launches, summed over 2a and 2b
    step_launches = dict.fromkeys(cuda_step.launches, 0)
    #: hts_run's launches on each path that schedules, counted from 0
    run_paths: dict = {}

    def checked(carry, trips):
        cuda_step.reset_launches()
        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        a = machine.norm_args(m, *pop.machine_args())
        st = {k: v.clone() for k, v in carry.items()}
        limit = torch.full_like(st["steps"], machine.BIG)
        for _ in range(trips):
            machine.step(m, st, a, limit, ops=checker)
        torch.cuda.synchronize()
        for k, v in cuda_step.launches.items():
            step_launches[k] += v
        return st

    # 2a. the first trips, checked (also warms the card up) ----------------
    def check_first():
        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        st = checked(m.init(*pop.machine_args()), CHECK_TRIPS)
        log(f"trips 0..{CHECK_TRIPS - 1}: {checker.checks} kernel launches "
            "equal to their plain versions")
    phase("2a kernels vs plain, first trips", check_first)

    # 2c. hts_run against the per-phase loop, every carry array -----------
    def carry_diff(got, want):
        return [k for k in want if not torch.equal(got[k], want[k])]

    def persistent_vs_per_phase():
        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        args = pop.machine_args()
        a = machine.norm_args(m, *args)
        c0 = m.init(*args)

        def fresh(c):
            return {k: v.clone() for k, v in c.items()}
        cuda_run.reset_launches()
        cuda_step.reset_launches()
        full = m.run_slice(c0, *args, budget=machine.BIG)
        mid = int(full["steps"].max()) // 2
        for budget in (1, 16, mid):
            got = m.run_slice(c0, *args, budget=budget)
            want = machine._loop(m, fresh(c0), a, budget)
            torch.cuda.synchronize()
            bad = carry_diff(got, want)
            assert not bad, (f"budget {budget}: {bad} differ from the "
                             "per-phase loop")
            if budget <= 16:
                plain = machine._loop(m, fresh(c0), a, budget,
                                      ops=cuda_step.PLAIN)
                bad = carry_diff(got, plain)
                assert not bad, (f"budget {budget}: {bad} differ from the "
                                 "plain per-phase loop")
            log(f"budget {budget}: every carry array equal to the per-phase "
                f"loop's{' and the plain loop' if budget <= 16 else ''}")
        got_mid, want_mid = got, want
        resumed = m.run_slice(got_mid, *args, budget=machine.BIG)
        t0 = time.perf_counter()
        want_full = machine._loop(m, want_mid, a, machine.BIG)
        torch.cuda.synchronize()
        t_per = time.perf_counter() - t0
        for label, got in (("from the start", full),
                           ("resumed at mid-run", resumed)):
            bad = carry_diff(got, want_full)
            assert not bad, f"completion {label}: {bad} differ"
        ctx["run_err"] = 0
        ctx["per_phase_launches"] = dict(cuda_step.launches)
        log(f"completion (slowest lane {int(full['steps'].max())} steps), "
            "from the start and resumed at mid-run: every carry array equal "
            f"to the per-phase loop's ({t_per:.1f} s for its second half); "
            f"{cuda_run.launches['run']} hts_run launches, the per-phase "
            f"loop's K1-K4 launches {ctx['per_phase_launches']}")
    phase("2c persistent vs per-phase", persistent_vs_per_phase)

    # 3. main path ----------------------------------------------------------
    def main_path():
        cuda_step.reset_launches()
        cuda_run.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = api.run_many(pop, scheduler="hts_spec", device=DEVICE,
                         check=False)
        wall = time.perf_counter() - t0
        runs, steps = cuda_run.launches["run"], dict(cuda_step.launches)
        ctx.update(result=r, main_step_launches=steps, wall=wall)
        run_paths["main"] = runs
        overflow = int(r.raw["overflow"].sum())
        log(f"lanes {len(r)}  halted {int(r.halted.sum())}  overflow "
            f"{overflow}  trips {r.trips} (the slowest lane's steps)")
        log(f"launches: hts_run {runs}, K1-K4 {steps}")
        log(f"main path wall {wall:.4f} s  {wall / r.trips * 1e6:.3f} us a "
            f"step  {LANES / wall:.1f} scenarios/s  on {card}")
        assert r.all_halted and overflow == 0, "a lane did not halt"
        assert runs == 1 and not any(steps.values()), \
            f"main path launched hts_run {runs} times, K1-K4 {steps}"
        bad = []
        for i in range(0, LANES, GOLDEN_EVERY):
            g = api.run(ctx["progs"][i], scheduler="hts_spec", n_fu=2,
                        backend="golden", fu_cost=ctx["fu_cost"][i])
            mine = r[i]
            if g.cycles != mine.cycles or \
                    g.schedule_tuple() != mine.schedule_tuple():
                bad.append(i)
        log(f"golden: {LANES // GOLDEN_EVERY - len(bad)}/"
            f"{LANES // GOLDEN_EVERY} sampled lanes equal (cycles and "
            "schedule)")
        assert not bad, f"lanes {bad[:10]} differ from golden"

        def again():
            api.run_many(pop, scheduler="hts_spec", device=DEVICE,
                         check=False)
        try:
            events, wall_us = trace_window(torch, again, again)
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"busy share not measured (profiler unavailable: {e})")
            return
        busy = sum(us for _key, us in events)
        kern = [us for key, us in events if "hts_run_kernel" in key]
        if kern:
            ctx["main_kernel_ms"] = kern[0] / 1e3
        log(f"traced run_many: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), hts_run "
            f"{sum(kern) / 1e3:.3f} ms on the device "
            f"({sum(kern) / r.trips:.3f} us a step), {len(events)} device "
            f"activities  on {card}")
        for key, us, cnt in costliest(events):
            log(f"    {us / 1e3:9.3f} ms  x{cnt:<4d} {key}")
    phase("3 main path", main_path)

    # 2b. trips from the middle of the run, checked ------------------------
    def check_middle():
        r = ctx["result"]
        mid = max(int(r.trips) // 2, CHECK_TRIPS)
        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        args = pop.machine_args()
        carry = m.run_slice(m.init(*args), *args, budget=mid)
        before = checker.checks
        st = checked(carry, CHECK_TRIPS)
        ctx["mid_state"] = st
        log(f"trips {mid}..{mid + CHECK_TRIPS - 1}: "
            f"{checker.checks - before} kernel launches equal to their "
            f"plain versions; K1-K4 launches in 2a and 2b {step_launches}")
    if "result" in ctx:
        phase("2b kernels vs plain, middle trips", check_middle)

    # 4. single lane ---------------------------------------------------------
    def single_lane():
        n, card_s = 0, 0.0
        cuda_run.reset_launches()
        for sched in ("naive", "hts_spec"):
            for b in programs.all_benches():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mine = api.run(b, scheduler=sched, device=DEVICE)
                card_s += time.perf_counter() - t0
                g = api.run(b, scheduler=sched, backend="golden")
                assert mine.cycles == g.cycles and \
                    mine.schedule_tuple() == g.schedule_tuple(), \
                    f"{b.name} under {sched} differs from golden"
                n += 1
        assert cuda_run.launches["run"] == n, cuda_run.launches
        run_paths["single lane"] = n
        log(f"{n} single-lane runs equal to golden; {n} hts_run launches, "
            f"{card_s:.3f} s on the card in all  on {card}")
    phase("4 single lane", single_lane)

    # 4b. specs hts_run cannot hold: the per-phase loop on the card --------
    def unfit_specs():
        cuda_run.reset_launches()
        cuda_step.reset_launches()
        n = 0
        for label, kw in UNFIT_SPECS.items():
            p = HtsParams(**kw)
            for b in programs.all_benches()[:UNFIT_BENCHES]:
                mine = api.run(b, params=p, device=DEVICE)
                g = api.run(b, params=p, backend="golden")
                assert mine.cycles == g.cycles and \
                    mine.schedule_tuple() == g.schedule_tuple(), \
                    f"{b.name} at {label} differs from golden"
                n += 1
        steps = dict(cuda_step.launches)
        ctx["unfit_step_launches"] = steps
        assert cuda_run.launches["run"] == 0 and all(steps.values()), \
            f"hts_run {cuda_run.launches['run']}, K1-K4 {steps}"
        log(f"{n} single-lane runs at {list(UNFIT_SPECS)} equal to golden "
            f"through the per-phase loop: hts_run 0 launches, K1-K4 "
            f"{steps}  on {card}")
    phase("4b specs past hts_run's limits", unfit_specs)

    # 5. kernel times --------------------------------------------------------
    rows = []

    def kernel_times():
        # the card's launch floor: a one-element in-place add_
        one = torch.zeros(1, device=DEVICE)
        floor_ms = profiled_call_ms(torch, [functools.partial(one.add_, 1.0)]
                                    * 23)
        log("launch floor: "
            f"{'not measured' if floor_ms is None else f'{floor_ms:.4f} ms'}"
            " on the device a launch of a one-element add_ (20 after 3 "
            f"warm-ups)  on {card}")
        for name, (wrapper, plain, _keys) in cuda_step.KERNELS.items():
            saved = checker.saved[name]
            # the paths that run K1–K4: the main path no more (hts_run
            # does), the per-phase loop of 2c; the checks of 2a and 2b apart
            by_path = {
                "main": ctx.get("main_step_launches", {}).get(name, 0),
                "per-phase loop (2c)": ctx.get("per_phase_launches",
                                               {}).get(name, 0),
                "specs past hts_run (4b)": ctx.get("unfit_step_launches",
                                                   {}).get(name, 0)}
            st1, args1 = _copies(torch, saved, 1)[0]
            wrapper(st1, *args1)
            bound, by = bound_of(torch, name, saved[0], saved[1], st1, args1)
            k_call = events_ms(torch, phase_calls(torch, wrapper, saved))
            p_call = events_ms(torch, phase_calls(torch, plain, saved))
            k_dev = profiled_ms(torch, phase_calls(torch, wrapper, saved),
                                f"{name}_kernel")
            k_call = min(k_call, events_ms(torch, phase_calls(torch, wrapper,
                                                              saved)))
            rows.append(dict(
                name=name, route="cuda", source=SOURCE,
                replaces=REPLACES[name],
                launches=sum(by_path.values()), launches_by_path=by_path,
                check_launches=step_launches[name],
                max_abs_err=checker.max_err[name],
                ms=k_dev if k_dev is not None else k_call,
                kernel_ms=k_dev if k_dev is not None else k_call,
                call_ms=k_call, plain_ms=p_call, bound_ms=bound,
                bound_by=by, library_ms=None, launch_floor_ms=floor_ms))
            dev = "not measured" if k_dev is None else f"{k_dev:.4f} ms"
            r = rows[-1]
            log(f"{name:8s} kernel {dev} on the device, {k_call:.4f} ms per "
                f"call  plain {p_call:.4f} ms per call  bound {bound:.6f} ms "
                f"({by}; the launch floor {floor_ms} ms)  launches "
                f"{by_path}, checks (2a, 2b) {r['check_launches']}  on "
                f"{card}")
        run_times()

        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        a = machine.norm_args(m, *pop.machine_args())
        st = {k: v.clone() for k, v in ctx["mid_state"].items()}
        try:
            wall, busy, launches, top = trip_profile(torch, machine, m, st, a)
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"trip profile not measured (profiler unavailable: {e})")
            return
        log(f"per-phase trip profile (mid-run, 32 trips): {wall / 1e3:.3f} "
            f"ms wall per trip, device busy {busy / 1e3:.3f} ms per trip "
            f"({100 * busy / wall:.1f} %), {launches:.0f} device activities "
            f"(kernels, copies, sets) per trip  on {card}")
        for key, us, cnt in top:
            log(f"    {us:9.1f} us/trip  x{cnt:<4d} {key}")

    def run_times():
        """hts_run on a RUN_SLICE-step slice of the mid-run carry, against
        the plain per-phase loop over the same slice."""
        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        args = pop.machine_args()
        a = machine.norm_args(m, *args)
        mid = ctx["mid_state"]

        def calls(fn, carry, aa, n, *extra):
            return [functools.partial(fn, m, {k: v.clone() for k, v in
                                              carry.items()}, aa, RUN_SLICE,
                                      *extra) for _ in range(n)]
        k_call = events_ms(torch, calls(cuda_run.run_slice, mid, a, 23))
        k_dev = profiled_ms(torch, calls(cuda_run.run_slice, mid, a, 23),
                            "hts_run_kernel")
        p_call = events_ms(torch, calls(machine._loop, mid, a, 6,
                                        cuda_step.PLAIN), warm=1)
        # the slowest lane alone: one CTA on the card
        i = int(np.argmax(ctx["result"].steps))
        one = {k: v[i:i + 1] for k, v in mid.items()}
        a1 = machine.norm_args(m, *(None if x is None else x[i:i + 1]
                                    for x in args))
        k_one = profiled_ms(torch, calls(cuda_run.run_slice, one, a1, 23),
                            "hts_run_kernel")
        # the bytes the slice must move: the hot arrays (those the layout
        # puts in shared memory) read and written once, the arguments read
        # once, and the trace elements this slice changes written once
        lay = cuda_run.layout(m, pop.streams.shape[1])[0]
        after = cuda_run.run_slice(m, {k: v.clone() for k, v in mid.items()},
                                   a, RUN_SLICE)
        hot = sum(mid[k].numel() * mid[k].element_size()
                  for k, (off, _kind, _n) in lay.items() if off >= 0)
        traced = sum(int((after[k] != mid[k]).sum()) * mid[k].element_size()
                     for k, (off, _kind, _n) in lay.items() if off < 0)
        read = sum(v.numel() * v.element_size()
                   for v in cuda_run._arg_tensors(a).values())
        bound = (2 * hot + traced + read) / HBM_BYTES_PER_S * 1e3
        occ = cuda_run.occupancy(m, pop.streams.shape[1])
        px = next(iter(facts.get("hts_run", {}).get("ptxas", {}).values()),
                  {})
        ms = k_dev if k_dev is not None else k_call
        rows.append(dict(
            name="hts_run", route="cuda", source=RUN_SOURCE,
            replaces=RUN_REPLACES, launches=run_paths.get("main", 0),
            max_abs_err=ctx.get("run_err"), ms=ms, kernel_ms=ms,
            call_ms=k_call, plain_ms=p_call, bound_ms=bound,
            bound_by="bytes", bound_bytes=2 * hot + traced + read,
            library_ms=None, steps=RUN_SLICE,
            ms_per_step=ms / RUN_SLICE, one_lane_ms=k_one,
            main_path_ms=ctx.get("main_kernel_ms"),
            main_path_steps=int(ctx["result"].trips),
            registers=occ["registers"], local_bytes=occ["local_bytes"],
            spill_stores=px.get("spill_stores"),
            spill_loads=px.get("spill_loads"),
            shared_bytes=occ["shared_bytes"],
            ctas_per_sm=occ["ctas_per_sm"]))
        dev = "not measured" if k_dev is None else f"{k_dev:.4f} ms"
        one_s = "not measured" if k_one is None else f"{k_one:.4f} ms"
        log(f"hts_run  {RUN_SLICE} steps of {LANES} lanes: {dev} on the "
            f"device ({ms / RUN_SLICE * 1e3:.3f} us a step), {k_call:.4f} "
            f"ms per call; the slowest lane alone {one_s}; plain per-phase "
            f"loop {p_call:.4f} ms per call; bound {bound:.6f} ms (bytes: "
            f"hot arrays {hot} B read and written, trace writes {traced} B, "
            f"arguments {read} B read); "
            f"{occ['registers']} registers, spills {px or 'not reported'}, "
            f"{occ['local_bytes']} local bytes a thread, "
            f"{occ['shared_bytes']} shared bytes and {occ['threads']} "
            f"threads a CTA, {occ['ctas_per_sm']} CTAs an SM  on {card}")

    if "mid_state" in ctx:
        phase("5 kernel times", kernel_times)

    kern = dict(fir=dsp_fir, vec=dsp_vector, spec=dsp_spectral, ref=ref)
    dsp_err = {k: 0.0 for k in dsp.launches}

    # 6a. DSP kernels against their plain versions -------------------------
    def check_dsp(name, wrapper, plain, args, label):
        got = wrapper(*args)
        with Fp32Matmul(torch):
            want = plain(*args)
        torch.cuda.synchronize()
        err = max_err(got, want) if got.shape == want.shape else math.inf
        dsp_err[name] = max(dsp_err[name], err)
        tol = DSP_TOL[name]
        assert same(torch, got, want, tol), \
            f"{name} {label} differs from plain (max abs err {err:.3g}, " \
            f"tolerance {tol or 'torch.equal'})"
        log(f"{name:11s} {label}  max abs err {err:.3g} (tolerance "
            f"{tol or 'torch.equal'})")
        return got

    def dsp_vs_plain():
        for name, cases in DSP_CASES.items():
            for i, (b, n, p) in enumerate(cases):
                wrapper, plain, args = dsp_case(torch, kern, name, b, n, p, i)
                check_dsp(name, wrapper, plain, args,
                          f"B={b:<6d} N={n:<4d} p={p}")
        for name, cases in ALIAS_CASES.items():
            for i, (b, n, p) in enumerate(cases):
                wrapper, plain, args = dsp_case(torch, kern, name, b, n, p,
                                                40 + i, alias=True)
                check_dsp(name, wrapper, plain, args,
                          f"B={b:<6d} N={n:<4d} p={p} "
                          f"{'y' if name == 'correlation' else 'd'} is x")
        # rows 4 bytes past a 16-byte boundary: the scalar loads
        unaligned = {
            "vector_dot": (dsp_vector.vector_dot, ref.vector_dot, 256),
            "vector_add": (dsp_vector.vector_add, ref.vector_add, 64),
            "vector_max": (dsp_vector.vector_max, ref.vector_max, 64)}
        for i, (name, (wrapper, plain, n)) in enumerate(unaligned.items()):
            x = torch.from_numpy(np.random.default_rng(9 + i).standard_normal(
                300 * n + 1, dtype=np.float32)).to(DEVICE)[1:].view(300, n)
            args = (x,) if name == "vector_max" else (x, x)
            check_dsp(name, wrapper, plain, args,
                      f"B=300    N={n:<4d} unaligned rows")
        x = torch.from_numpy(np.random.default_rng(14).standard_normal(
            300 * 40 + 1, dtype=np.float32)).to(DEVICE)[1:].view(300, 40)
        h = torch.full((8,), 0.125, device=DEVICE)
        check_dsp("real_fir", dsp_fir.real_fir, ref.real_fir, (x, h),
                  "B=300    N=40   unaligned rows")
        # K12 and K7 there take their flat kernels, with and without alias
        def off_rows(seed, n):
            rng = np.random.default_rng(seed)
            return torch.from_numpy(rng.standard_normal(
                300 * n + 1, dtype=np.float32)).to(DEVICE)[1:].view(300, n)

        for alias in (False, True):
            x, z = off_rows(20 + alias, 64), off_rows(22 + alias, 40)
            tag = " (second array x)" if alias else ""
            check_dsp("correlation", dsp_vector.correlation,
                      ref.correlation, (x, x if alias else x.flip(0), 4),
                      f"B=300    N=64   unaligned rows{tag}")
            check_dsp("adaptive_fir", dsp_fir.adaptive_fir,
                      ref.adaptive_fir,
                      (z, z if alias else z.flip(0), LMS_MU, 8),
                      f"B=300    N=40   unaligned rows{tag}")
        # K8 there takes its flat kernel, the entry's filter and a long one
        z = off_rows(24, 40)
        for coef in (ENTRY_IIR, LONG_IIR):
            bc, ac = (torch.tensor(c, device=DEVICE) for c in coef)
            check_dsp("iir", dsp_fir.iir, ref.iir, (z, bc, ac),
                      f"B=300    N=40   unaligned rows p={len(coef[0])},"
                      f"{len(coef[1])} taps")
        # a NaN in one row: vector_max must give NaN there, as amax does
        wrapper, plain, (x,) = dsp_case(torch, kern, "vector_max", 300, 64,
                                        None, 12)
        x[17, 5] = float("nan")
        got = check_dsp("vector_max", wrapper, plain, (x,),
                        "B=300    N=64   NaN in row 17")
        assert bool(torch.isnan(got[17])) and \
            int(torch.isnan(got).sum()) == 1, "vector_max lost the NaN"
        # the complex_fir entry keeps the real part of (x + jx)(1 + j)/8:
        # exactly zero, as in the reference
        x = torch.from_numpy(np.random.default_rng(13).standard_normal(
            (TABLE_FRAMES, TABLE_SAMPLES), dtype=np.float32)).to(DEVICE)
        zero = ops.dsp_dispatch_table()["complex_fir"](x)
        assert torch.equal(zero, torch.zeros_like(x)), \
            "the complex_fir entry is not exactly zero"
        log(f"complex_fir entry on B={TABLE_FRAMES} N={TABLE_SAMPLES}: "
            "torch.equal to zeros")
    phase("6a DSP kernels vs plain", dsp_vs_plain)

    def time_execution(tasks, x, table):
        """Median wall (s) of EXEC_REPS synchronised executions of the
        issued tasks, all walls, and the last output."""
        walls = []
        for _ in range(EXEC_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = dsp_pipeline.execute(tasks, x, table)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return sorted(walls)[EXEC_REPS // 2], walls, out

    in_schedule: dict = {}      # DSP kernel -> schedule -> device ms a launch

    def profile_execution(name, tasks, x, table, exec_s):
        """One profiled execution (after one traced as the warm-up): the
        device's busy share read two ways (over the profiled wall; over
        the unprofiled median), the costliest device activities, and each
        DSP kernel's device ms a launch there (into ``in_schedule``)."""
        def run():
            dsp_pipeline.execute(tasks, x, table)

        try:
            events, wall_us = trace_window(torch, run, run)
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"pipeline profile not measured (profiler: {e})")
            return
        busy = sum(us for _k, us in events)
        log(f"{name}: profiled execution {wall_us / 1e3:.3f} ms "
            f"wall, device busy {busy / 1e3:.3f} ms "
            f"({100 * busy / wall_us:.1f} % of the profiled wall, "
            f"{100 * busy / (exec_s * 1e6):.1f} % of the unprofiled "
            f"median), {len(events)} device activities  on {card}")
        for key, us, cnt in costliest(events):
            log(f"    {us:9.1f} us  x{cnt:<4d} {key}  on {card}")
        for kname in dsp.launches:
            sub = DSP_KERNEL.get(kname, f"{kname}_kernel")
            times = [us for key, us in events if sub in key]
            if times:
                ms = sum(times) / len(times) / 1e3
                in_schedule.setdefault(kname, {})[name] = ms
                log(f"{name}: {kname} {ms:.4f} ms a launch on the device "
                    f"over {len(times)} traced launches  on {card}")

    def pipeline_run(bench, x, params, live_want, unit):
        """``run_pipeline`` with every DSP count set to 0 just before and
        read just after: checked against golden, live tasks, the plain
        table and itself; returns (result, counts).  ``unit`` names a row
        of ``x`` (frames, tiles)."""
        g = api.run(bench, scheduler="hts_spec", n_fu=2, params=params,
                    backend="golden")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        dsp.reset_launches()
        cuda_run.reset_launches()
        t0 = time.perf_counter()
        r, executed, out = dsp_pipeline.run_pipeline(bench, x, params=params,
                                                     device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(dsp.launches)
        runs = cuda_run.launches["run"]
        assert runs == 1, f"{bench.name}: scheduled in {runs} hts_run launches"
        run_paths[bench.name] = run_paths.get(bench.name, 0) + runs
        peak = torch.cuda.max_memory_allocated()
        assert r.cycles == g.cycles and \
            r.schedule_tuple() == g.schedule_tuple(), \
            f"{bench.name}: the card's schedule differs from golden"
        live = {k: 0 for k in counts}
        for _uid, fname in executed:
            live["fft" if fname == "fft_256" else fname] += 1
        assert counts == live, \
            f"{bench.name}: launches {counts} != live tasks {live}"
        assert {k: v for k, v in live.items() if v} == live_want, \
            f"{bench.name}: live tasks {live} != {live_want}"
        tasks = dsp_pipeline.issued_tasks(r)
        table = ops.dsp_dispatch_table()
        exec_s, walls, again = time_execution(tasks, x, table)
        with Fp32Matmul(torch):
            plain = dsp_pipeline.execute(tasks, x, ops.plain_dispatch_table())
        err = max_err(out, plain)
        assert bool(torch.isfinite(out).all()), "output not finite"
        assert torch.allclose(out, plain, rtol=PIPELINE_TOL,
                              atol=PIPELINE_TOL), \
            f"{bench.name}: output differs from the plain pipeline " \
            f"(max abs err {err:.3g})"
        assert torch.equal(again, out), "the kernels are not repeatable"
        B = x.shape[0]
        log(f"{bench.name}: {r.cycles} cycles = golden, "
            f"{len(executed)} tasks executed, launches {counts} (and one "
            f"hts_run to schedule), "
            f"max abs err vs plain {err:.3g} (tolerance {PIPELINE_TOL})")
        log(f"{bench.name}: run_pipeline {wall:.3f} s (schedule + "
            f"execute); executed schedule, median of {EXEC_REPS}: "
            f"{exec_s * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max "
            f"{max(walls) * 1e3:.3f}), {B / exec_s:.0f} {unit}/s, "
            f"{x.numel() / exec_s:.4g} samples/s; run_pipeline's peak "
            f"device memory {peak / 2**20:.1f} MiB  on {card}")
        profile_execution(bench.name, tasks, x, table, exec_s)
        return r, counts

    # 6b. the audio pipeline: schedule on the card, DSP kernels execute it --
    path_launches: dict = {}

    def audio_pipeline():
        rng = np.random.default_rng(PIPELINE_SEED)
        x = torch.from_numpy(rng.standard_normal(
            (FRAMES, SAMPLES), dtype=np.float32)).to(DEVICE)
        for td in (False, True):
            bench = programs.audio_compression(BANDS, time_domain=td)
            _r, counts = pipeline_run(bench, x, HtsParams(),
                                      LIVE_8_BANDS[td], "frames")
            path_launches["audio_bt" if td else "audio_bnt"] = counts
        log(f"DSP launches on the audio pipeline {path_launches}")
    phase("6b audio pipeline", audio_pipeline)

    # 7. the image program, alone and sharing the pool with audio ----------
    def image_pipelines():
        params = dsp_pipeline.SHARED_PARAMS
        rng = np.random.default_rng(IMAGE_SEED)
        x = torch.from_numpy(rng.standard_normal(
            (TILES, PIXELS), dtype=np.float32)).to(DEVICE)
        audio = programs.audio_straightline(SHARED_BANDS)
        image = programs.image_compression(IMAGE_TILES)
        shared = programs.merge_benches([audio, image])
        ga = api.run(audio, scheduler="hts_spec", n_fu=2, params=params,
                     backend="golden")
        cuda_run.reset_launches()
        ra = api.run(audio, scheduler="hts_spec", n_fu=2, params=params,
                     device=DEVICE)
        runs = cuda_run.launches["run"]
        assert runs == 1, f"{audio.name}: {runs} hts_run launches"
        run_paths[audio.name] = run_paths.get(audio.name, 0) + runs
        assert ra.cycles == ga.cycles == CYCLES["audio"] and \
            ra.schedule_tuple() == ga.schedule_tuple(), \
            f"{audio.name}: the card's schedule differs from golden"
        cycles = {"audio": ra.cycles}
        peak = 0
        for key, bench, live in (("image", image, LIVE_IMAGE),
                                 ("shared", shared, LIVE_SHARED)):
            r, counts = pipeline_run(bench, x, params, live, "tiles")
            peak = max(peak, torch.cuda.max_memory_allocated())
            assert r.cycles == CYCLES[key], f"{key}: {r.cycles} cycles"
            cycles[key] = r.cycles
            path_launches[key] = counts
        log(f"phase 7 peak device memory {peak / 2**20:.1f} MiB "
            f"(torch.cuda.max_memory_allocated: run_pipeline, the timed "
            f"and plain executions; 64 MiB a tile tensor)  on {card}")
        gain = (cycles["audio"] + cycles["image"]) / cycles["shared"]
        log(f"sharing: audio alone {cycles['audio']} + image alone "
            f"{cycles['image']} cycles serially, shared {cycles['shared']}: "
            f"gain {gain:.4f}x (equal to golden on the card)")
    phase("7 image and shared pipelines", image_pipelines)

    # 8. the paper's evaluation -------------------------------------------
    def kernel_counts(names) -> dict:
        """Live tasks per DSP launch counter (``fft_256`` runs ``fft``)."""
        live = {k: 0 for k in dsp.launches}
        for fname in names:
            live["fft" if fname == "fft_256" else fname] += 1
        return live

    def table_ii():
        dsp.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = dsp_pipeline.table_ii(TABLE_FRAMES, TABLE_SEED, DEVICE)
        wall = time.perf_counter() - t0
        counts = dict(dsp.launches)
        path_launches["table2"] = counts
        plain = ops.plain_dispatch_table()
        frames = dsp_pipeline.table_ii_frames(TABLE_FRAMES, TABLE_SEED)
        for name, (y, sec) in rows.items():
            x = torch.from_numpy(frames[name]).to(DEVICE)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with Fp32Matmul(torch):
                want = plain[name](x)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
            err = max_err(y, want) if y.shape == want.shape else math.inf
            tol = ENTRY_TOL[name]
            _fid, frame, cyc = costs.FUNCTIONS[name]
            log(f"Table II {name:13s} B={TABLE_FRAMES} N={frame:<3d} "
                f"{sec * 1e3:8.3f} ms (one call, synchronised; plain "
                f"{plain_s * 1e3:8.3f} ms)  {TABLE_FRAMES / sec:.4g} "
                f"frames/s  paper {cyc} cycles a frame  max abs err vs "
                f"plain {err:.3g} (tolerance {tol or 'torch.equal'})  on "
                f"{card}")
            assert bool(torch.isfinite(y).all()), f"{name}: not finite"
            assert same(torch, y, want, tol), \
                f"Table II {name} differs from the plain entry ({err:.3g})"
        assert counts == {k: 1 for k in counts}, \
            f"Table II launches {counts}, expected one each"
        log(f"Table II: ten entries in {wall:.3f} s (frames made with numpy "
            f"included), launches {counts}")

    def figs_7_8():
        fig7 = [g() for g in programs.SYNTHETIC_NO_BRANCH]
        fig8 = [g() for g in programs.SYNTHETIC_BRANCH]
        # the first trips of the Fig 7 hts_spec sweep's machine, checked:
        # the first multi-lane population with per-lane n_fu at 16 units
        pop = batch.pack_population(fig7)
        lanes = api._cross_points(pop, [batch.norm_n_fu(k)
                                        for k in FIG7_FU])
        sspec = machine.MachineSpec(params=pop.params,
                                    costs=costs.costs_by_name("hts_spec"),
                                    max_fu_per_class=16)
        m = machine.make_machine(sspec, pop.max_prog, DEVICE)
        args = lanes.machine_args()
        a = machine.norm_args(m, *args)
        st = m.init(*args)
        limit = torch.full_like(st["steps"], machine.BIG)
        before = checker.checks
        for _ in range(SWEEP_CHECK_TRIPS):
            machine.step(m, st, a, limit, ops=checker)
        torch.cuda.synchronize()
        log(f"Fig 7 sweep ({len(lanes)} lanes, 16 units a class), trips "
            f"0..{SWEEP_CHECK_TRIPS - 1}: {checker.checks - before} kernel "
            "launches equal to their plain versions")
        for label, benches, points in (("Fig 7", fig7, FIG7_FU),
                                       ("Fig 8", fig8, FIG8_FU)):
            cuda_step.reset_launches()
            cuda_run.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sw = api.sweep(benches, n_fu=points,
                           schedulers=costs.ALL_SCHEDULERS, device=DEVICE)
            wall = time.perf_counter() - t0
            runs, trips = cuda_run.launches["run"], dict(cuda_step.launches)
            assert runs == len(sw.schedulers) and not any(trips.values()), \
                f"{label}: hts_run {runs} launches, K1-K4 {trips}"
            run_paths[label] = runs
            bad = []
            for sched in sw.schedulers:
                for si, b in enumerate(benches):
                    for i, k in enumerate(points):
                        g = api.run(b, scheduler=sched, n_fu=k,
                                    backend="golden")
                        if g.cycles != int(sw.cycles[sched][si, i]):
                            bad.append((b.name, sched, k))
            log(f"{label}: {len(benches)} programs x {len(points)} points x "
                f"{len(sw.schedulers)} schedulers, one sweep: {wall:.4f} s "
                f"on the card ({runs} hts_run launches, one a scheduler)  "
                f"on {card}")
            for si, b in enumerate(benches):
                for i, k in enumerate(points):
                    cells = "  ".join(
                        f"{sched} {int(sw.cycles[sched][si, i])} "
                        f"({float(sw.speedup(sched, 'naive')[si, i]):.3f}x)"
                        for sched in sw.schedulers)
                    log(f"  {b.name:24s} fu{k}  {cells}")
            assert not bad, f"{label}: points differ from golden: {bad}"
            log(f"{label}: every point equal to golden (cycles)")

    def synthetic_schedules():
        rng = np.random.default_rng(SYNTH_SEED)
        x = torch.from_numpy(rng.standard_normal(
            (TABLE_FRAMES, TABLE_SAMPLES), dtype=np.float32)).to(DEVICE)
        table = ops.dsp_dispatch_table()
        totals = {k: 0 for k in dsp.launches}
        walls_ms = []                   # each schedule's median wall
        for name, gen in dsp_pipeline.SYNTHETIC.items():
            bench = gen()
            g = api.run(bench, scheduler="hts_spec", n_fu=2,
                        backend="golden")
            checks: list = []
            torch.cuda.synchronize()
            dsp.reset_launches()
            cuda_run.reset_launches()
            t0 = time.perf_counter()
            with Fp32Matmul(torch):
                r, executed, out = dsp_pipeline.run_pipeline(
                    bench, x, device=DEVICE, checks=checks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(dsp.launches)
            runs = cuda_run.launches["run"]
            assert runs == 1, f"{name}: scheduled in {runs} hts_run launches"
            run_paths[f"synthetic/{name}"] = runs
            path_launches[f"synthetic/{name}"] = counts
            assert r.cycles == g.cycles == SYNTH_CYCLES[name] and \
                r.schedule_tuple() == g.schedule_tuple(), \
                f"{name}: the card's schedule differs from golden"
            gold_live = kernel_counts(
                t.func_name for t in dsp_pipeline.issued_tasks(g))
            live = kernel_counts(fname for _uid, fname in executed)
            assert live == gold_live, f"{name}: live {live} != {gold_live}"
            assert counts == live, \
                f"{name}: launches {counts} != live tasks {live}"
            assert [(c.uid, c.func) for c in checks] == executed
            bad = [(c.uid, c.func, c.max_err) for c in checks
                   if not c.max_scaled <= ENTRY_TOL[c.func]]
            assert not bad, f"{name}: tasks differ from plain: {bad}"
            worst = {}
            for c in checks:
                worst[c.func] = max(worst.get(c.func, 0.0), c.max_err)
            first_zero = next((i for i, c in enumerate(checks)
                               if c.output_zero), None)
            on_nonzero = kernel_counts(c.func for c in checks
                                       if not c.input_zero)
            tasks = dsp_pipeline.issued_tasks(r)
            exec_s, walls, again = time_execution(tasks, x, table)
            profile_execution(name, tasks, x, table, exec_s)
            assert bool(torch.isfinite(out).all()), f"{name}: not finite"
            assert torch.equal(again, out), \
                f"{name}: the kernels are not repeatable"
            for k, v in counts.items():
                totals[k] += v
            walls_ms.append(exec_s * 1e3)
            log(f"{name}: {r.cycles} cycles = golden, {len(executed)} tasks "
                f"executed, each held against the plain entry (max abs err "
                f"by function {worst}); launches "
                f"{ {k: v for k, v in counts.items() if v} }; run_pipeline "
                f"with checks {wall:.3f} s")
            log(f"{name}: executed schedule, median of {EXEC_REPS}: "
                f"{exec_s * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max "
                f"{max(walls) * 1e3:.3f}), {TABLE_FRAMES / exec_s:.0f} "
                f"frames/s; first all-zero output at task index "
                f"{first_zero}; launches on non-zero input "
                f"{ {k: v for k, v in on_nonzero.items() if v} }  on {card}")
        log(f"nine synthetic schedules: launches {totals}; median walls "
            f"summed {sum(walls_ms):.3f} ms  on {card}")
        assert (totals["complex_fir"], totals["adaptive_fir"],
                totals["iir"]) == (18, 18, 17), totals

    def fig_10():
        t_phase = time.perf_counter()
        # Fig 10's capacities (benchmarks/paper_figs.py:76-82)
        params = HtsParams(max_tasks=256, mem_words=2048,
                           tracker_entries=256, rs_entries=64)
        benches = [programs.audio_compression(b, False) for b in FIG10_BANDS]
        cuda_step.reset_launches()
        cuda_run.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sw = api.sweep(benches, n_fu=FIG10_FU, schedulers=("naive",
                                                           "hts_spec"),
                       params=params, max_prog=64, device=DEVICE)
        wall = time.perf_counter() - t0
        runs, trips = cuda_run.launches["run"], dict(cuda_step.launches)
        assert runs == 2 and not any(trips.values()), \
            f"Fig 10: hts_run {runs} launches, K1-K4 {trips}"
        run_paths["Fig 10"] = runs
        sp = sw.speedup("hts_spec", "naive")
        for si, bands in enumerate(FIG10_BANDS):
            row = "  ".join(f"fu{k} {int(sw.cycles['hts_spec'][si, i])}/"
                            f"{int(sw.cycles['naive'][si, i])} "
                            f"({float(sp[si, i]):.3f}x)"
                            for i, k in enumerate(FIG10_FU))
            log(f"Fig 10 bands {bands:2d} (hts_spec/naive cycles): {row}")
        bad = []
        for sched in sw.schedulers:
            for i, k in enumerate(FIG10_FU):
                g = api.run(benches[0], scheduler=sched, n_fu=k,
                            params=params, backend="golden")
                if g.cycles != int(sw.cycles[sched][0, i]):
                    bad.append((sched, k))
        assert not bad, f"Fig 10 bands-8 points differ from golden: {bad}"
        log(f"Fig 10: sweep {wall:.4f} s on the card (wall per scheduler "
            f"{ {k: round(v / 1e3, 3) for k, v in sw.wall_us.items()} } ms, "
            f"{runs} hts_run launches); bands-8 points equal to golden; "
            f"largest speedup of hts_spec over naive "
            f"{float(sp.max()):.3f}x (paper abstract: up to 12x); phase "
            f"wall {time.perf_counter() - t_phase:.1f} s  on {card}")

    for name, fn in (("8a Table II", table_ii), ("8b Figs 7 and 8", figs_7_8),
                     ("8c nine synthetic schedules", synthetic_schedules),
                     ("8d Fig 10", fig_10)):
        phase(name, fn)

    # 9. the model path: Qwen2-1.5B at full width on K15 and K16 ----------
    tlib = dsp.TRANSFORMER_LIB
    tf_err = {k: 0.0 for k in tlib.launches}
    tf_launches: dict = {}

    zero = dict.fromkeys(tlib.launches, 0)
    kernels = dict(attention=attention, rmsnorm=rmsnorm, rwkv6=rwkv6,
                   mamba2=mamba2)

    def tf_check(name, shape, dt, seed):
        """One K15 or K16 call against its plain version."""
        args = tf_case(torch, name, shape, getattr(torch, dt), seed)
        if name == "flash_attention":
            q, k, v, causal, q_offset = args
            got = attention.flash_attention(q, k, v, causal=causal,
                                            q_offset=q_offset)
            want = ref.flash_attention(
                q[:, None], k[:, None], v[:, None], causal=causal,
                q_offset=q_offset)[:, 0]
            tol = TF_TOL[dt][1]
        else:
            got = rmsnorm.rmsnorm(*args)
            want = ref.rmsnorm(*args)
            tol = TF_TOL[dt][0]
        torch.cuda.synchronize()
        err = max_err(got.float(), want.float())
        tf_err[name] = max(tf_err[name], err)
        assert got.dtype == want.dtype and bool(
            torch.isfinite(got).all()), f"{name} {shape}: not finite"
        assert torch.allclose(got.float(), want.float(), rtol=tol,
                              atol=tol), \
            f"{name} {shape} {dt}: max abs err {err:.3g} > {tol}"
        log(f"{name:15s} {str(shape):34s} {dt:8s} max abs err "
            f"{err:.3g} (rtol = atol = {tol})")

    def tf_vs_plain():
        cases = [("flash_attention", c) for c in ATTN_CASES]
        cases += [("rmsnorm", c) for c in RMS_CASES]
        for i, (name, shape) in enumerate(cases):
            for dt in ("bfloat16", "float32"):
                tf_check(name, shape, dt, 300 + i)
        log(f"TF32 for float32 matmuls: "
            f"{torch.backends.cuda.matmul.allow_tf32} (the plain attention's "
            "einsums run in full float32)")

    def model_setup():
        cfg = model_config(registry.get_config)
        model = registry.build(cfg, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(MODEL_SEED)
        torch.cuda.synchronize()
        n = model.param_count()
        log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads of "
            f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, QKV bias "
            f"{cfg.qkv_bias}: {n / 1e9:.4f} B parameters, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card in "
            f"{params['embed'].dtype} (seed {MODEL_SEED}, "
            f"{time.perf_counter() - t0:.2f} s)")
        ctx.update(model=model, params=params)

    def drive(model, params, tok, feeds, on=False, **swap):
        """``prefill`` of ``tok``, then DECODE_STEPS ``decode_step``s, on
        the path ``on`` and ``swap`` select (``plain_path``'s arguments;
        off: the kernels).  Greedy when ``feeds`` is empty (it is filled
        with the tokens fed), else fed ``feeds`` (teacher-forced).
        Returns the last-position prefill logits, each step's logits, the
        launches, walls and peak memory of both."""
        with plain_path(on, ref, **kernels, **swap):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tlib.reset_launches()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, tok, PREFILL_MAX_LEN)
            last = logits[:, -1].float()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(tlib.launches)
            peak = torch.cuda.max_memory_allocated()
            del logits
            greedy = not feeds
            if greedy:
                feeds.append(last.argmax(-1))
            steps = []
            tlib.reset_launches()
            torch.cuda.synchronize()
            d0 = time.perf_counter()
            for i in range(DECODE_STEPS):
                lg, cache = model.decode_step(
                    params, cache, feeds[i][:, None].to(torch.int32),
                    PREFILL_T + i)
                steps.append(lg[:, -1].float())
                if greedy:
                    feeds.append(steps[-1].argmax(-1))
            torch.cuda.synchronize()
            dwall = time.perf_counter() - d0
            dcounts = dict(tlib.launches)
            del cache
        assert bool(torch.isfinite(last).all()) and all(
            bool(torch.isfinite(x).all()) for x in steps), "not finite"
        return dict(last=last, steps=steps, counts=counts, dcounts=dcounts,
                    wall=wall, dwall=dwall, peak=peak)

    def logit_errors(what, got, want, limit=None):
        """Normwise errors of the last-position prefill logits and of each
        decode step's, with argmax agreement, printed; the largest."""
        err = normwise(got["last"], want["last"])
        errs = [normwise(a, b) for a, b in zip(got["steps"], want["steps"])]
        agree = np.mean([float((a.argmax(-1) == b.argmax(-1)).float().mean())
                         for a, b in zip([got["last"]] + got["steps"],
                                         [want["last"]] + want["steps"])])
        gate = "not gated" if limit is None else f"limit {limit}"
        log(f"{what}: normwise, prefill {err:.3g}, {DECODE_STEPS} decode "
            f"steps (teacher-forced) max {max(errs):.3g} mean "
            f"{np.mean(errs):.3g} ({gate}); argmax agreement {agree:.3f}")
        return max([err] + errs)

    def prompt_tokens(model):
        rng = np.random.default_rng(MODEL_SEED)
        return torch.from_numpy(rng.integers(
            0, model.cfg.vocab, (PREFILL_B, PREFILL_T)).astype(np.int32)
        ).to(DEVICE)

    def prefill_path():
        """bfloat16 prefill and decode on the kernels and on the plain ops,
        timed; their logits are reported, not gated (the gates are the
        float32 logits and the per-layer attention below)."""
        model, params = ctx["model"], ctx["params"]
        tok = prompt_tokens(model)
        Lr = model.cfg.n_layers
        # warm-up, untimed: each path's first prefill and decode step pay
        # for cuBLAS's and the allocator's first calls at these shapes
        for path in ("kernels", "plain"):
            with plain_path(path == "plain", ref, **kernels):
                logits, cache = model.prefill(params, tok, PREFILL_MAX_LEN)
                model.decode_step(params, cache, tok[:, :1], PREFILL_T)
                del logits, cache
        feeds: list = []
        runs = {"kernels": drive(model, params, tok, feeds),
                "plain": drive(model, params, tok, feeds, on=True)}
        for path, r in runs.items():
            log(f"prefill ({path}) B={PREFILL_B} T={PREFILL_T} max_len "
                f"{PREFILL_MAX_LEN}: {r['wall'] * 1e3:.1f} ms, "
                f"{PREFILL_B * PREFILL_T / r['wall']:.0f} tokens/s, launches "
                f"{r['counts']}, peak device memory {r['peak'] / 1e9:.3f} "
                f"GB; {DECODE_STEPS} decode steps at B={PREFILL_B}: "
                f"{r['dwall'] / DECODE_STEPS * 1e3:.2f} ms a step, launches "
                f"{r['dcounts']}  on {card}")
        k, pl = runs["kernels"], runs["plain"]
        assert k["counts"] == {**zero, "flash_attention": Lr,
                               "rmsnorm": 2 * Lr + 1}, k["counts"]
        assert pl["counts"] == zero and pl["dcounts"] == zero
        assert k["dcounts"] == {**zero,
                                "rmsnorm": DECODE_STEPS * (2 * Lr + 1)}
        tf_launches["prefill"] = k["counts"]
        tf_launches["decode"] = k["dcounts"]
        logit_errors("bf16 logits, kernels vs plain", k, pl)
        ctx["prefill_tokens"] = tok

    def fp32_logit_gate():
        """Gate A: in float32 (the same seed's draws, unrounded), the
        logits of prefill and of every decode step on the kernels against
        the plain ops within FP32_LOGIT_TOL, and a control, K15 swapped for
        the plain attention with its scores rounded to bfloat16, which must
        fail the same limit."""
        model = ctx["model"]
        tok = prompt_tokens(model)
        Lr = model.cfg.n_layers
        tol = FP32_LOGIT_TOL[ARCH]
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            p32 = model.init(MODEL_SEED)
            feeds: list = []
            k = drive(model, p32, tok, feeds)
            pl = drive(model, p32, tok, feeds, on=True)
            ctl = drive(model, p32, tok, feeds, on=True,
                        only=("flash_attention",),
                        attn=attention_bf16_scores)
            del p32
        finally:
            layers.COMPUTE_DTYPE = saved
        assert k["counts"] == {**zero, "flash_attention": Lr,
                               "rmsnorm": 2 * Lr + 1}, k["counts"]
        assert ctl["counts"] == {**zero, "rmsnorm": 2 * Lr + 1}, \
            ctl["counts"]
        log(f"float32 prefill (kernels): {k['wall'] * 1e3:.1f} ms, "
            f"{DECODE_STEPS} decode steps "
            f"{k['dwall'] / DECODE_STEPS * 1e3:.2f} ms a step  on {card}")
        err = logit_errors("fp32 logits, kernels vs plain", k, pl, tol)
        c_err = logit_errors("fp32 logits, control (K15 plain, scores "
                             "rounded to bf16) vs plain", ctl, pl, tol)
        assert err <= tol, f"fp32 logits differ ({err:.3g} > {tol})"
        if c_err <= tol:
            raise AssertionError(f"the control passes the fp32 gate at "
                                 f"{tol} ({c_err:.3g}): it cannot tell a "
                                 "kernel with bfloat16 scores")
        log(f"the control fails the fp32 gate, as it must ({c_err:.3g} > "
            f"{tol})")

    def attention_layer_gate():
        """Gate B: one bfloat16 prefill on the plain ops at the reference's
        init, each layer's attention inputs caught; on each layer's
        inputs K15 against the plain attention, normwise, within K15's
        bf16 tolerance, and the control (scores rounded to bf16), which
        must fail it; SDPA's reading printed beside them (not a gate)."""
        model, params = ctx["model"], ctx["params"]
        tok = prompt_tokens(model)
        tol = TF_TOL["bfloat16"][1]
        F = torch.nn.functional
        with plain_path(True, ref, **kernels), \
                capture_attention(attention, ref) as calls:
            logits, cache = model.prefill(params, tok, PREFILL_MAX_LEN)
            del logits, cache
        assert len(calls) == model.cfg.n_layers, len(calls)
        tlib.reset_launches()
        reads = {"kernel": [], "control": [], "sdpa": []}
        for q, k, v, kw in calls:
            want = plain_attention(ref, q, k, v, **kw)
            assert kw.get("q_offset", 0) == 0 and q.shape == k.shape
            got = {"kernel": attention.flash_attention(q, k, v, **kw),
                   "control": attention_bf16_scores(ref, q, k, v, **kw),
                   "sdpa": F.scaled_dot_product_attention(
                       q, k, v, is_causal=kw["causal"])}
            for name, out in got.items():
                assert bool(torch.isfinite(out).all()), name
                reads[name].append(normwise(out, want))
            del got, want
        assert tlib.launches["flash_attention"] == len(calls)
        q, k = calls[0][0].float(), calls[0][1].float()
        spread = float((q @ k.transpose(1, 2)).abs().max()) * \
            q.shape[-1] ** -0.5
        log(f"per-layer bf16 attention on {len(calls)} layers' inputs "
            f"{tuple(calls[0][0].shape)} (layer 0's scaled scores span "
            f"±{spread:.0f}), normwise against plain, limit {tol}:")
        for name, r in reads.items():
            log(f"    {name:8s} max {max(r):.3g} mean {np.mean(r):.3g}  per "
                f"layer {[float(f'{x:.3g}') for x in r]}")
        assert max(reads["kernel"]) <= tol, \
            f"K15 per-layer error {max(reads['kernel']):.3g} > {tol}"
        if max(reads["control"]) <= tol:
            raise AssertionError(f"the control passes the per-layer gate at "
                                 f"{tol}: it cannot tell bfloat16 scores")
        log(f"the control fails the per-layer gate, as it must "
            f"({max(reads['control']):.3g} > {tol})")
        del calls

    def serve_requests():
        rng = np.random.default_rng(SERVE_SEED)
        vocab = ctx["model"].cfg.vocab
        out = []
        for _ in range(SERVE_REQUESTS):
            n = int(rng.integers(PROMPT_LEN[0], PROMPT_LEN[1] + 1))
            out.append((rng.integers(0, vocab, n).tolist(),
                        int(rng.integers(MAX_NEW[0], MAX_NEW[1] + 1))))
        return out

    def server_path():
        model, params = ctx["model"], ctx["params"]
        reqs = serve_requests()
        Lr = model.cfg.n_layers
        stats = {}
        for policy in ("ooo", "naive"):
            srv = serving.Server(model, params, n_slots=SERVE_SLOTS,
                                 max_len=SERVE_MAX_LEN, policy=policy)
            objs = [serving.Request(i, list(p), m)
                    for i, (p, m) in enumerate(reqs)]
            for r in objs:
                srv.submit(r)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tlib.reset_launches()
            t0 = time.perf_counter()
            st = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(tlib.launches)
            peak = torch.cuda.max_memory_allocated()
            tf_launches[f"server/{policy}"] = counts
            stats[policy] = st
            assert st.completed == SERVE_REQUESTS and all(
                r.done and len(r.out) == r.max_new for r in objs), \
                f"{policy}: {st.completed} of {SERVE_REQUESTS} completed"
            assert counts == {**zero, "rmsnorm": st.steps * (2 * Lr + 1)}, \
                counts
            log(f"Server {policy}: {SERVE_REQUESTS} requests, {st.steps} "
                f"steps, utilization {st.utilization(SERVE_SLOTS):.4f}, "
                f"{st.slot_busy_steps} slot-steps in {wall:.3f} s: "
                f"{st.slot_busy_steps / wall:.1f} tokens/s, "
                f"{wall / st.steps * 1e3:.2f} ms a step, K16 launches a "
                f"step {counts['rmsnorm'] / st.steps:.0f}, peak device "
                f"memory {peak / 1e9:.3f} GB  on {card}")
            ctx[f"server_{policy}"] = objs
        assert stats["ooo"].steps < stats["naive"].steps, \
            f"ooo {stats['ooo'].steps} steps, naive {stats['naive'].steps}"
        log(f"ooo takes {stats['ooo'].steps} steps against naive's "
            f"{stats['naive'].steps}: {stats['naive'].steps / stats['ooo'].steps:.4f}x")

        # where a step's time goes: a traced window of steps mid-run
        srv = serving.Server(model, params, n_slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN)
        for i, (p_, m) in enumerate(reqs):
            srv.submit(serving.Request(i, list(p_), m))
        for _ in range(48):
            srv.step()

        def steps(n):
            for _ in range(n):
                srv.step()
        try:
            events, wall_us = trace_window(torch, lambda: steps(1),
                                           lambda: steps(TRACE_STEPS))
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"server step profile not measured (profiler: {e})")
        else:
            busy = sum(us for _k, us in events)
            log(f"Server step profile ({TRACE_STEPS} steps from step 49, "
                f"{sum(srv.busy)} busy slots): {wall_us / TRACE_STEPS / 1e3:.3f}"
                f" ms wall a step, device busy {busy / TRACE_STEPS / 1e3:.3f} "
                f"ms a step ({100 * busy / wall_us:.1f} %), "
                f"{len(events) / TRACE_STEPS:.0f} device activities a step  "
                f"on {card}")
            for key, us, cnt in costliest(events, TRACE_STEPS):
                log(f"    {us:9.1f} us/step  x{cnt:<4d} {key}")

        # one staggered request against greedy decoding at B = 1 (printed,
        # not gated: the batch size changes the matmul kernels, so bf16
        # near-ties may flip)
        r = ctx["server_ooo"][STAGGERED]
        want = specdecode.greedy_decode(model, params,
                                        np.asarray([r.prompt]), len(r.out),
                                        SERVE_MAX_LEN)[0].tolist()
        same = next((i for i, (a, b) in enumerate(zip(r.out, want))
                     if a != b), len(want))
        log(f"request {STAGGERED} (prompt {len(r.prompt)}, {len(r.out)} new "
            f"tokens) under ooo against greedy_decode at B=1: the first "
            f"{same} tokens agree, {sum(a == b for a, b in zip(r.out, want))}"
            f" of {len(want)} in all")

    for name, fn in (("9a K15 and K16 vs plain", tf_vs_plain),
                     ("9 model setup", model_setup)):
        phase(name, fn)
    if "model" in ctx:
        phase("9b prefill at full width", prefill_path)
        phase("9b float32 logits gate", fp32_logit_gate)
        phase("9b per-layer bf16 attention gate", attention_layer_gate)
        phase("9c the Server at full width", server_path)
        ctx.pop("params", None)      # free Qwen2's weights; its cfg stays

    # 10. the ssm and hybrid families at full width on K17 and K18 ----------
    rec_wrappers = {"wkv6": rwkv6.wkv6, "ssd": mamba2.ssd}

    def rec_vs_plain():
        cases = [("wkv6", c, d) for c in WKV_CASES for d in WKV_DECAYS]
        cases += [("ssd", c, "drawn") for c in SSD_CASES]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i, (name, shape, decay) in enumerate(cases):
            for dt in ("bfloat16", "float32"):
                args = rec_case(torch, name, shape, getattr(torch, dt),
                                700 + i, decay)
                got = rec_wrappers[name](*args)
                want = rec_plain(ref, name, args)
                torch.cuda.synchronize()
                err = max_err(got.float(), want.float())
                rel = normwise(got, want)
                tf_err[name] = max(tf_err[name], err)
                tol = REC_TOL[dt]
                assert got.dtype == want.dtype and bool(
                    torch.isfinite(got).all()), f"{name} {shape}: not finite"
                if dt == "float32":
                    assert rel <= tol, \
                        f"{name} {shape}: normwise error {rel:.3g} > {tol}"
                    how = f"normwise <= {tol}"
                else:
                    assert torch.allclose(got.float(), want.float(),
                                          rtol=tol, atol=tol), \
                        f"{name} {shape} bf16: max abs err {err:.3g} > {tol}"
                    how = f"rtol = atol = {tol}"
                log(f"{name:5s} {str(shape):24s} {decay:5s} {dt:8s} max abs "
                    f"err {err:.3g}, normwise {rel:.3g} ({how})")
        for dt in ("bfloat16", "float32"):
            tf_check("flash_attention", ATTN_112, dt, 800)
            for i, shape in enumerate(RMS_SSM_CASES):
                tf_check("rmsnorm", shape, dt, 810 + i)
        B, T, H, P, N = SSD_CASES[0]
        Bw, Tw, Hw, Kw, Vw = WKV_CASES[0]
        log(f"10a peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB (the plain "
            f"versions' loops included); K18's scratch at {SSD_CASES[0]}: "
            f"{mamba2.scratch_floats(B, T, H, P, N) * 4 / 1e6:.1f} MB, "
            f"K17's at {WKV_CASES[0]}: "
            f"{rwkv6.scratch_floats(Bw * Hw, Tw, Kw, Vw) * 4 / 1e6:.1f} MB  "
            f"on {card}")

    def ssm_model(arch):
        cfg = registry.get_config(arch)
        model = registry.build(cfg, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(MODEL_SEED)
        torch.cuda.synchronize()
        log(f"{arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads} heads (head dim {cfg.head_dim}), ssm "
            f"{cfg.ssm}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: "
            f"{model.param_count() / 1e9:.4f} B parameters, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card "
            f"(seed {MODEL_SEED}, {time.perf_counter() - t0:.2f} s)")
        ctx["ssm"] = (model, params)

    def ssm_counts(cfg):
        """K15–K18 launches of one ``forward`` and of one decode step."""
        L = cfg.n_layers
        if cfg.family == "ssm":
            return ({**zero, "rmsnorm": 2 * L + 1, "wkv6": L},
                    {**zero, "rmsnorm": 2 * L + 1})
        groups = L // cfg.shared_attn_period
        norms = L + 2 * groups + 1
        return ({**zero, "rmsnorm": norms, "flash_attention": groups,
                 "ssd": L}, {**zero, "rmsnorm": norms})

    def ssm_forward(arch):
        """forward on 2 x 1024 tokens: bf16 on the kernels (timed), on the
        plain ops, and on the kernels with K16 alone on its plain version
        (the bf16 floor: K16 is within an ulp of its plain version, so
        this is what one exact op swapped costs these random-weight
        models); then float32 (the same seed's draws, unrounded), kernels
        against plain within the model's FP32_LOGIT_TOL, the gate, and
        the control (K17/K18 as the plain recurrence with a bfloat16
        state), which must fail the same gate."""
        model, params = ctx["ssm"]
        rng = np.random.default_rng(MODEL_SEED)
        tok = torch.from_numpy(rng.integers(
            0, model.cfg.vocab, (SSM_B, SSM_T)).astype(np.int32)).to(DEVICE)
        model.forward(params, tok)           # warm-up: cuBLAS, allocator

        def run(path, p, dt):
            swap = {"floor": ("rmsnorm",), "control": ("wkv6", "ssd")}
            with plain_path(path != "kernels", ref, **kernels,
                            only=swap.get(path),
                            rec=rec_bf16_state if path == "control"
                            else None):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                tlib.reset_launches()
                t0 = time.perf_counter()
                logits = model.forward(p, tok)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            counts = dict(tlib.launches)
            log(f"{arch} forward {dt} ({path}) B={SSM_B} T={SSM_T}: "
                f"{wall * 1e3:.1f} ms, {SSM_B * SSM_T / wall:.0f} tokens/s, "
                f"launches {counts}, peak device memory "
                f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB  on {card}")
            assert bool(torch.isfinite(logits).all()), f"{path}: not finite"
            return logits, counts

        def compare(what, got, want):
            err = normwise(got, want)
            agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
            log(f"{arch} logits, {what}: normwise {err:.3g}, argmax "
                f"agreement {agree:.4f}")
            return err

        want = ssm_counts(model.cfg)[0]
        k, kc = run("kernels", params, "bf16")
        assert kc == want, kc
        walls = []
        for _ in range(SSM_FORWARD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.forward(params, tok)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        med = float(np.median(walls))
        log(f"{arch} forward bf16 (kernels), median of {SSM_FORWARD_REPS}: "
            f"{med * 1e3:.1f} ms, {SSM_B * SSM_T / med:.0f} tokens/s (walls "
            f"{[round(w * 1e3, 1) for w in walls]} ms)  on {card}")
        tf_launches[f"{arch}/forward"] = kc
        pl, pc = run("plain", params, "bf16")
        assert pc == zero, pc
        fl, fc = run("floor", params, "bf16")
        assert fc == {**want, "rmsnorm": 0}, fc
        compare("bf16, kernels vs plain (reported)", k, pl)
        compare("bf16, kernels with K16 plain vs kernels (the floor)", fl, k)
        del k, pl, fl
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            p32 = model.init(MODEL_SEED)
            k, kc = run("kernels", p32, "fp32")
            assert kc == want, kc
            pl, _ = run("plain", p32, "fp32")
            ctl, cc = run("control", p32, "fp32")
            assert cc == {**want, "wkv6": 0, "ssd": 0}, cc
        finally:
            layers.COMPUTE_DTYPE = saved
        del p32
        tol = FP32_LOGIT_TOL[arch]

        def gate(what, got):
            err = compare(f"fp32, {what} vs plain (limit {tol})", got, pl)
            assert err <= tol, f"{arch} fp32 logits differ ({err:.3g})"
            return err

        err = gate("kernels", k)
        log(f"{arch} fp32 logits on the kernels: normwise {err:.3g} in this "
            f"run, {FP32_LOGIT_BEFORE[arch]} before K17 and K18 were chunked "
            "(PERF.md §6)")
        try:
            gate("control (K17/K18 plain, state rounded to bf16)", ctl)
        except AssertionError as e:
            log(f"{arch} control fails the fp32 gate, as it must: {e}")
        else:
            raise AssertionError(f"{arch}: the control passes the fp32 "
                                 f"gate at {tol}: it cannot tell a kernel "
                                 "with a bfloat16 state")

    def ssm_server(arch):
        model, params = ctx["ssm"]
        rng = np.random.default_rng(SERVE_SEED)
        reqs = [rng.integers(0, model.cfg.vocab, SSM_PROMPT).tolist()
                for _ in range(SSM_REQUESTS)]

        def server():
            srv = serving.Server(model, params, n_slots=SSM_SLOTS,
                                 max_len=SSM_MAX_LEN)
            objs = [serving.Request(i, list(p), SSM_NEW)
                    for i, p in enumerate(reqs)]
            for r in objs:
                srv.submit(r)
            return srv, objs

        srv, objs = server()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tlib.reset_launches()
        t0 = time.perf_counter()
        st = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tlib.launches)
        tf_launches[f"{arch}/server"] = counts
        assert st.completed == SSM_REQUESTS and all(
            r.done and len(r.out) == SSM_NEW for r in objs), \
            f"{st.completed} of {SSM_REQUESTS} completed"
        per_step = ssm_counts(model.cfg)[1]
        assert counts == {k: v * st.steps for k, v in per_step.items()}, \
            counts
        log(f"{arch} Server: {SSM_REQUESTS} requests, {st.steps} steps, "
            f"utilization {st.utilization(SSM_SLOTS):.4f}, "
            f"{st.slot_busy_steps} slot-steps in {wall:.3f} s: "
            f"{st.slot_busy_steps / wall:.1f} tokens/s, "
            f"{wall / st.steps * 1e3:.2f} ms a step, K16 launches a step "
            f"{counts['rmsnorm'] / st.steps:.0f}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB  on {card}")

        srv, _ = server()
        for _ in range(4):
            srv.step()

        def steps(n):
            for _ in range(n):
                srv.step()
        try:
            events, wall_us = trace_window(torch, lambda: steps(1),
                                           lambda: steps(SSM_TRACE_STEPS))
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"{arch} server step profile not measured (profiler: {e})")
            return
        busy = sum(us for _k, us in events)
        n = SSM_TRACE_STEPS
        log(f"{arch} Server step profile ({n} steps from step 6, "
            f"{sum(srv.busy)} busy slots): {wall_us / n / 1e3:.3f} ms wall "
            f"a step, device busy {busy / n / 1e3:.3f} ms a step "
            f"({100 * busy / wall_us:.1f} %), {len(events) / n:.0f} device "
            f"activities a step  on {card}")
        for key, us, cnt in costliest(events, n):
            log(f"    {us:9.1f} us/step  x{cnt:<4d} {key}")

    def ssm_logic():
        """forward on the kernels against token-by-token decode_step, in
        float32, at the smoke configs (the reference's own check)."""
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            for arch in SSM_ARCHS:
                m = registry.build_smoke(arch, device=DEVICE)
                p = m.init(MODEL_SEED)
                tok = torch.randint(0, m.cfg.vocab, (2, SSM_LOGIC_T),
                                    generator=torch.Generator().manual_seed(
                                        MODEL_SEED)).to(DEVICE)
                tlib.reset_launches()
                seq = m.forward(p, tok)
                torch.cuda.synchronize()
                counts = dict(tlib.launches)
                assert counts == ssm_counts(m.cfg)[0], counts
                cache = m.init_cache(2, SSM_LOGIC_T)
                dec = torch.stack([
                    m.decode_step(p, cache, tok[:, t:t + 1], t)[0][:, 0]
                    for t in range(SSM_LOGIC_T)], 1)
                assert seq.dtype == torch.float32
                err = max_err(dec, seq)
                log(f"{arch} smoke, float32: forward (launches {counts}) vs "
                    f"{SSM_LOGIC_T} decode steps: max abs err {err:.3g} "
                    f"(rtol = atol = {SSM_LOGIC_TOL})")
                assert torch.allclose(dec, seq, rtol=SSM_LOGIC_TOL,
                                      atol=SSM_LOGIC_TOL), err
        finally:
            layers.COMPUTE_DTYPE = saved

    phase("10a K17, K18 and K15 at head dim 112 vs plain", rec_vs_plain)
    for arch in SSM_ARCHS:
        phase(f"10 {arch} setup", functools.partial(ssm_model, arch))
        if "ssm" in ctx:
            phase(f"10b {arch} forward at full width",
                  functools.partial(ssm_forward, arch))
            phase(f"10c {arch} Server at full width",
                  functools.partial(ssm_server, arch))
        ctx.pop("ssm", None)            # one model on the card at a time
    phase("10d forward vs decode in float32", ssm_logic)

    # 5b. DSP kernel times at each path's shape -----------------------------
    def extra_times(row, name, wrapper, plain, i):
        """The kernel at its ``DSP_EXTRA`` shapes too: device, call, plain
        and library (TF32 off) times and the bound, into ``row`` under
        ``*_<B>x<N>`` (``_y_is_x`` / ``_d_is_x`` where the second array is
        x itself, with the bound counting x twice beside it as
        ``bound_two_reads_ms_*``); a note for the log."""
        note = ""
        for b, n, p, alias in DSP_EXTRA.get(name, ()):
            _w, _p, args = dsp_case(torch, kern, name, b, n, p, 150 + i,
                                    alias=alias)
            calls = [functools.partial(wrapper, *args)] * 23
            key = f"{b}x{n}"
            if alias:
                key += "_y_is_x" if name == "correlation" else "_d_is_x"
            row[f"ms_{key}"] = profiled_ms(
                torch, calls, DSP_KERNEL.get(name, f"{name}_kernel"))
            row[f"call_ms_{key}"] = events_ms(torch, calls)
            row[f"plain_ms_{key}"] = events_ms(
                torch, [functools.partial(plain, *args)] * 8)
            with Fp32Matmul(torch):
                call = library_call(torch, name, args, ref)
                row[f"library_ms_{key}"] = (None if call is None else
                                            events_ms(torch, [call] * 23))
            row[f"bound_ms_{key}"] = dsp_bound(name, args)[0]
            two = ""
            if alias:
                row[f"bound_two_reads_ms_{key}"] = dsp_bound(
                    name, args, once=False)[0]
                two = (f" (x read twice: "
                       f"{row[f'bound_two_reads_ms_{key}']:.4f} ms)")
            dev = row[f"ms_{key}"]
            lib = row[f"library_ms_{key}"]
            note += (f"; at {key}: kernel "
                     f"{'not measured' if dev is None else f'{dev:.4f} ms'}"
                     f" on the device, {row[f'call_ms_{key}']:.4f} ms per "
                     f"call, plain {row[f'plain_ms_{key}']:.4f} ms, library "
                     f"{'none' if lib is None else f'{lib:.4f} ms'}, bound "
                     f"{row[f'bound_ms_{key}']:.4f} ms{two}")
        return note

    def dsp_times():
        log(f"torch.get_float32_matmul_precision() = "
            f"{torch.get_float32_matmul_precision()!r}; TF32 off for the "
            "plain and library DCT")
        for i, name in enumerate(dsp.launches):
            b, n = DSP_SHAPE.get(name, (FRAMES, SAMPLES))
            wrapper, plain, args = dsp_case(torch, kern, name, b, n,
                                            DSP_PARAM.get(name), 100 + i)
            got = wrapper(*args)
            bound, by = dsp_bound(name, args)
            calls = [functools.partial(wrapper, *args)] * 23
            k_call = events_ms(torch, calls)
            with Fp32Matmul(torch):
                p_call = events_ms(torch,
                                   [functools.partial(plain, *args)] * 8)
            k_dev = profiled_ms(torch, calls,
                                DSP_KERNEL.get(name, f"{name}_kernel"))
            lib, lib_note = None, " (no single PyTorch call)"
            with Fp32Matmul(torch):
                try:
                    call = library_call(torch, name, args, ref)
                    if call is not None:
                        lib_err = max_err(call(), got)
                        lib = events_ms(torch, [call] * 23)
                        lib_note = (f" (max abs diff from the kernel "
                                    f"{lib_err:.3g})")
                except RuntimeError as e:
                    lib_note = f" (library call failed: {e})"
            by_path = {path: c.get(name, 0)
                       for path, c in path_launches.items()}
            row = dict(
                name=name, route="cuda", source=DSP_SOURCE,
                replaces=DSP_REPLACES[name],
                launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=dsp_err[name],
                ms=k_dev if k_dev is not None else k_call,
                kernel_ms=k_dev if k_dev is not None else k_call,
                call_ms=k_call, plain_ms=p_call, bound_ms=bound,
                bound_by=by, library_ms=lib, shape=[b, n],
                **facts.get(name, {}))
            if name in in_schedule:
                row["ms_in_schedules"] = in_schedule[name]
            lib_note += extra_times(row, name, wrapper, plain, i)
            rows.append(row)
            dev = "not measured" if k_dev is None else f"{k_dev:.4f} ms"
            libs = "none" if lib is None else f"{lib:.4f} ms"
            log(f"{name:11s} B={b} N={n}  kernel {dev} on the device, "
                f"{k_call:.4f} ms per call  plain {p_call:.4f} ms  library "
                f"{libs}{lib_note}  bound {bound:.4f} ms ({by})  launches "
                f"{by_path}  on {card}")
    paths = {"audio_bnt", "audio_bt", "image", "shared", "table2"}
    paths |= {f"synthetic/{name}" for name in dsp_pipeline.SYNTHETIC}
    # with --only the times run on their own, launches counted only where
    # the paths ran
    if paths <= set(path_launches) or only:
        phase("5b DSP kernel times", dsp_times)

    def tf_times():
        F = torch.nn.functional
        shapes, names = {}, []
        if "model" in ctx or only:
            cfg = (ctx["model"].cfg if "model" in ctx
                   else model_config(registry.get_config))
            H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
            B, T = PREFILL_B, PREFILL_T
            shapes.update(flash_attention=(B * H, T, T, Dh, True, 0),
                          rmsnorm=(B * T, cfg.d_model))
            names += ["rmsnorm", "flash_attention"]
        if all(f"{a}/forward" in tf_launches for a in SSM_ARCHS) or only:
            shapes.update(wkv6=WKV_CASES[0], ssd=SSD_CASES[0])
            names += ["wkv6", "ssd"]
        for i, name in enumerate(names):
            if name in rec_wrappers:
                args = rec_case(torch, name, shapes[name], torch.bfloat16,
                                500 + i)
                wrapper = functools.partial(rec_wrappers[name], *args)
                plain = functools.partial(rec_plain, ref, name, args)
                bound, by = rec_bound(name, args)
                fp32_ms, lib_call = None, None
            elif name == "flash_attention":
                args = tf_case(torch, name, shapes[name], torch.bfloat16,
                               500 + i)
                q, k, v, causal, q_offset = args
                kw = dict(causal=causal, q_offset=q_offset)
                wrapper = functools.partial(attention.flash_attention, q, k,
                                            v, **kw)
                plain = functools.partial(
                    lambda q, k, v: ref.flash_attention(
                        q[:, None], k[:, None], v[:, None], **kw)[:, 0],
                    q, k, v)
                # the yardstick on the model's own layout: (B, Hq, T, D)
                # queries against the repeated bf16 K/V, causal
                q4 = q.view(B, H, T, Dh)
                k4 = k.view(B, Hkv, H // Hkv, T, Dh)[:, :, 0] \
                    .repeat_interleave(H // Hkv, dim=1)
                v4 = v.view(B, Hkv, H // Hkv, T, Dh)[:, :, 0] \
                    .repeat_interleave(H // Hkv, dim=1)
                lib_call = functools.partial(
                    F.scaled_dot_product_attention, q4, k4, v4,
                    is_causal=True)
                lib_name = "scaled_dot_product_attention"
                bound, by, fp32_ms = tf_bound(name, args)
            else:
                args = tf_case(torch, name, shapes[name], torch.bfloat16,
                               500 + i)
                x, w = args
                wrapper = functools.partial(rmsnorm.rmsnorm, x, w, cfg.norm_eps)
                plain = functools.partial(ref.rmsnorm, x, w, cfg.norm_eps)
                lib_call = functools.partial(F.rms_norm, x, (x.shape[1],), w,
                                             cfg.norm_eps)
                lib_name = "rms_norm"
                bound, by, fp32_ms = tf_bound(name, args)
            calls = [wrapper] * 23
            k_call = events_ms(torch, calls)
            # plain: 5 timed after 3 warm-ups; K17/K18's 0.1 s loops: 3
            # after 1
            p_call = (events_ms(torch, [plain] * 4, warm=1)
                      if name in rec_wrappers else
                      events_ms(torch, [plain] * 8))
            kname = TF_KERNEL.get(name, f"{name}_kernel")
            split = None
            if name in SPLIT_KERNELS:
                split = profiled_split(torch, calls, SPLIT_KERNELS[name])
                k_dev = None if split is None else sum(split.values())
            else:
                k_dev = profiled_ms(torch, calls, kname)
            lib = None if lib_call is None else events_ms(torch,
                                                          [lib_call] * 23)
            lib_dev = None if lib_call is None else profiled_call_ms(
                torch, [lib_call] * 23)
            by_path = {path: c.get(name, 0) for path, c in tf_launches.items()}
            row = dict(
                name=name, route="cuda", source=TF_SOURCE,
                replaces=TF_REPLACES[name],
                launches=sum(by_path.values()), launches_by_path=by_path,
                max_abs_err=tf_err[name],
                ms=k_dev if k_dev is not None else k_call,
                kernel_ms=k_dev if k_dev is not None else k_call,
                call_ms=k_call, plain_ms=p_call, bound_ms=bound,
                bound_by=by, library_ms=lib, library_device_ms=lib_dev,
                shape=list(shapes[name][:4] if name == "flash_attention"
                           else shapes[name]), dtype="bfloat16",
                **facts.get(name, {}))
            dev = "not measured" if k_dev is None else f"{k_dev:.4f} ms"
            libs = ("none (no single call)" if lib is None
                    else f"{lib:.4f} ms ({lib_name}; "
                    f"{lib_dev if lib_dev is None else round(lib_dev, 4)} ms "
                    "on the device)")
            extra = "" if fp32_ms is None else \
                f"; its work at the fp32 CUDA-core rate {fp32_ms:.4f} ms"
            if split is not None:
                row["split_ms"] = split
                extra += "; a call: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in split.items())
            if name in rec_wrappers:
                B_, T_, H_, X_, Y_ = shapes[name]
                words = (rwkv6.scratch_floats(B_ * H_, T_, X_, Y_)
                         if name == "wkv6" else
                         mamba2.scratch_floats(B_, T_, H_, X_, Y_))
                row["scratch_bytes"] = 4 * words
                extra += f"; scratch {4 * words} bytes"
            if name == "rmsnorm":
                # the ssm and hybrid forwards' widths (rwkv6-3b, zamba2-7b)
                for R, D in RMS_SSM_CASES[:2]:
                    xw = tf_case(torch, name, (R, D), torch.bfloat16, 610 + i)
                    cw = [functools.partial(rmsnorm.rmsnorm, *xw,
                                            cfg.norm_eps)] * 23
                    key = f"{R}x{D}"
                    row[f"ms_{key}"] = profiled_ms(torch, cw, kname)
                    row[f"call_ms_{key}"] = events_ms(torch, cw)
                    lw = [functools.partial(F.rms_norm, xw[0], (D,), xw[1],
                                            cfg.norm_eps)] * 23
                    row[f"library_ms_{key}"] = events_ms(torch, lw)
                    row[f"library_device_ms_{key}"] = profiled_call_ms(torch,
                                                                       lw)
                    row[f"bound_ms_{key}"] = tf_bound(name, xw)[0]
                    extra += (f"; at {R} x {D}: kernel {row[f'ms_{key}']} ms "
                              f"on the device, library "
                              f"{row[f'library_ms_{key}']:.4f} ms "
                              f"({row[f'library_device_ms_{key}']} ms on "
                              f"the device), bound "
                              f"{row[f'bound_ms_{key}']:.4f} ms")
            if name == "flash_attention" and "wkv6" in shapes:
                # zamba2-7b's shape, head dim 112 (not a row of its own)
                a112 = tf_case(torch, name, ATTN_112, torch.bfloat16, 600)
                c112 = [functools.partial(
                    attention.flash_attention, *a112[:3], causal=True)] * 23
                row["ms_d112"] = profiled_ms(torch, c112, kname)
                row["call_ms_d112"] = events_ms(torch, c112)
                row["bound_ms_d112"] = tf_bound(name, a112)[0]
                # the yardstick on zamba2's layout: (B, H, T, D), causal
                Bz = SSM_B
                q4, k4, v4 = (t.view(Bz, ATTN_112[0] // Bz, *t.shape[1:])
                              for t in a112[:3])
                row["library_ms_d112"] = events_ms(torch, [functools.partial(
                    F.scaled_dot_product_attention, q4, k4, v4,
                    is_causal=True)] * 23)
                extra += (f"; at {ATTN_112[:4]} (zamba2-7b): kernel "
                          f"{row['ms_d112']} ms on the device, "
                          f"{row['call_ms_d112']:.4f} ms per call, library "
                          f"{row['library_ms_d112']:.4f} ms ({lib_name}), "
                          f"bound {row['bound_ms_d112']:.4f} ms")
            rows.append(row)
            log(f"{name:15s} {shapes[name]} bf16  kernel {dev} on the "
                f"device, {k_call:.4f} ms per call  plain {p_call:.4f} ms  "
                f"library {libs}  bound {bound:.4f} ms ({by}{extra})  "
                f"launches {by_path}  on {card}")
    if tf_launches or only:
        phase("5b transformer kernel times", tf_times)

    n_kernels = (len(cuda_step.KERNELS) + len(cuda_run.launches)
                 + len(dsp.launches) + len(tlib.launches))
    if only:
        log(f"--only {' '.join(only)}: failed phases {failures}; no kernels "
            "line")
        return 1 if failures else 0
    if failures or len(rows) != n_kernels:
        log(f"FAILED phases: {failures or ['kernel times (not run)']}")
        return 1
    for row in rows:
        if row["name"] == "hts_run":
            row.update(launches=sum(run_paths.values()),
                       launches_by_path=dict(run_paths))
    log(f"hts_run launches by path {run_paths}")
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
