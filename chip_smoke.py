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
at full width through ``forward`` and the ``Server``; the scenario server
``hts.serve``, static and slice-and-refill, on 4096 requests through 1024
lanes; the MoE family (olmoe-1b-7b, qwen2-moe-a2.7b) and paligemma-3b's
prefix-LM attention at full width; phi3-mini-3.8b at full width (head dim
96); whisper-base, the audio family, at full width (head dim 64);
training: Qwen2-1.5B's train steps at full width through
``runtime.train.make_train_step``, one train step of every other
family's smoke model, and the fault-tolerant ``TrainLoop`` and its
launcher — then checks them:

1. device and build: the card's name and power limit, the four kernel
   libraries' builds (time and ``-Xptxas -v`` report); the registers and
   spills of ``hts_run_kernel`` and of each instance of K5
   ``real_fir_packed<KT>``, K7 ``adaptive_fir_packed<K>``, K8
   ``iir_packed<MT>`` and ``iir_flat<MT>``, K7 ``adaptive_fir_flat<K>``
   (the generic instance ``<0>`` among them), K12
   ``correlation_packed<LT>``, K13 ``fft_kernel<L>``, K14
   ``dct_kernel<C>``, bf16 K15 ``flash_attention_wgmma<DP, NWG>``, K16
   ``rmsnorm_vec<T, VPL>``/``rmsnorm_loop<T, VEC>``, K17's three kernels
   (``wkv6_chunk_state``, ``wkv6_state_passing``, ``wkv6_chunk_scan``)
   and K18's (``ssd_chunk_state``, ``ssd_state_passing``,
   ``ssd_chunk_scan``), and the ``HGMMA`` (tensor-core) instructions in
   K15's SASS: each bf16 instance (padded head dim, consumer
   warpgroups: (64, 2), (96, 2), (128, 2), (256, 1), (256, 2)) must have
   them, each float32 one (32, 64, 96, 112, 128, 256) none; ptxas's lines
   on serialised ``wgmma`` in that file are printed;
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
   d the same tensor as x (the dispatch entries' calls) and at 16 taps (its
   flat kernel's generic instance, also at 33 × 100), each also at the
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
   then the float32 ``Server`` over the same requests, four of them
   (``STAGGERED_F32``) against float32 ``greedy_decode`` at B = 1, every
   token equal (gated); (d) the decode flags: ``decode_gqa_packed`` in
   float32, 9b's 32 decode steps flag on against flag off within
   ``FP32_LOGIT_TOL``, a control (the packed scores rounded to bfloat16)
   failing it; in bfloat16 decode and ``Server`` ms a step off and on in
   turns, a traced window of Server steps off and on (device busy time,
   the cache's copies), the packed ``Server`` run through (tokens/s);
   ``decode_kv_int8`` (with ``decode_gqa_packed``): 9b's prompts fed one
   token at a time from position 0 on the int8 cache against the wide
   cache, the logits printed beside a one-ulp witness (not gated), the
   cache's bytes and the peak memory off and on;
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
11. the scenario server: ``workloads.arrival_stream(11, rate=1000,
   n=4096, n_tenants=2)`` (BENCH_serving.json's stream, 48 requests there)
   submitted back to back to ``hts.serve(max_batch=1024, max_queue=4096,
   deadline=60)`` and drained: (a) static, four full batches; (b)
   slice-and-refill (``slice_steps="auto"``); (c) both on ``devices=1``,
   and ``run_many(devices=1)``; (d) ``trip_cost_us(budget=16)`` of a
   1024-lane ``run_many`` beside phase 5's µs a step.  Every result must
   equal ``run_many``'s over the same programs (cycles, stalls, aborts,
   schedule), the first 64 golden's; ``hts_run`` must launch once a
   static batch or a slice (the server's count), K1–K4 never, and nothing
   be built; the phase must take under 120 s.  Scenarios/s beside
   ``run_many``'s, per-bucket occupancy, wait and time to result, the
   slices and their ``"auto"`` budgets, the host ms a slice outside
   ``hts_run`` (harvest and refill) and a traced 11b drain's device busy
   share are printed;
12. the MoE family and paligemma-3b, one model on the card at a time,
   random weights from a seed: (a) K15 at head dim 256 against plain
   (bf16 2e-2, float32 1e-5; bf16 also through each of its two
   instances, one consumer warpgroup and two) at paligemma-3b's two calls
   a layer at B = 2 (the 256-position prefix bidirectional; 1792 text
   queries against 2048 keys, causal from q_offset 256), a causal square
   2048 and ragged lengths; the prefix, text, square and ragged calls
   timed in bf16 through each instance, the one the wrapper takes named
   (device, call and plain ms, bound, SDPA where one call computes the
   same function), with each instance's registers and spills;
   (b) olmoe-1b-7b (16 layers, d_model 2048, 64 experts of 1024, top-8):
   prefill 4 x 2048 and 32 greedy decode steps in bf16 (16 K15 and 33 K16
   launches a prefill, 33 K16 a step; tokens/s, peak memory, the
   prefill's device time split into expert products, other products,
   K15, K16 and the rest), ``aux`` finite, the ``Server`` (32 slots, 64
   requests: ms a step, a traced window's busy share); (c)
   qwen2-moe-a2.7b (24 layers, 60 experts padded to 64, top-4, 4 shared
   experts): ``forward`` on 2 x 1024 in bf16 with ``moe_grouped`` off and
   on (24 K15, 49 K16), no token routed to experts 60-63; (d) paligemma-3b
   (18 layers, MQA, head dim 256): prefill of 2 x (256 prefix embeddings
   + 1792 text tokens), 36 K15 launches, 16 decode steps.  Each model's
   float32 gate: kernels against plain within ``FP32_LOGIT_TOL``
   normwise, every position of the prefill (or forward) and each decode
   step, the MoE routing forced to the plain run's (the routing
   decisions that differ free-running are printed), and a control (K15
   as the plain attention with its scores rounded to bf16) that must
   fail it; olmoe at 1 x 2048, qwen2-moe at 4 of its layers, both with
   their weight matrices drawn at 1/sqrt(input width) (their reading at
   the reference's draw, chaotic in float32, printed beside);
13. phi3-mini-3.8b (32 layers, d_model 3072, 32 heads of 96, d_ff 8192,
   vocab 32064) with random weights from a seed: (a) K15 at head dim 96
   against plain (bf16 2e-2, float32 1e-5) at the prefill shape (128 ×
   2048², causal), a ragged Tk, a chunk at q_offset 1000 and Tq = 5; the
   prefill shape timed in bf16 beside its bound and SDPA, with the
   instance's registers; (b) prefill of 4 x 2048 and 32
   greedy decode steps in bf16 (32 K15 and 65 K16 launches a prefill, 65
   K16 a step; tokens/s, peak memory, the prefill's device time split),
   then the float32 gate (every position of the prefill and each decode
   step, kernels against plain within ``FP32_LOGIT_TOL``, the control
   failing it; plain on the embedding one ulp up printed beside);
14. whisper-base (6 encoder and 6 decoder layers, d_model 512, 8 heads of
   64, d_ff 2048, vocab 51865) with random weights from a seed: (a) K15
   at head dim 64 against plain (bf16 2e-2, float32 1e-5) at its three
   calls at B = 16 (the encoder's 1500 frames unmasked, the cross
   attention's 448 queries on 1500 frames unmasked, the decoder's 448
   causal) and K16 at 16 x 1500 rows of 512, each timed in bf16 beside
   its bound and the library call; (b) ``encode`` of 16 x 1500 frames and
   ``decode_seq`` of 16 x 448 tokens in bf16 (6 K15 and 13 K16 launches,
   then 12 and 19; frames/s, tokens/s, the time split), then the float32
   gate at weights drawn at 1/sqrt(input width) (every position, kernels
   against plain within ``FP32_LOGIT_TOL``, the control failing it; at
   the reference's draw whisper-base is chaotic in float32, and that
   reading is printed beside one-ulp witnesses on the embedding and the
   frames); (c) cross K/V of the 1500 frames, 32 float32
   ``decode_step``s against ``decode_seq``'s logits within
   ``WHISPER_LOGIC_TOL`` at the same width draw (the reference's draw
   printed), then bf16 decode ms a step; (d) the ``Server``, 8 slots, 16 requests of 16 prompt and
   16 new tokens: every request completes, 19 K16 launches a step;
15. training (the kernels' gradients are their plain versions' VJPs
   behind ``kernels.ops._RefVJP``, as the reference's ``_make_ref_bwd``):
   (a) each op's Function on the card (K15 bf16 at 4 x 12 heads of 128
   over 2048, GQA 6 to 1; K16 bf16 at 8192 x 1536; K17 and K18 float32 at
   rwkv6's and zamba2's smoke widths): one launch, the gradients equal
   plain autograd's bit for bit, and the control, the raw kernel
   without the Function, leaves every upstream gradient None; (b)
   Qwen2-1.5B at full width and depth, float32 masters from a seed,
   bf16 compute, remat ``"nothing"``, AdamW: 2 warm-up and 4 timed steps
   on 4 x 2048 tokens, finite losses, 56 K15 and 113 K16 launches a step
   (each layer's again in its recompute); ms a step, tokens/s, peak
   memory, and a traced step's busy share and device time split
   (products, K15, K16, the plain attention backward, AdamW, the
   cross-entropy, the rest); (c) the float32 gate at full depth on 1 x
   2048: the loss within ``TRAIN_LOSS_TOL`` and every leaf's gradient
   within ``TRAIN_GRAD_TOL`` normwise, kernels against plain autograd
   on the plain versions, the control (the kernels without the
   Function: missing gradients read as zeros) past it, beside a
   one-ulp witness (plain on the embedding one ulp up, leaf by leaf;
   not gated); the bf16 readings printed; (d) one train step of olmoe-1b-7b, paligemma-3b,
   rwkv6-3b, zamba2-7b and whisper-base at smoke width in float32, each
   gated at its forward gate's limit (``FP32_LOGIT_TOL``, at that gate's
   draw) with the same control; (e) in subprocesses, the ``TrainLoop``
   at Qwen2's smoke config with a failure injected at step 6 equal to an
   uninterrupted run bit for bit (every loss and the final state, under
   ``torch.use_deterministic_algorithms``), and ``python -m
   repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 8``;
5b. kernel times: device, call, plain and library times of the DSP
   kernels at each path's shape, of K15 and K16 at the prefill's (K15 and
   ``scaled_dot_product_attention`` at zamba2's too, K16 and ``rms_norm``
   at rwkv6's and zamba2's forward rows) and of K17 and K18 at the models'
   forward shapes (each one's device time the sum of its three kernels,
   split; their scratch bytes), K5 and ``conv1d`` also at Table II's 524288
   x 40, K12 and grouped ``conv1d`` also at the image path's call (262144
   x 64, y is x), K7 also with d is x and at 16 taps (``*_k16``: the
   generic instance), beside the bound (with the second
   array x itself, x read once; the bound reading it twice beside it);
   K15's row also carries 12a's head-dim-256 times (``*_d256_prefix``,
   ``*_d256_text``, ``*_d256_square``, ``*_d256_ragged``, each instance's
   as ``ms_<instance>_d256_*``), 13a's head-dim-96 ones
   (``*_d96_prefill``) and 14a's head-dim-64 ones (``*_d64_encoder``,
   ``*_d64_cross``, ``*_d64_decoder``); K16's row 14a's
   (``*_24000x512``).  ``--only
   5b`` times them all on their own (launches are counted only on the
   paths that ran).

The last lines are the card (``nvidia-smi``), one JSON object
``{"kernels": [...]}`` (the eighteen kernels and ``hts_run``), and
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero
without the last line; so does a machine without a card, or a directory
without the rest of the repository.  ``--only PREFIX ...`` runs the
build, the main path's set-up and the phases whose names start with a
prefix (``--only 2c``: ``hts_run`` against the per-phase loop; ``--only
3``: the main path; ``--only 9 "5b transformer"``: the dense model path;
``--only 10``: the ssm and hybrid families; ``--only 11``: the scenario
server; ``--only 12``: the MoE family and paligemma-3b; ``--only 13``:
phi3-mini-3.8b; ``--only 14``: whisper-base; ``--only 15``: training)
and prints no kernels line.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import re
import shutil
import statistics
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
#: K7's tap count past its register instances (4, 8): the generic instance
LMS_GENERIC_K = 16
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
                     (5, 136, 8), (260, 200, 4), (7, 42, 8),
                     (TABLE_FRAMES, TABLE_SAMPLES, LMS_GENERIC_K),
                     (33, 100, LMS_GENERIC_K)],
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
#: path's call (y is x), K7 at Table II's with d is x and at 16 taps (the
#: generic instance; ``*_k16``)
DSP_EXTRA = {"real_fir": [(TABLE_FRAMES, TABLE_SAMPLES, 8, False)],
             "correlation": [(TILES, PIXELS, MAX_LAG, True)],
             "adaptive_fir": [(TABLE_FRAMES, TABLE_SAMPLES, 8, True),
                              (TABLE_FRAMES, TABLE_SAMPLES, LMS_GENERIC_K,
                               False)]}
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

# the scenario server (phase 11): BENCH_serving.json's stream (seed 11,
# Poisson at 1000 requests/s, two tenants a scenario) at 4096 requests,
# served back to back through 1024 lanes (one full wave of hts_run at the
# main spec: 8 CTAs an SM on 132 SMs hold 1056)
SCEN_SEED, SCEN_RATE, SCEN_REQUESTS, SCEN_LANES = 11, 1000.0, 4096, 1024
SCEN_GOLDEN = 64               # the first results held against golden
SCEN_TRIP_BUDGET = 16          # 11d: trip_cost_us's slice
SCEN_PHASE_S = 120.0           # the phase's wall-clock limit (11a-11d)

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
#: bf16 K15's instances (padded head dim, consumer warpgroups), as phase 1
#: finds them in the SASS
K15_BF16 = ((64, 2), (96, 2), (128, 2), (256, 1), (256, 2))
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
FP32_LOGIT_TOL = {"rwkv6-3b": 1e-3, "zamba2-7b": 0.1, "qwen2-1.5b": 1e-2,
                  "olmoe-1b-7b": 1e-4, "qwen2-moe-a2.7b": 1e-4,
                  "paligemma-3b": 1e-2, "phi3-mini-3.8b": 1e-2,
                  "whisper-base": 1e-4}
#: the archs whose float32 gate (12b, 12c, 14b) draws the layers' weight
#: matrices at 1/sqrt(their input width) (``scale_to_width``): at the
#: reference's draw (a stacked leaf's fan-in is its layer count) these
#: models are chaotic in float32 (the plain path on an embedding one ulp
#: up parts from itself about as far as the kernels do; PERF.md §6), so
#: that reading is printed beside the witness, not gated
WIDTH_DRAW_GATES = ("olmoe-1b-7b", "qwen2-moe-a2.7b", "whisper-base")
#: 10b's float32 reading on the kernels before K17 and K18 were chunked
#: (a CTA a (sequence, head), PERF.md §6): printed beside this run's
FP32_LOGIT_BEFORE = {"rwkv6-3b": 2.58e-5, "zamba2-7b": 0.0154}
#: K17/K18 against plain: float32 normwise (largest difference over the
#: largest plain magnitude; the sums run in another order), bfloat16
#: rtol = atol (about one output ulp)
REC_TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# the MoE family and paligemma-3b (phase 12): K15 (head dim 128, and 256 in
# paligemma's prefix-LM attention) and K16 in their paths
MOE_ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
VLM_ARCH = "paligemma-3b"
#: K15 at head dim 256, (BH, Tq, Tk, D, causal, q_offset): paligemma-3b's
#: two calls a layer at B = 2 (8 query heads on 1 KV head, repeated), the
#: prefix (bidirectional) and the text after it (causal from q_offset
#: 256, SDPA's lower-right causal bias); a causal square shape; ragged
#: lengths (no multiple of the 64-key stage) with and without q_offset
ATTN_256_CASES = [(16, 256, 256, 256, False, 0),
                  (16, 1792, 2048, 256, True, 256),
                  (16, 2048, 2048, 256, True, 0),
                  (16, 1000, 1000, 256, True, 0),
                  (16, 100, 1300, 256, False, 0),
                  (16, 300, 1300, 256, True, 1000)]
#: which of them 12a times, by name
ATTN_256_TIMED = {"prefix": 0, "text": 1, "square": 2, "ragged": 5}
#: olmoe-1b-7b: prefill 4 x 2048 into a 2080-position cache, 32 greedy
#: decode steps; the float32 gate at 1 x 2048 (its float32 weights alone
#: are 27.6 GB), 8 decode steps
MOE_PREFILL_B, MOE_PREFILL_T, MOE_MAX_LEN, MOE_DECODE_STEPS = 4, 2048, 2080, 32
MOE_GATE_B, MOE_GATE_STEPS = 1, 8
#: qwen2-moe-a2.7b: forward on 2 x 1024 with moe_grouped off and on; the
#: float32 gate at 4 of its 24 layers (float32 at full depth would be
#: ~60 GB of weights)
QMOE_B, QMOE_T, QMOE_GATE_LAYERS = 2, 1024, 4
#: paligemma-3b: prefill of 2 x (256 prefix embeddings + 1792 text tokens)
#: into a 2064-position cache, then 16 decode steps; the float32 gate the
#: same
VLM_B, VLM_TEXT, VLM_MAX_LEN, VLM_DECODE_STEPS = 2, 1792, 2064, 16

# phi3-mini-3.8b (phase 13): K15 at head dim 96 and K16 in its path
PHI3_ARCH = "phi3-mini-3.8b"
#: K15 at head dim 96, (BH, Tq, Tk, D, causal, q_offset): phi3's prefill at
#: B = 4 (32 heads of 96, no GQA), a ragged Tk (no multiple of the
#: 128-key stage), a chunk of 300 queries after 1000 cached positions, a
#: chunk of five (Tq < 8)
ATTN_96_CASES = [(128, 2048, 2048, 96, True, 0),
                 (32, 1000, 1300, 96, False, 0),
                 (32, 300, 1300, 96, True, 1000),
                 (32, 5, 777, 96, True, 772)]
#: phi3's prefill of 4 x 2048 into a 2080-position cache, then 32 greedy
#: decode steps; the float32 gate the same, the bf16 weights freed first
PHI3_B, PHI3_T, PHI3_MAX_LEN, PHI3_DECODE_STEPS = 4, 2048, 2080, 32

# the decode flags on Qwen2-1.5B (phase 9d) and the float32 Server against
# greedy decoding at B = 1 (9c)
#: the requests of phase 9's Server held against float32 greedy_decode at
#: B = 1 (9c; STAGGERED among them)
STAGGERED_F32 = (0, 21, STAGGERED, 63)
#: the int8 cache's rollout: phase 9's 4 prompts, their first 64 tokens
#: fed one at a time from position 0 into a cache of PREFILL_MAX_LEN
INT8_T = 64

# whisper-base (phase 14): K15 at head dim 64 (the encoder's and the cross
# attention unmasked, the decoder's causal, Tq != Tk) and K16 at width 512
WHISPER_ARCH = "whisper-base"
#: 16 clips of Whisper's 30-s window (1500 encoder frames) and 448 decoder
#: tokens (its text context); 32 greedy decode steps
WHISPER_B, WHISPER_TE, WHISPER_TD, WHISPER_DECODE_STEPS = 16, 1500, 448, 32
#: K15 at whisper-base's three calls at B = 16 (8 heads of 64), (BH, Tq,
#: Tk, D, causal, q_offset), by name
ATTN_64_CASES = {"encoder": (128, 1500, 1500, 64, False, 0),
                 "cross": (128, 448, 1500, 64, False, 0),
                 "decoder": (128, 448, 448, 64, True, 0)}
#: K16 at the encoder's rows (16 x 1500) of width 512
RMS_512 = (WHISPER_B * WHISPER_TE, 512)
#: float32 decode steps against decode_seq's logits at the same positions
#: (14c), normwise
WHISPER_LOGIC_TOL = 1e-3
#: the Server: 8 slots of 64 positions, 16 requests of 16 prompt tokens
#: (equal lengths: this family decodes at one position) and 16 new tokens
WHISPER_SLOTS, WHISPER_MAX_LEN, WHISPER_REQUESTS = 8, 64, 16
WHISPER_PROMPT, WHISPER_NEW = 16, 16

# training (phase 15): Qwen2-1.5B's train step at full width and depth
#: the train step's tokens (phase 9b's prefill shape), its warm-up and timed
#: steps; the float32 gate's batch
TRAIN_B, TRAIN_T, TRAIN_WARM, TRAIN_STEPS = 4, 2048, 2, 4
TRAIN_F32_B = 1
#: the float32 gate (15c): the loss relative, each leaf's gradient
#: normwise (largest difference over the largest plain magnitude)
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-2
#: 15d: one train step of each other family's smoke model, on 2 x
#: TRAIN_SMOKE_T tokens (whisper-base on TRAIN_FRAMES frames), gated at
#: the model's FP32_LOGIT_TOL; 15a's K17 and K18 at FN_SMOKE_T steps
TRAIN_FAMILIES = ("olmoe-1b-7b", "paligemma-3b", "rwkv6-3b", "zamba2-7b",
                  "whisper-base")
TRAIN_SMOKE_T = TRAIN_FRAMES = FN_SMOKE_T = 64
#: 15e: the TrainLoop at Qwen2's smoke config, uninterrupted and with a
#: failure injected, as the reference's test_fault_tolerance.py runs it
RESUME_STEPS, RESUME_FAIL_AT, RESUME_CKPT_EVERY = 12, 6, 4


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
    schedule's ``ProfilerStep*`` range, and each ``record_function``
    range (the train step's), also land on the device timeline; they
    span device work, not do it, and are left out."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA
            and not e.name.startswith("ProfilerStep")
            and not getattr(e, "is_user_annotation", False)]


class StepFailed(Exception):
    """A step run under the profiler failed by itself: not a profiler's
    failure (a ``RuntimeError``), which a phase may report as "not
    measured"."""


def trace_window(torch, warm, run, on_trace=None):
    """Device activities of ``run()`` and its host wall (µs), traced as the
    active step of a profiler schedule after ``warm()`` ran as its
    discarded warm-up step: a trace drops device activities at the start
    of its window (seen: a schedule's first task missing), so the window
    that counts starts with the tracer already running.  ``on_trace``, if
    given, is also handed the profiler when the trace is ready."""
    from torch.profiler import ProfilerActivity, profile, schedule
    out: dict = {}

    def ready(p):
        out.update(events=device_events(p))
        if on_trace is not None:
            on_trace(p)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
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


def time_split(torch, warm, run) -> dict:
    """Where a model call's time goes, in ms: the host wall of ``run()``
    traced after ``warm()`` (``trace_window``'s schedule), the device busy
    time, and that split into the expert products (``aten::bmm``: the MoE
    layer's batched products; a prefill or forward has no other), the
    other matrix products (``aten::mm``, ``aten::addmm``: projections,
    router, shared expert, unembedding), K15, K16 and the rest
    (elementwise passes, the dispatch's copies and scans, the top-k
    sort); with the device activities (``events``)."""
    out: dict = {}
    events, wall_us = trace_window(
        torch, warm, run, on_trace=lambda p: out.update(ops=p.key_averages()))

    def op_ms(names):
        return sum(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
                   for e in out["ops"] if e.key in names) / 1e3

    def kernel_ms(part):
        return sum(us for k, us in events if part in k) / 1e3

    split = dict(wall=wall_us / 1e3, events=events,
                 busy=sum(us for _k, us in events) / 1e3,
                 expert_products=op_ms({"aten::bmm"}),
                 other_products=op_ms({"aten::mm", "aten::addmm"}),
                 k15=kernel_ms("flash_attention"), k16=kernel_ms("rmsnorm"))
    split["rest"] = split["busy"] - sum(
        split[k] for k in ("expert_products", "other_products", "k15",
                           "k16"))
    return split


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
    """Registers, stack frame and spill bytes of each kernel whose mangled
    name matches ``pattern`` (a group a template argument) in a ``-Xptxas
    -v`` report, as ``{"label<args>": {"registers", "stack_frame",
    "spill_stores", "spill_loads"}}``."""
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
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            facts.setdefault(name, {}).update(stack_frame=int(m.group(1)),
                                              spill_stores=int(m.group(2)),
                                              spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            facts.setdefault(name, {})["registers"] = int(m.group(1))
    return facts


def sass_counts(lib_path, opcode: str, patterns: dict) -> dict:
    """How many ``opcode`` instructions ``cuobjdump -sass`` shows in each
    function of a built library whose mangled name matches a pattern (a
    group a template argument), as ``{"label<args>": count}``."""
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
                    name = f"{label}<{', '.join(t.groups())}>"
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


@contextlib.contextmanager
def record_routing(transformer):
    """While open, the MoE layer's top-k (``transformer.top_k``, once a
    layer a call) records each call's expert indices in the list it
    yields."""
    calls = []
    saved = transformer.top_k

    def record(probs, k):
        out = saved(probs, k)
        calls.append(out[1])
        return out

    transformer.top_k = record
    try:
        yield calls
    finally:
        transformer.top_k = saved


@contextlib.contextmanager
def force_routing(transformer, routes):
    """While open, the MoE layer's top-k takes the expert indices of
    ``routes`` (a ``record_routing`` list: one array a call, in call
    order) in place of its own, with its own probabilities at them; it
    adds to the list it yields how many of its own decisions (a token's
    top-k) differed, a tensor a call."""
    it = iter(routes)
    flips = []
    saved = transformer.top_k

    def forced(probs, k):
        own = saved(probs, k)[1]
        want = next(it).reshape(own.shape)
        flips.append((own != want).any(-1).sum())
        return probs.gather(-1, want), want

    transformer.top_k = forced
    try:
        yield flips
    finally:
        transformer.top_k = saved


def scale_to_width(layer_params, n_layers):
    """Every weight matrix of ``layer_params`` (a model's per-layer list)
    scaled in place by sqrt(n_layers / its input width): the reference's
    draw of a stacked leaf, N(0, 1/n_layers), becomes N(0, 1/input
    width)."""
    def walk(tree):
        for v in tree.values():
            if isinstance(v, dict):
                walk(v)
            elif v.dim() >= 2:
                v.mul_(math.sqrt(n_layers / v.shape[-2]))
    for lp in layer_params:
        walk(lp)


def routing_diff(got, want) -> tuple[int, int]:
    """Routing decisions (a token's top-k in a layer) that differ between
    two runs' ``record_routing`` lists, and the decisions compared."""
    assert len(got) == len(want), (len(got), len(want))
    diff = sum(int((a.reshape(b.shape) != b).any(-1).sum())
               for a, b in zip(got, want))
    return diff, sum(a[..., 0].numel() for a in want)


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


def train_resume(directory: str) -> int:
    """Phase 15e's subprocess (``--train-resume DIR``): the ``TrainLoop``
    on the card at Qwen2's smoke config under
    ``torch.use_deterministic_algorithms(True)``, RESUME_STEPS steps
    uninterrupted and again with a ``RuntimeError`` injected once at step
    RESUME_FAIL_AT (a checkpoint every RESUME_CKPT_EVERY steps); every
    loss and the final state must be equal bit for bit.  Prints one JSON
    line; exit 0 if they are."""
    import torch
    from repro_torch.data import pipeline as data_lib
    from repro_torch.models import layers, registry
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import train as train_rt
    torch.use_deterministic_algorithms(True)
    model = registry.build(registry.get_config(ARCH).smoke(), device=DEVICE)
    source = data_lib.make_source(data_lib.DataConfig(
        vocab=model.cfg.vocab, seq_len=64, global_batch=4, seed=7))
    tcfg = train_rt.TrainConfig(optimizer=AdamWConfig(lr=1e-3),
                                warmup_steps=2, total_steps=RESUME_STEPS,
                                ckpt_every=RESUME_CKPT_EVERY, max_restarts=2)
    fired = []

    def injector(step):
        if step == RESUME_FAIL_AT and not fired:
            fired.append(step)
            raise RuntimeError("injected node failure")
    runs = {}
    for name, inj in (("uninterrupted", None), ("failed", injector)):
        loop = train_rt.TrainLoop(
            model, source, train_rt.make_train_step(model, tcfg), tcfg,
            str(Path(directory) / name),
            lambda: train_rt.init_state(model, MODEL_SEED), inj)
        state = loop.run(RESUME_STEPS)
        losses = {h["step"]: h["loss"] for h in loop.history}
        runs[name] = (loop.restarts, [losses[i] for i in range(RESUME_STEPS)],
                      layers.tree_leaves(state))
    (_, la, sa), (restarts, lb, sb) = runs["uninterrupted"], runs["failed"]
    same_losses = la == lb
    same_state = all(torch.equal(x, y) for x, y in zip(sa, sb))
    print(json.dumps({"resume": {
        "device": torch.cuda.get_device_name(0), "restarts": restarts,
        "steps": RESUME_STEPS, "failed_at": RESUME_FAIL_AT,
        "losses_equal": same_losses, "state_equal": same_state,
        "leaves": len(sa), "first_loss": la[0], "last_loss": la[-1]}}))
    return 0 if (same_losses and same_state and restarts == 1) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--train-resume" in argv:
        return train_resume(argv[argv.index("--train-resume") + 1])
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
        from repro_torch.core import hts
        from repro_torch.core.hts import (HtsParams, api, batch, costs,
                                          cuda_run, cuda_step, machine,
                                          programs, workloads)
        from repro_torch.examples import dsp_pipeline
        from repro_torch.kernels import common as dsp
        from repro_torch.kernels import (attention, dsp_fir, dsp_spectral,
                                         dsp_vector, mamba2, ops, ref,
                                         rmsnorm, rwkv6)
        from repro_torch.core.sched import serving, specdecode
        from repro_torch.models import layers, registry, transformer, whisper
        from repro_torch.runtime import flags
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
                ("flash_attention", tf,
                 r"flash_attention_wgmmaILi(\d+)ELi(\d+)E",
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
                ("adaptive_fir", dsp.LIB, r"adaptive_fir_flatILi(\d+)E",
                 "adaptive_fir_flat"),
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
            r"flash_attention_wgmmaILi(\d+)ELi(\d+)E": "flash_attention_wgmma",
            r"flash_attention_kernelILi(\d+)E": "flash_attention_kernel"})
        facts["flash_attention"]["hgmma"] = hgmma
        log(f"HGMMA instructions in the SASS of K15: {hgmma}")
        bf16 = {k: n for k, n in hgmma.items() if "wgmma" in k}
        fp32 = {k: n for k, n in hgmma.items() if "wgmma" not in k}
        assert sorted(bf16) == sorted(
            f"flash_attention_wgmma<{dp}, {nwg}>" for dp, nwg in K15_BF16) \
            and all(bf16.values()), \
            f"bf16 K15 without tensor-core instructions: {bf16}"
        assert len(fp32) == 6 and not any(fp32.values()), fp32
        # ptxas says where it serialises wgmma (a pipeline it cannot keep
        # asynchronous): the K15 instances should have no such line
        if tf.info:
            serial = [ln.strip() for ln in tf.info["ptxas"].splitlines()
                      if "wgmma" in ln and "serialized" in ln]
            facts["flash_attention"]["wgmma_serialized"] = serial
            log(f"ptxas lines on serialised wgmma in transformer.cu: "
                f"{serial or 'none'}")
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

    def tf_check(name, shape, dt, seed, instance=None):
        """One K15 or K16 call against its plain version (K15 through the
        bf16 ``instance`` named, if any)."""
        args = tf_case(torch, name, shape, getattr(torch, dt), seed)
        if name == "flash_attention":
            q, k, v, causal, q_offset = args
            got = attention.flash_attention(q, k, v, causal=causal,
                                            q_offset=q_offset,
                                            instance=instance)
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
        via = "" if instance is None else f" ({instance})"
        log(f"{name:15s} {str(shape):34s} {dt:8s} max abs err "
            f"{err:.3g} (rtol = atol = {tol}){via}")

    def k15_instances(q, k, v, kw, names):
        """Device ms a launch (profiler) and ms a call (events) of bf16
        K15 through each instance of ``names`` on one input."""
        out = {}
        for inst in names:
            calls = [functools.partial(attention.flash_attention, q, k, v,
                                       instance=inst, **kw)] * 23
            out[inst] = (profiled_ms(torch, calls, TF_KERNEL[
                "flash_attention"]), events_ms(torch, calls))
        return out

    def k15_regs(dp, nwg):
        """ptxas's registers, stack frame and spills of bf16 K15's (dp,
        nwg) instance, from phase 1 (empty on a cached build)."""
        return facts.get("flash_attention", {}).get("ptxas", {}).get(
            f"flash_attention_wgmma<{dp}, {nwg}>", {})

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

    def drive(model, params, tok, feeds, on=False, prefix=None,
              max_len=PREFILL_MAX_LEN, steps=DECODE_STEPS, full=False,
              **swap):
        """``prefill`` of ``tok`` (after ``prefix``, the vlm's embeddings,
        when given), then ``steps`` ``decode_step``s, on the path ``on``
        and ``swap`` select (``plain_path``'s arguments; off: the
        kernels).  Greedy when ``feeds`` is empty (it is filled with the
        tokens fed), else fed ``feeds`` (teacher-forced).  Returns the
        last-position prefill logits (``full``: every position's, as
        ``seq``), each step's logits, the launches, walls and peak memory
        of both, and the MoE layers' routing (``record_routing``)."""
        with plain_path(on, ref, **kernels, **swap), \
                record_routing(transformer) as routes:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            tlib.reset_launches()
            t0 = time.perf_counter()
            logits, cache = model.prefill(params, tok, max_len, prefix)
            last = logits[:, -1].float()
            seq = logits.float() if full else None
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(tlib.launches)
            peak = torch.cuda.max_memory_allocated()
            pos0 = logits.shape[1]
            del logits
            greedy = not feeds
            if greedy:
                feeds.append(last.argmax(-1))
            outs = []
            tlib.reset_launches()
            torch.cuda.synchronize()
            d0 = time.perf_counter()
            for i in range(steps):
                lg, cache = model.decode_step(
                    params, cache, feeds[i][:, None].to(torch.int32),
                    pos0 + i)
                outs.append(lg[:, -1].float())
                if greedy:
                    feeds.append(outs[-1].argmax(-1))
            torch.cuda.synchronize()
            dwall = time.perf_counter() - d0
            dcounts = dict(tlib.launches)
            del cache
        assert bool(torch.isfinite(last).all()) and all(
            bool(torch.isfinite(x).all()) for x in outs), "not finite"
        return dict(last=last, seq=seq, steps=outs, counts=counts,
                    dcounts=dcounts, wall=wall, dwall=dwall, peak=peak,
                    routes=routes)

    def logit_errors(what, got, want, limit=None):
        """Normwise errors of the prefill logits (the last position's, or
        every position's where both runs kept them) and of each decode
        step's, with argmax agreement, printed; the largest."""
        key = "seq" if got["seq"] is not None and want["seq"] is not None \
            else "last"
        err = normwise(got[key], want[key])
        errs = [normwise(a, b) for a, b in zip(got["steps"], want["steps"])]
        agree = np.mean([float((a.argmax(-1) == b.argmax(-1)).float().mean())
                         for a, b in zip([got[key]] + got["steps"],
                                         [want[key]] + want["steps"])])
        gate = "not gated" if limit is None else f"limit {limit}"
        where = "every position" if key == "seq" else "the last position"
        log(f"{what}: normwise, prefill ({where}) {err:.3g}, "
            f"{len(errs)} decode steps (teacher-forced) max "
            f"{max(errs, default=0.0):.3g} mean "
            f"{np.mean(errs) if errs else 0.0:.3g} ({gate}); argmax "
            f"agreement {agree:.3f}")
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

    def serve_requests(vocab=None):
        rng = np.random.default_rng(SERVE_SEED)
        vocab = vocab or ctx["model"].cfg.vocab
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
            ctx[f"server_{policy}_rate"] = st.slot_busy_steps / wall
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

    def staggered_fp32():
        """The Server's requests against greedy decoding at B = 1 in
        float32 (ROADMAP Queue 3): the float32 ``Server`` (ooo) over phase
        9's requests, then each of STAGGERED_F32 through float32
        ``greedy_decode`` at B = 1; every token must agree.  Beside it,
        how many of each one's tokens 9c's bfloat16 Server gave too (not
        gated)."""
        model = ctx["model"]
        reqs = serve_requests()
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            p32 = model.init(MODEL_SEED)
            srv = serving.Server(model, p32, n_slots=SERVE_SLOTS,
                                 max_len=SERVE_MAX_LEN)
            objs = [serving.Request(i, list(p_), m)
                    for i, (p_, m) in enumerate(reqs)]
            for r in objs:
                srv.submit(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            want = {i: specdecode.greedy_decode(
                model, p32, np.asarray([objs[i].prompt]), len(objs[i].out),
                SERVE_MAX_LEN)[0].tolist() for i in STAGGERED_F32}
            del p32, srv
        finally:
            layers.COMPUTE_DTYPE = saved
        assert st.completed == SERVE_REQUESTS, st.completed
        log(f"float32 Server ooo: {st.steps} steps, "
            f"{st.slot_busy_steps / wall:.1f} tokens/s, "
            f"{wall / st.steps * 1e3:.2f} ms a step  on {card}")
        bf16 = ctx.get("server_ooo")
        flips = 0
        for i, w in want.items():
            r = objs[i]
            first = next((j for j, (a, b) in enumerate(zip(r.out, w))
                          if a != b), len(w))
            flips += sum(a != b for a, b in zip(r.out, w))
            note = "" if bf16 is None else (
                f"; 9c's bf16 Server agrees with it on "
                f"{sum(a == b for a, b in zip(r.out, bf16[i].out))}")
            log(f"request {i} (prompt {len(r.prompt)}, {len(r.out)} new "
                f"tokens): float32 Server against float32 greedy_decode at "
                f"B=1: the first {first} tokens agree, "
                f"{sum(a == b for a, b in zip(r.out, w))} of {len(w)}{note}")
        assert flips == 0, (f"{flips} tokens of the float32 Server differ "
                            "from float32 greedy decoding at B=1")
        log(f"float32: every token of requests {list(STAGGERED_F32)} "
            "agrees with greedy decoding at B=1")

    def packed_gate():
        """9d, ``decode_gqa_packed`` in float32: prefill and phase 9's 32
        decode steps with the flag off and on, teacher-forced on the same
        tokens; each step's logits flag on within FP32_LOGIT_TOL of flag
        off, and a control (the packed path with its scores rounded to
        bfloat16) that must fail it."""
        model = ctx["model"]
        tok = prompt_tokens(model)
        tol = FP32_LOGIT_TOL[ARCH]
        saved = (layers.COMPUTE_DTYPE, layers.grouped_scores)
        layers.COMPUTE_DTYPE = torch.float32
        try:
            p32 = model.init(MODEL_SEED)
            feeds: list = []
            off = drive(model, p32, tok, feeds)
            with flags.use_flags(decode_gqa_packed=True):
                on = drive(model, p32, tok, feeds)
                layers.grouped_scores = lambda qg, k: saved[1](qg, k).to(
                    torch.bfloat16).float()
                ctl = drive(model, p32, tok, feeds)
            del p32
        finally:
            layers.COMPUTE_DTYPE, layers.grouped_scores = saved
        log(f"float32 decode {off['dwall'] / DECODE_STEPS * 1e3:.2f} ms a "
            f"step unpacked, {on['dwall'] / DECODE_STEPS * 1e3:.2f} packed  "
            f"on {card}")
        err = logit_errors("fp32 logits, decode_gqa_packed vs unpacked", on,
                           off, tol)
        c_err = logit_errors("fp32 logits, control (packed, scores rounded "
                             "to bf16) vs unpacked", ctl, off, tol)
        assert err <= tol, f"packed decode differs ({err:.3g} > {tol})"
        if c_err <= tol:
            raise AssertionError(f"the control passes the packed gate at "
                                 f"{tol} ({c_err:.3g})")
        log(f"the control fails the packed gate, as it must ({c_err:.3g} > "
            f"{tol})")

    def copy_time(events):
        """Device µs of the copies among traced activities: the casts and
        repeats of the cache (``copy`` kernels, ``index``/``repeat``
        kernels of ``repeat_interleave``) and memcpys."""
        return sum(us for key, us in events
                   if any(w in key.lower() for w in ("copy", "index",
                                                     "repeat", "memcpy")))

    def packed_speed():
        """9d, ``decode_gqa_packed`` in bfloat16, each reading taken in
        turns (off, on, on, off) in this call: prefill and 32 greedy
        decode steps (ms a step); Server steps 49-80 of two ``Server``s
        (ooo) on 9c's requests, one a setting, 16 steps a turn (ms a step:
        the steps' occupancy depends on the requests' lengths alone, so it
        is the same in both); a traced window of each (device busy time,
        the cache's copies); then the packed ``Server`` run to completion
        (tokens/s beside 9c's, the tokens it shares with 9c's)."""
        model, params = ctx["model"], ctx["params"]
        tok = prompt_tokens(model)
        Lr = model.cfg.n_layers
        dec: dict = {False: [], True: []}
        runs = {}
        for packed in (False, True, True, False):
            with flags.use_flags(decode_gqa_packed=packed):
                r = drive(model, params, tok, [])
            assert r["dcounts"] == {**zero, "rmsnorm": DECODE_STEPS
                                    * (2 * Lr + 1)}, r["dcounts"]
            dec[packed].append(r["dwall"] / DECODE_STEPS * 1e3)
            runs[packed] = r
        log(f"bf16 decode at B={PREFILL_B}, in turns (off, on, on, off): "
            f"unpacked {dec[False]} ms a step, packed {dec[True]}  on {card}")
        logit_errors("bf16 greedy decode, packed vs unpacked (each its own "
                     "tokens)", runs[True], runs[False])
        reqs = serve_requests()
        servers = {}
        for packed in (False, True):
            with flags.use_flags(decode_gqa_packed=packed):
                srv = serving.Server(model, params, n_slots=SERVE_SLOTS,
                                     max_len=SERVE_MAX_LEN)
                for i, (p_, m) in enumerate(reqs):
                    srv.submit(serving.Request(i, list(p_), m))
                for _ in range(48):
                    srv.step()
            servers[packed] = srv
        step_ms: dict = {False: [], True: []}
        for packed in (False, True, True, False):
            srv = servers[packed]
            with flags.use_flags(decode_gqa_packed=packed):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(16):
                    srv.step()
                torch.cuda.synchronize()
            step_ms[packed].append((time.perf_counter() - t0) / 16 * 1e3)
        log(f"Server steps 49-80 in turns (off, on, on, off), ms a step: "
            f"unpacked {step_ms[False]}, packed {step_ms[True]}  on {card}")
        for packed, srv in servers.items():
            with flags.use_flags(decode_gqa_packed=packed):
                def steps(n):
                    for _ in range(n):
                        srv.step()
                try:
                    events, wall_us = trace_window(
                        torch, lambda: steps(1), lambda: steps(TRACE_STEPS))
                except (RuntimeError, AssertionError, AttributeError) as e:
                    log(f"packed={packed}: step profile not measured ({e})")
                    continue
            busy = sum(us for _k, us in events)
            log(f"Server steps 82-{81 + TRACE_STEPS}, decode_gqa_packed="
                f"{packed}, traced: {wall_us / TRACE_STEPS / 1e3:.3f} ms wall "
                f"a step, device busy {busy / TRACE_STEPS / 1e3:.3f} ms a "
                f"step ({100 * busy / wall_us:.1f} %), the cache's copies "
                f"{copy_time(events) / TRACE_STEPS / 1e3:.3f} ms a step, "
                f"{len(events) / TRACE_STEPS:.0f} device activities a step"
                f"  on {card}")
            for key, us, cnt in costliest(events, TRACE_STEPS, 6):
                log(f"    {us:9.1f} us/step  x{cnt:<4d} {key}")
        del servers
        with flags.use_flags(decode_gqa_packed=True):
            srv = serving.Server(model, params, n_slots=SERVE_SLOTS,
                                 max_len=SERVE_MAX_LEN)
            objs = [serving.Request(i, list(p_), m)
                    for i, (p_, m) in enumerate(reqs)]
            for r in objs:
                srv.submit(r)
            torch.cuda.synchronize()
            tlib.reset_launches()
            t0 = time.perf_counter()
            st = srv.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        counts = dict(tlib.launches)
        tf_launches["server/ooo packed"] = counts
        assert st.completed == SERVE_REQUESTS and counts == {
            **zero, "rmsnorm": st.steps * (2 * Lr + 1)}, (st, counts)
        base = ctx.get("server_ooo")
        agree = ("" if base is None else
                 f", {sum(a == b for x, y in zip(objs, base) for a, b in zip(x.out, y.out))}"
                 f" of {sum(len(y.out) for y in base)} tokens as 9c's "
                 "unpacked Server's (bf16: not gated)")
        log(f"Server ooo, decode_gqa_packed: {st.steps} steps, "
            f"{st.slot_busy_steps / wall:.1f} tokens/s, "
            f"{wall / st.steps * 1e3:.2f} ms a step (9c unpacked: "
            f"{ctx.get('server_ooo_rate', float('nan')):.1f} tokens/s){agree}"
            f"  on {card}")

    def int8_decode():
        """9d, ``decode_kv_int8`` with ``decode_gqa_packed`` in bfloat16:
        phase 9's prompts fed token by token from position 0 (one
        position for every lane: the int8 cache takes no per-lane
        positions, so the ``Server`` cannot run it, as in the reference)
        into a cache of PREFILL_MAX_LEN, against the same rollout on the
        wide cache: each step's logits normwise and the argmax agreement,
        printed beside the witness (the wide rollout on the embedding one
        bf16 ulp up against the wide one); the cache's bytes, the
        rollout's peak memory and ms a step, off and on."""
        model, params = ctx["model"], ctx["params"]
        tok = prompt_tokens(model)[:, :INT8_T]

        def rollout(int8, p):
            with flags.use_flags(decode_kv_int8=int8, decode_gqa_packed=int8):
                cache = model.init_cache(PREFILL_B, PREFILL_MAX_LEN)
                nbytes = sum(t.numel() * t.element_size()
                             for t in cache.values())
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                outs = [model.decode_step(p, cache, tok[:, t:t + 1], t)[0][
                    :, -1].float() for t in range(INT8_T)]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            assert ("k_s" in cache) == int8
            assert all(bool(torch.isfinite(o).all()) for o in outs)
            return dict(steps=outs, bytes=nbytes, wall=wall,
                        peak=torch.cuda.max_memory_allocated())

        wide, q8 = rollout(False, params), rollout(True, params)
        emb = params["embed"]
        params["embed"] = torch.nextafter(emb, emb.new_tensor(math.inf))
        try:
            wit = rollout(False, params)
        finally:
            params["embed"] = emb
        for name, r in (("wide (bf16)", wide), ("int8", q8)):
            log(f"cache {name}: {r['bytes'] / 1e6:.3f} MB for B="
                f"{PREFILL_B} x {PREFILL_MAX_LEN} positions; rollout of "
                f"{INT8_T} steps {r['wall'] / INT8_T * 1e3:.2f} ms a step, "
                f"peak device memory {r['peak'] / 1e9:.3f} GB  on {card}")

        def read(r):
            errs = [normwise(a, b) for a, b in zip(r["steps"], wide["steps"])]
            agree = np.mean([float((a.argmax(-1) == b.argmax(-1)).float()
                                   .mean()) for a, b in zip(r["steps"],
                                                            wide["steps"])])
            return max(errs), float(np.mean(errs)), agree
        for what, r in (("int8 cache vs wide cache", q8),
                        ("witness: wide cache, embedding one ulp up, vs "
                         "wide cache", wit)):
            mx, mean, agree = read(r)
            log(f"bf16 rollout logits, {what}: normwise max {mx:.3g} mean "
                f"{mean:.3g} over {INT8_T} steps, argmax agreement "
                f"{agree:.3f} (not gated)")
        assert q8["bytes"] < wide["bytes"]

    for name, fn in (("9a K15 and K16 vs plain", tf_vs_plain),
                     ("9 model setup", model_setup)):
        phase(name, fn)
    if "model" in ctx:
        phase("9b prefill at full width", prefill_path)
        phase("9b float32 logits gate", fp32_logit_gate)
        phase("9b per-layer bf16 attention gate", attention_layer_gate)
        phase("9c the Server at full width", server_path)
        phase("9c float32 Server against greedy decoding at B=1",
              staggered_fp32)
        phase("9d decode_gqa_packed float32 gate", packed_gate)
        phase("9d decode_gqa_packed in bf16, the Server", packed_speed)
        phase("9d decode_kv_int8 rollout", int8_decode)
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

    # 11. the scenario server ---------------------------------------------
    def scenario_server():
        t_phase = time.perf_counter()
        t0 = time.perf_counter()
        stream = workloads.arrival_stream(SCEN_SEED, rate=SCEN_RATE,
                                          n=SCEN_REQUESTS, n_tenants=2)
        progs = [a.scenario.merged for a in stream]
        log(f"{SCEN_REQUESTS} requests of arrival_stream({SCEN_SEED}, rate="
            f"{SCEN_RATE}) generated in {time.perf_counter() - t0:.1f} s "
            f"(the last arrives at {stream[-1].t:.3f} s; replayed back to "
            "back)")
        api.run_many(progs[:SCEN_LANES], device=DEVICE, check=False)  # warm
        torch.cuda.synchronize()
        cuda_run.reset_launches()
        t0 = time.perf_counter()
        want = api.run_many(progs, device=DEVICE, check=False)
        wall_ref = time.perf_counter() - t0
        assert want.all_halted and cuda_run.launches["run"] == 1, \
            cuda_run.launches
        want_rows = [(int(want.cycles[i]), int(want.raw["stall_cycles"][i]),
                 int(want.raw["spec_aborted"][i]), want[i].schedule_tuple())
                for i in range(SCEN_REQUESTS)]
        builds0 = hts.serve(device=DEVICE).cache_info().builds

        def served(label, **kw):
            """Serve the stream back to back and drain; every result held
            to run_many's, the hts_run launches to the server's count."""
            cuda_run.reset_launches()
            cuda_step.reset_launches()
            srv = hts.serve(max_batch=SCEN_LANES, max_queue=SCEN_REQUESTS,
                            deadline=60.0, device=DEVICE, **kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            futs = [srv.submit(p) for p in progs]
            srv.drain()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = [f.result(timeout=0) for f in futs]
            bad = [i for i, r in enumerate(got)
                   if (r.cycles, r.stall_cycles, r.spec_aborted,
                       r.schedule_tuple()) != want_rows[i]]
            assert not bad, f"{label}: requests {bad[:10]} differ from " \
                "run_many"
            rep = srv.report()
            info = srv.cache_info()
            (key, b), = rep.per_bucket.items()
            launches = b.slices if kw.get("slice_steps") else b.batches
            assert info.launches == launches * (kw.get("devices") or 1), \
                f"{label}: hts_run {info.launches}, server {launches}"
            assert not any(cuda_step.launches.values()), cuda_step.launches
            assert info.builds == builds0, f"{label}: built {info}"
            run_paths[f"serve {label}"] = info.launches
            log(f"{label}: {SCEN_REQUESTS} requests in {wall:.4f} s, "
                f"{SCEN_REQUESTS / wall:.1f} scenarios/s (run_many "
                f"{SCEN_REQUESTS / wall_ref:.1f}); bucket {key}: "
                f"{b.batches} batches, occupancy {b.occupancy:.3f}, mean "
                f"wait {b.mean_wait * 1e3:.3f} ms, time to result "
                f"{b.mean_ttr * 1e3:.3f} ms; hts_run {info.launches} "
                f"launches, K1-K4 0, builds {info.builds} (unchanged)  on "
                f"{card}")
            if b.slices:
                log(f"{label}: {b.slices} slices, budgets {list(b.budgets)}"
                    f"; host ms a slice: {b.launch_ms:.3f} from launch to "
                    f"the dead mask read back, {b.host_ms:.3f} outside "
                    "hts_run (harvest and refill, the refills' packing "
                    f"included)  on {card}")
            return got, wall

        static, wall_a = served("static (11a)")
        sliced, wall_b = served("slice-and-refill (11b)",
                                slice_steps="auto")
        for i in range(SCEN_GOLDEN):
            g = api.run(progs[i], backend="golden")
            assert (g.cycles, g.schedule_tuple()) == \
                (static[i].cycles, static[i].schedule_tuple()), \
                f"request {i} differs from golden"
        log(f"the first {SCEN_GOLDEN} requests equal golden (cycles and "
            "schedule)")
        served("static on devices=1 (11c)", devices=1)
        served("slice-and-refill on devices=1 (11c)", devices=1,
               slice_steps="auto")
        cuda_run.reset_launches()
        one = api.run_many(progs, devices=1, device=DEVICE, check=False)
        assert cuda_run.launches["run"] == 1 and \
            np.array_equal(one.cycles, want.cycles) and all(
                one[i].schedule_tuple() == want_rows[i][3]
                for i in range(SCEN_REQUESTS)), "run_many(devices=1)"
        log("11c: both servers on devices=1 and run_many(devices=1) equal "
            "run_many")
        width = api.run_many(progs[:SCEN_LANES], device=DEVICE)
        trip = width.trip_cost_us(budget=SCEN_TRIP_BUDGET)
        # a longer slice spreads the launch's host work over more steps
        long_trip = width.trip_cost_us(budget=16 * SCEN_TRIP_BUDGET)
        hr = next((r for r in rows if r["name"] == "hts_run"), {})
        p5 = hr.get("ms_per_step")
        log(f"11d: trip_cost_us(budget={SCEN_TRIP_BUDGET}) of a "
            f"{SCEN_LANES}-lane run_many: {trip:.3f} us a step "
            f"(budget={16 * SCEN_TRIP_BUDGET}: {long_trip:.3f}; phase 5's "
            f"hts_run: {'not run' if p5 is None else f'{p5 * 1e3:.3f}'} us "
            f"a step on the device, a mid-run carry)  on {card}")

        def drain_sliced(n):
            srv = hts.serve(max_batch=SCEN_LANES, max_queue=SCEN_REQUESTS,
                            deadline=60.0, device=DEVICE, slice_steps="auto")
            for p in progs[:n]:
                srv.submit(p)
            srv.drain()
        try:
            events, wall_us = trace_window(
                torch, lambda: drain_sliced(SCEN_LANES),
                lambda: drain_sliced(SCEN_REQUESTS))
            busy = sum(us for _key, us in events)
            kern = sum(us for key, us in events if "hts_run_kernel" in key)
            log(f"traced 11b drain: wall {wall_us / 1e3:.3f} ms, device busy "
                f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), "
                f"hts_run {kern / 1e3:.3f} ms, {len(events)} device "
                f"activities  on {card}")
            for key, us, cnt in costliest(events):
                log(f"    {us / 1e3:9.3f} ms  x{cnt:<5d} {key}")
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"busy share not measured (profiler unavailable: {e})")
        wall = time.perf_counter() - t_phase
        log(f"phase 11 wall {wall:.1f} s (limit {SCEN_PHASE_S:.0f} s)")
        assert wall < SCEN_PHASE_S, f"phase 11 took {wall:.1f} s"
    phase("11 scenario server", scenario_server)

    # 12. the MoE family and paligemma-3b's prefix-LM attention ------------
    def attn_256():
        """K15 at head dim 256 against plain (bf16 and float32; bf16 also
        through each of its two instances) at paligemma-3b's call shapes
        and ragged ones; then the prefix, text, square and a ragged causal
        shape timed in bf16, through each instance and the one the
        wrapper chooses, beside their bound and SDPA (every timed shape is
        one SDPA call)."""
        F = torch.nn.functional
        from torch.nn.attention.bias import causal_lower_right
        names = tuple(attention.INSTANCES[256])
        for i, shape in enumerate(ATTN_256_CASES):
            for dt in ("bfloat16", "float32"):
                tf_check("flash_attention", shape, dt, 900 + i)
            for inst in names:
                tf_check("flash_attention", shape, "bfloat16", 900 + i, inst)
        for inst, (dp, nwg) in zip(names, ((256, 1), (256, 2))):
            log(f"K15 D 256 {inst}: flash_attention_wgmma<{dp}, {nwg}>, "
                f"ptxas {k15_regs(dp, nwg) or 'not reported (cached)'}")
        times: dict = {}
        for label, i in ATTN_256_TIMED.items():
            shape = ATTN_256_CASES[i]
            q, k, v, causal, q_offset = tf_case(
                torch, "flash_attention", shape, torch.bfloat16, 950 + i)
            kw = dict(causal=causal, q_offset=q_offset)
            chosen = attention.d256_instance(shape[0], shape[1], q.device)
            by_inst = k15_instances(q, k, v, kw, names)
            dev, call = by_inst[chosen]
            plain = events_ms(torch, [functools.partial(
                plain_attention, ref, q, k, v, **kw)] * 8)
            bound, by, _ = tf_bound("flash_attention",
                                    (q, k, v, causal, q_offset))
            lib = lib_dev = None
            Tq, Tk = shape[1], shape[2]
            if not causal or q_offset == Tk - Tq:
                # SDPA on paligemma's layout, (B, H, T, D): the same
                # function.  K15's causal mask from q_offset = Tk - Tq is
                # SDPA's lower-right-aligned causal bias.
                q4, k4, v4 = (t.view(VLM_B, t.shape[0] // VLM_B,
                                     *t.shape[1:]) for t in (q, k, v))
                mask = causal_lower_right(Tq, Tk) if causal else None
                lc = [functools.partial(F.scaled_dot_product_attention, q4,
                                        k4, v4, attn_mask=mask)] * 23
                lib = events_ms(torch, lc)
                lib_dev = profiled_call_ms(torch, lc)
            times[label] = dict(shape=list(shape), instance=chosen, ms=dev,
                                call_ms=call, plain_ms=plain, bound_ms=bound,
                                bound_by=by, library_ms=lib,
                                library_device_ms=lib_dev)
            for inst, (d_ms, c_ms) in by_inst.items():
                times[label].update({f"ms_{inst}": d_ms,
                                     f"call_ms_{inst}": c_ms})
            sdpa = ("none (no single call)" if lib is None else
                    f"{lib:.4f} ms a call ({lib_dev} ms on the device)")
            each = "; ".join(
                f"{inst} {'not measured' if d_ms is None else f'{d_ms:.4f} ms'}"
                f" on the device ({'-' if d_ms is None else f'{d_ms / bound:.2f}x'}"
                f" the bound), {c_ms:.4f} ms a call"
                for inst, (d_ms, c_ms) in by_inst.items())
            log(f"K15 D 256 {label:6s} {shape} bf16: {each}; the wrapper "
                f"takes {chosen}; plain {plain:.4f} ms, bound {bound:.4f} ms "
                f"({by}), SDPA {sdpa}  on {card}")
        ctx["d256"] = times

    def build12(arch, n_layers=None):
        """``arch`` at its published widths (``n_layers`` cuts its depth)
        on the card."""
        cfg = registry.get_config(arch)
        if n_layers:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        return registry.build(cfg, device=DEVICE)

    def model12(arch):
        """``arch`` at its published widths and depth with random bf16
        weights from MODEL_SEED on the card, whose memory is emptied
        first."""
        model = build12(arch)
        cfg = model.cfg
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = model.init(MODEL_SEED)
        torch.cuda.synchronize()
        m = cfg.moe
        ffn = (f"{m.num_experts} experts (padded to "
               f"{transformer.padded_experts(m.num_experts)}) of width "
               f"{m.d_expert}, top-{m.top_k}, {m.num_shared} shared"
               if m else f"d_ff {cfg.d_ff}" + (
                   f", a prefix of {cfg.prefix_len}" if cfg.prefix_len
                   else ""))
        log(f"{cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads} query / {cfg.n_kv_heads} KV heads of "
            f"{cfg.head_dim}, {ffn}, vocab {cfg.vocab}: "
            f"{model.param_count() / 1e9:.4f} B parameters "
            f"({model.active_param_count() / 1e9:.4f} B active), "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card "
            f"(seed {MODEL_SEED}, {time.perf_counter() - t0:.2f} s)")
        return model, params

    def tf_counts(cfg):
        """K15 and K16 launches of one prefill or forward (K15 twice a
        layer with a prefix) and of one decode step (K16 alone)."""
        L = cfg.n_layers
        if cfg.family == "audio":
            # whisper: encode (K15 a layer, K16 twice and once more) and
            # decode_seq (K15 twice a layer, K16 three times and once more)
            E = cfg.enc_layers
            return ({**zero, "flash_attention": E + 2 * L,
                     "rmsnorm": 2 * E + 3 * L + 2},
                    {**zero, "rmsnorm": 3 * L + 1})
        attn = L * (2 if cfg.prefix_len else 1)
        return ({**zero, "flash_attention": attn, "rmsnorm": 2 * L + 1},
                {**zero, "rmsnorm": 2 * L + 1})

    def tokens12(vocab, B, T):
        rng = np.random.default_rng(MODEL_SEED)
        return torch.from_numpy(rng.integers(0, vocab, (B, T)).astype(
            np.int32)).to(DEVICE)

    def forward_run(model, params, tok, on=False, **swap):
        """``forward`` of ``tok`` on the path ``on`` and ``swap`` select,
        in ``drive``'s result's form (no decode steps)."""
        with plain_path(on, ref, **kernels, **swap), \
                record_routing(transformer) as routes:
            torch.cuda.synchronize()
            tlib.reset_launches()
            t0 = time.perf_counter()
            logits, aux = transformer.forward(params, model.cfg, tok)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        seq = logits.float()
        assert bool(torch.isfinite(seq).all()) and bool(
            torch.isfinite(aux)), "not finite"
        return dict(seq=seq, last=seq[:, -1], steps=[], wall=wall,
                    counts=dict(tlib.launches), routes=routes,
                    aux=float(aux))

    def fp32_gate(model, run, witness=False):
        """The float32 gate: the model drawn again in float32 (the same
        seed's draws, unrounded; for WIDTH_DRAW_GATES, after the kernels,
        and plain on the embedding one ulp up, are compared with plain at
        the reference's draw and printed, scaled to 1/sqrt(input width)); ``run(params, on, **swap)`` on the plain
        ops, then on the kernels and on the control (K15 as the plain
        attention with its scores rounded to bf16) with the MoE routing
        forced to the plain run's (``force_routing``: a routing decision
        is discrete, and one flipped expert moves a token by its gate; the
        kernels' free-running routing and logits are printed beside, not
        gated).  The kernels within FP32_LOGIT_TOL of plain, the control
        past it.  ``witness``: plain on the embedding one ulp up is
        compared with plain and printed (how far one ulp anywhere carries
        at this draw; not gated)."""
        arch = model.cfg.name
        tol = FP32_LOGIT_TOL[arch]
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            torch.cuda.empty_cache()
            p32 = model.init(MODEL_SEED)
            if arch in WIDTH_DRAW_GATES:
                rp, rk = run(p32, True), run(p32, False)
                d, n = routing_diff(rk["routes"], rp["routes"])
                logit_errors(f"{arch} fp32 logits at the reference's draw, "
                             f"kernels vs plain ({d} of {n} routing "
                             "decisions differ; not gated)", rk, rp)
                # the witness: plain again on the embedding one ulp up, a
                # perturbation of K16's size on no kernel at all
                emb = p32["embed"]
                p32["embed"] = torch.nextafter(emb, emb.new_tensor(math.inf))
                rn = run(p32, True)
                with force_routing(transformer, rp["routes"]) as n_flips:
                    rnf = run(p32, True)
                p32["embed"] = emb
                d, n = routing_diff(rn["routes"], rp["routes"])
                logit_errors(f"{arch} fp32 logits at the reference's draw, "
                             "plain on the embedding one ulp up vs plain "
                             f"({d} of {n} routing decisions differ; not "
                             "gated)", rn, rp)
                logit_errors(f"{arch} fp32 logits at the reference's draw, "
                             "plain on the embedding one ulp up, routing "
                             f"forced to plain's ({int(sum(n_flips))} own "
                             "decisions differ) vs plain (not gated)",
                             rnf, rp)
                del rp, rk, rn, rnf
                for key in model.impl.STACKED:
                    scale_to_width(p32[key], len(p32[key]))
            pl = run(p32, True)
            if witness:
                emb = p32["embed"]
                p32["embed"] = torch.nextafter(emb, emb.new_tensor(math.inf))
                rw = run(p32, True)
                p32["embed"] = emb
                logit_errors(f"{arch} fp32 logits, plain on the embedding one "
                             "ulp up vs plain (the witness; not gated)", rw,
                             pl)
                del rw
            free = run(p32, False) if model.cfg.moe else None
            with force_routing(transformer, pl["routes"]) as flips:
                k = run(p32, False)
            with force_routing(transformer, pl["routes"]) as c_flips:
                ctl = run(p32, True, only=("flash_attention",),
                          attn=attention_bf16_scores)
            del p32
        finally:
            layers.COMPUTE_DTYPE = saved
        want = tf_counts(model.cfg)[0]
        assert k["counts"] == want, k["counts"]
        assert ctl["counts"] == {**want, "flash_attention": 0}, ctl["counts"]
        log(f"{arch} float32 (kernels): {k['wall'] * 1e3:.1f} ms  on {card}")
        if free is not None:
            d, n = routing_diff(free["routes"], pl["routes"])
            log(f"{arch} float32, free-running routing: {d} of {n} routing "
                "decisions (a token's top-k in a layer) differ between the "
                "kernels and plain (not gated)")
            logit_errors(f"{arch} fp32 logits, kernels with their own "
                         "routing vs plain (not gated)", free, pl)
            log(f"{arch} float32, routing forced to plain's: the kernels' "
                f"own top-k differs on {int(sum(flips))} of {n} decisions, "
                f"the control's on {int(sum(c_flips))}")
        err = logit_errors(f"{arch} fp32 logits, kernels vs plain", k, pl,
                           tol)
        c_err = logit_errors(f"{arch} fp32 logits, control (K15 plain, "
                             "scores rounded to bf16) vs plain", ctl, pl,
                             tol)
        assert err <= tol, f"{arch} fp32 logits differ ({err:.3g} > {tol})"
        if c_err <= tol:
            raise AssertionError(f"{arch}: the control passes the fp32 gate "
                                 f"at {tol} ({c_err:.3g})")
        log(f"{arch}: the control fails the fp32 gate, as it must "
            f"({c_err:.3g} > {tol})")

    def split12(what, call):
        """``time_split`` of one ``call()`` (warmed by one), printed."""
        try:
            t = time_split(torch, call, call)
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"{what}: time split not measured (profiler: {e})")
            return
        log(f"{what}, traced: wall {t['wall']:.3f} ms, device busy "
            f"{t['busy']:.3f} ms ({100 * t['busy'] / t['wall']:.1f} %): "
            f"expert products (bmm) {t['expert_products']:.3f}, other "
            f"matrix products {t['other_products']:.3f}, K15 "
            f"{t['k15']:.3f}, K16 {t['k16']:.3f}, the rest {t['rest']:.3f} "
            f"ms, {len(t['events'])} device activities  on {card}")
        for key, us, cnt in costliest(t["events"], 1, 10):
            log(f"    {us / 1e3:9.3f} ms  x{cnt:<5d} {key}")

    def prefill12(model, params, tok, max_len, steps, prefix=None):
        """bf16 ``prefill`` and greedy decode on the kernels after an
        untimed warm-up of each, their launches checked and recorded, the
        prefill's time split traced."""
        arch = model.cfg.name
        logits, cache = model.prefill(params, tok, max_len, prefix)
        model.decode_step(params, cache, tok[:, :1], logits.shape[1])
        del logits, cache
        r = drive(model, params, tok, [], prefix=prefix, max_len=max_len,
                  steps=steps)
        pre, step = tf_counts(model.cfg)
        assert r["counts"] == pre, r["counts"]
        assert r["dcounts"] == {k: v * steps for k, v in step.items()}, \
            r["dcounts"]
        tf_launches[f"{arch}/prefill"] = r["counts"]
        tf_launches[f"{arch}/decode"] = r["dcounts"]
        B, T = tok.shape[0], tok.shape[1] + (0 if prefix is None
                                             else prefix.shape[1])
        split12(f"{arch} prefill bf16 B={B} T={T}", lambda: model.prefill(
            params, tok, max_len, prefix))
        log(f"{arch} prefill bf16 B={B} T={T}: {r['wall'] * 1e3:.1f} ms, "
            f"{B * T / r['wall']:.0f} tokens/s, launches {r['counts']}, "
            f"peak device memory {r['peak'] / 1e9:.3f} GB; {steps} decode "
            f"steps at B={B}: {r['dwall'] / steps * 1e3:.2f} ms a step, "
            f"{B * steps / r['dwall']:.1f} tokens/s, launches "
            f"{r['dcounts']}  on {card}")

    def server12(model, params):
        """The Server (SERVE_SLOTS slots, SERVE_REQUESTS requests, ooo):
        every request completes, K16 only; tokens/s, ms a step and a
        traced window's busy share."""
        arch = model.cfg.name
        reqs = serve_requests(model.cfg.vocab)
        srv = serving.Server(model, params, n_slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN)
        objs = [serving.Request(i, list(p), m)
                for i, (p, m) in enumerate(reqs)]
        for r in objs:
            srv.submit(r)
        srv.step()                          # warm-up: admits, one step
        busy0 = srv.stats.slot_busy_steps
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tlib.reset_launches()
        t0 = time.perf_counter()
        st = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tlib.launches)
        tf_launches[f"{arch}/server"] = counts
        assert st.completed == SERVE_REQUESTS and all(
            r.done and len(r.out) == r.max_new for r in objs), \
            f"{st.completed} of {SERVE_REQUESTS} completed"
        steps = st.steps - 1
        assert counts == {k: v * steps
                          for k, v in tf_counts(model.cfg)[1].items()}, counts
        log(f"{arch} Server: {SERVE_REQUESTS} requests, {st.steps} steps, "
            f"utilization {st.utilization(SERVE_SLOTS):.4f}, {steps} steps "
            f"timed in {wall:.3f} s: {wall / steps * 1e3:.2f} ms a step, "
            f"{(st.slot_busy_steps - busy0) / wall:.1f} tokens/s (slot-steps"
            f"), peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB  on {card}")
        srv = serving.Server(model, params, n_slots=SERVE_SLOTS,
                             max_len=SERVE_MAX_LEN)
        for i, (p_, m) in enumerate(reqs):
            srv.submit(serving.Request(i, list(p_), m))
        for _ in range(48):
            srv.step()

        def run_steps(n):
            for _ in range(n):
                srv.step()
        try:
            events, wall_us = trace_window(torch, lambda: run_steps(1),
                                           lambda: run_steps(TRACE_STEPS))
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"{arch} server step profile not measured (profiler: {e})")
            return
        busy = sum(us for _k, us in events)
        log(f"{arch} Server step profile ({TRACE_STEPS} steps from step 49, "
            f"{sum(srv.busy)} busy slots): {wall_us / TRACE_STEPS / 1e3:.3f}"
            f" ms wall a step, device busy {busy / TRACE_STEPS / 1e3:.3f} ms "
            f"a step ({100 * busy / wall_us:.1f} %), "
            f"{len(events) / TRACE_STEPS:.0f} device activities a step  on "
            f"{card}")
        for key, us, cnt in costliest(events, TRACE_STEPS):
            log(f"    {us:9.1f} us/step  x{cnt:<4d} {key}")

    def olmoe():
        """olmoe-1b-7b at full width and depth: prefill 4 x 2048 and 32
        decode steps in bf16, aux finite, the Server; then the float32
        gate at 1 x 2048 (the bf16 weights freed first)."""
        model, params = model12(MOE_ARCHS[0])
        tok = tokens12(model.cfg.vocab, MOE_PREFILL_B, MOE_PREFILL_T)
        prefill12(model, params, tok, MOE_MAX_LEN, MOE_DECODE_STEPS)
        r = forward_run(model, params, tok[:1])
        log(f"{model.cfg.name} forward bf16 1 x {MOE_PREFILL_T}: aux "
            f"{r['aux']:.6f} (finite), {r['wall'] * 1e3:.1f} ms")
        del r
        server12(model, params)
        del params
        gtok = tok[:MOE_GATE_B]
        feeds: list = []
        fp32_gate(model, lambda p, on, **swap: drive(
            model, p, gtok, feeds, on=on, max_len=MOE_MAX_LEN,
            steps=MOE_GATE_STEPS, full=True, **swap))

    def qwen2_moe():
        """qwen2-moe-a2.7b at full width and depth: forward on 2 x 1024 in
        bf16 with moe_grouped off and on (the padded experts 60-63 take no
        token); then the float32 gate at 4 layers."""
        arch = MOE_ARCHS[1]
        model, params = model12(arch)
        cfg = model.cfg
        tok = tokens12(cfg.vocab, QMOE_B, QMOE_T)
        runs = {}
        for grouped in (False, True):
            with flags.use_flags(moe_grouped=grouped):
                forward_run(model, params, tok)                # warm-up
                r = forward_run(model, params, tok)
            key = "forward_grouped" if grouped else "forward"
            assert r["counts"] == tf_counts(cfg)[0], r["counts"]
            tf_launches[f"{arch}/{key}"] = r["counts"]
            top = max(int(t.max()) for t in r["routes"])
            assert len(r["routes"]) == cfg.n_layers and \
                top < cfg.moe.num_experts, top
            runs[key] = r
            with flags.use_flags(moe_grouped=grouped):
                split12(f"{arch} forward bf16 moe_grouped={grouped}",
                        lambda: transformer.forward(params, cfg, tok))
            log(f"{arch} forward bf16 B={QMOE_B} T={QMOE_T} moe_grouped="
                f"{grouped}: {r['wall'] * 1e3:.1f} ms, "
                f"{QMOE_B * QMOE_T / r['wall']:.0f} tokens/s, launches "
                f"{r['counts']}, aux {r['aux']:.6f}, the highest expert "
                f"chosen {top} (experts {cfg.moe.num_experts}-"
                f"{transformer.padded_experts(cfg.moe.num_experts) - 1} are "
                f"padding)  on {card}")
        d, n = routing_diff(runs["forward_grouped"]["routes"],
                            runs["forward"]["routes"])
        log(f"{arch} grouped against global dispatch (capacity per "
            f"sequence, not gated): logits normwise "
            f"{normwise(runs['forward_grouped']['seq'], runs['forward']['seq']):.3g}"
            f", routing decisions that differ {d} of {n}")
        del runs, r, params
        model = build12(arch, QMOE_GATE_LAYERS)
        fp32_gate(model, lambda p, on, **swap: forward_run(
            model, p, tok, on=on, **swap))

    def paligemma():
        """paligemma-3b at full width and depth: prefill of 2 x (256
        prefix embeddings + 1792 text tokens), 36 K15 launches, 16 decode
        steps, in bf16; then the float32 gate on the same input."""
        model, params = model12(VLM_ARCH)
        cfg = model.cfg
        tok = tokens12(cfg.vocab, VLM_B, VLM_TEXT)
        rng = np.random.default_rng(MODEL_SEED + 1)
        prefix = torch.from_numpy(rng.standard_normal(
            (VLM_B, cfg.prefix_len, cfg.d_model)).astype(np.float32)).to(
                DEVICE)
        prefill12(model, params, tok, VLM_MAX_LEN, VLM_DECODE_STEPS, prefix)
        del params
        feeds: list = []
        fp32_gate(model, lambda p, on, **swap: drive(
            model, p, tok, feeds, on=on, prefix=prefix, max_len=VLM_MAX_LEN,
            steps=VLM_DECODE_STEPS, full=True, **swap))

    phase("12a K15 at head dim 256 vs plain", attn_256)
    for name, fn in (("12b olmoe-1b-7b at full width", olmoe),
                     ("12c qwen2-moe-a2.7b at full width", qwen2_moe),
                     ("12d paligemma-3b at full width", paligemma)):
        phase(name, fn)
        torch.cuda.empty_cache()            # one model on the card at a time

    # 13. phi3-mini-3.8b: K15 at head dim 96 -------------------------------
    def attn_96():
        """K15 at head dim 96 against plain (bf16 and float32) at phi3's
        prefill shape, a ragged Tk, a q_offset chunk and Tq < 8; then the
        prefill shape timed in bf16 beside its bound and SDPA."""
        F = torch.nn.functional
        for i, shape in enumerate(ATTN_96_CASES):
            for dt in ("bfloat16", "float32"):
                tf_check("flash_attention", shape, dt, 1300 + i)
        log(f"K15 D 96: flash_attention_wgmma<96, 2>, ptxas "
            f"{k15_regs(96, 2) or 'not reported (cached)'}")
        shape = ATTN_96_CASES[0]
        q, k, v, causal, q_offset = tf_case(torch, "flash_attention", shape,
                                            torch.bfloat16, 1350)
        kw = dict(causal=causal, q_offset=q_offset)
        calls = [functools.partial(attention.flash_attention, q, k, v,
                                   **kw)] * 23
        dev = profiled_ms(torch, calls, TF_KERNEL["flash_attention"])
        call = events_ms(torch, calls)
        plain = events_ms(torch, [functools.partial(
            plain_attention, ref, q, k, v, **kw)] * 8)
        bound, by, _ = tf_bound("flash_attention", (q, k, v, causal,
                                                    q_offset))
        # SDPA on phi3's layout, (B, H, T, D), causal: the same function
        q4, k4, v4 = (t.view(PHI3_B, t.shape[0] // PHI3_B, *t.shape[1:])
                      for t in (q, k, v))
        lc = [functools.partial(F.scaled_dot_product_attention, q4, k4, v4,
                                is_causal=True)] * 23
        lib, lib_dev = events_ms(torch, lc), profiled_call_ms(torch, lc)
        ctx["d96"] = dict(shape=list(shape), ms=dev, call_ms=call,
                          plain_ms=plain, bound_ms=bound, bound_by=by,
                          library_ms=lib, library_device_ms=lib_dev)
        ratio = "" if dev is None else f", {dev / bound:.2f}x it"
        log(f"K15 D 96 prefill {shape} bf16: kernel "
            f"{'not measured' if dev is None else f'{dev:.4f} ms'} on the "
            f"device, {call:.4f} ms a call, plain {plain:.4f} ms, bound "
            f"{bound:.4f} ms ({by}{ratio}), SDPA {lib:.4f} ms a call "
            f"({lib_dev} ms on the device)  on {card}")

    def phi3():
        """phi3-mini-3.8b at full width and depth: prefill 4 x 2048 and 32
        greedy decode steps in bf16 (32 K15 and 65 K16 launches a prefill,
        65 K16 a step), its time split traced; then the float32 gate on
        the same tokens, the bf16 weights freed first, with the one-ulp
        witness printed."""
        model, params = model12(PHI3_ARCH)
        assert model.cfg.head_dim == 96, model.cfg.head_dim
        tok = tokens12(model.cfg.vocab, PHI3_B, PHI3_T)
        prefill12(model, params, tok, PHI3_MAX_LEN, PHI3_DECODE_STEPS)
        del params
        feeds: list = []
        fp32_gate(model, lambda p, on, **swap: drive(
            model, p, tok, feeds, on=on, max_len=PHI3_MAX_LEN,
            steps=PHI3_DECODE_STEPS, full=True, **swap), witness=True)

    phase("13a K15 at head dim 96 vs plain", attn_96)
    phase("13b phi3-mini-3.8b at full width", phi3)
    torch.cuda.empty_cache()

    # 14. whisper-base, the audio family: K15 at head dim 64 ---------------
    def attn_64():
        """K15 at whisper-base's three calls (B = 16: the encoder's 1500
        frames and the cross attention's 448 queries on them unmasked, the
        decoder's 448 causal) and K16 at 16·1500 rows of 512 against
        plain (bf16 2e-2, float32 1e-5); then each timed in bf16 beside
        its bound and the library call (SDPA on the model's (B, H, T, D)
        layout, ``F.rms_norm``)."""
        F = torch.nn.functional
        for i, shape in enumerate(ATTN_64_CASES.values()):
            for dt in ("bfloat16", "float32"):
                tf_check("flash_attention", shape, dt, 1400 + i)
        for dt in ("bfloat16", "float32"):
            tf_check("rmsnorm", RMS_512, dt, 1410)
        log(f"K15 D 64: flash_attention_wgmma<64, 2>, ptxas "
            f"{k15_regs(64, 2) or 'not reported (cached)'}")
        times: dict = {}
        for i, (label, shape) in enumerate(ATTN_64_CASES.items()):
            q, k, v, causal, q_offset = tf_case(
                torch, "flash_attention", shape, torch.bfloat16, 1450 + i)
            calls = [functools.partial(attention.flash_attention, q, k, v,
                                       causal=causal)] * 23
            dev = profiled_ms(torch, calls, TF_KERNEL["flash_attention"])
            call = events_ms(torch, calls)
            plain = events_ms(torch, [functools.partial(
                plain_attention, ref, q, k, v, causal=causal)] * 8)
            bound, by, _ = tf_bound("flash_attention",
                                    (q, k, v, causal, q_offset))
            q4, k4, v4 = (t.view(WHISPER_B, t.shape[0] // WHISPER_B,
                                 *t.shape[1:]) for t in (q, k, v))
            lc = [functools.partial(F.scaled_dot_product_attention, q4, k4,
                                    v4, is_causal=causal)] * 23
            lib, lib_dev = events_ms(torch, lc), profiled_call_ms(torch, lc)
            times[label] = dict(shape=list(shape), ms=dev, call_ms=call,
                                plain_ms=plain, bound_ms=bound, bound_by=by,
                                library_ms=lib, library_device_ms=lib_dev)
            ratio = "" if dev is None else f", {dev / bound:.2f}x it"
            log(f"K15 D 64 {label:7s} {shape} bf16: kernel "
                f"{'not measured' if dev is None else f'{dev:.4f} ms'} on "
                f"the device, {call:.4f} ms a call, plain {plain:.4f} ms, "
                f"bound {bound:.4f} ms ({by}{ratio}), SDPA {lib:.4f} ms a "
                f"call ({lib_dev} ms on the device)  on {card}")
        ctx["d64"] = times
        x, w = tf_case(torch, "rmsnorm", RMS_512, torch.bfloat16, 1460)
        calls = [functools.partial(rmsnorm.rmsnorm, x, w, 1e-6)] * 23
        lc = [functools.partial(F.rms_norm, x, (x.shape[1],), w, 1e-6)] * 23
        r = dict(shape=list(RMS_512),
                 ms=profiled_ms(torch, calls, TF_KERNEL["rmsnorm"]),
                 call_ms=events_ms(torch, calls),
                 plain_ms=events_ms(torch, [functools.partial(
                     ref.rmsnorm, x, w, 1e-6)] * 8),
                 bound_ms=tf_bound("rmsnorm", (x, w))[0],
                 library_ms=events_ms(torch, lc),
                 library_device_ms=profiled_call_ms(torch, lc))
        ctx["r512"] = r
        log(f"K16 {RMS_512} bf16: kernel {r['ms']} ms on the device, "
            f"{r['call_ms']:.4f} ms a call, plain {r['plain_ms']:.4f} ms, "
            f"bound {r['bound_ms']:.4f} ms, F.rms_norm "
            f"{r['library_ms']:.4f} ms a call ({r['library_device_ms']} ms "
            f"on the device)  on {card}")

    def whisper_inputs(cfg):
        rng = np.random.default_rng(MODEL_SEED)
        frames = torch.from_numpy(rng.standard_normal(
            (WHISPER_B, WHISPER_TE, cfg.d_model), dtype=np.float32)).to(DEVICE)
        tok = torch.from_numpy(rng.integers(
            0, cfg.vocab, (WHISPER_B, WHISPER_TD)).astype(np.int32)).to(DEVICE)
        return frames, tok

    def whisper_run(model, params, frames, tok, on=False, **swap):
        """``encode`` then ``decode_seq`` on the path ``on`` and ``swap``
        select, in ``drive``'s result's form (every position's logits, no
        decode steps), each half's wall and launches."""
        cfg = model.cfg
        with plain_path(on, ref, **kernels, **swap):
            torch.cuda.synchronize()
            tlib.reset_launches()
            t0 = time.perf_counter()
            enc = whisper.encode(params, cfg, frames)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            enc_counts = dict(tlib.launches)
            logits = whisper.decode_seq(params, cfg, tok, enc)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
        seq = logits.float()
        del logits, enc
        assert bool(torch.isfinite(seq).all()), "not finite"
        counts = dict(tlib.launches)
        return dict(seq=seq, last=seq[:, -1], steps=[], routes=[],
                    wall=t2 - t0, enc_wall=t1 - t0, dec_wall=t2 - t1,
                    enc_counts=enc_counts, counts=counts)

    def whisper_forward():
        """14b: whisper-base at full width and depth with random bf16
        weights from MODEL_SEED: ``encode`` of 16 x 1500 frames and
        ``decode_seq`` of 16 x 448 tokens on the kernels (6 K15 and 13 K16
        launches, then 12 and 19), frames/s and tokens/s, the time split
        traced; then the float32 gate (every position's logits, kernels
        against plain, the control failing it, at weights scaled to
        1/sqrt(input width); at the reference's draw, chaotic in float32,
        the kernels' reading printed beside the one-ulp witnesses on the
        embedding and on the frames)."""
        model, params = model12(WHISPER_ARCH)
        cfg = model.cfg
        E, D = cfg.enc_layers, cfg.n_layers
        frames, tok = whisper_inputs(cfg)
        whisper_run(model, params, frames, tok)           # warm-up
        r = whisper_run(model, params, frames, tok)
        enc_want = {**zero, "flash_attention": E, "rmsnorm": 2 * E + 1}
        assert r["enc_counts"] == enc_want, r["enc_counts"]
        assert r["counts"] == tf_counts(cfg)[0], r["counts"]
        tf_launches["whisper-base/encode"] = enc_want
        tf_launches["whisper-base/decode_seq"] = {
            k: r["counts"][k] - enc_want[k] for k in zero}
        split12(f"whisper-base encode + decode_seq bf16 B={WHISPER_B}",
                lambda: whisper_run(model, params, frames, tok))
        log(f"whisper-base bf16: encode {WHISPER_B} x {WHISPER_TE} frames "
            f"{r['enc_wall'] * 1e3:.1f} ms ({WHISPER_B * WHISPER_TE / r['enc_wall']:.0f}"
            f" frames/s), decode_seq {WHISPER_B} x {WHISPER_TD} tokens "
            f"{r['dec_wall'] * 1e3:.1f} ms ({WHISPER_B * WHISPER_TD / r['dec_wall']:.0f}"
            f" tokens/s), launches {r['counts']}  on {card}")
        ctx["whisper"] = (model, params)
        fp32_gate(model, lambda p, on, **swap: whisper_run(
            model, p, frames, tok, on=on, **swap), witness=True)
        # the encoder's witness at the reference's draw: fp32_gate's moves
        # the decoder's embedding alone
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            p32 = model.init(MODEL_SEED)
            pl = whisper_run(model, p32, frames, tok, on=True)
            up = torch.nextafter(frames, frames.new_tensor(math.inf))
            rw = whisper_run(model, p32, up, tok, on=True)
            del p32
        finally:
            layers.COMPUTE_DTYPE = saved
        logit_errors("whisper-base fp32 logits at the reference's draw, "
                     "plain on the frames one ulp up vs plain (the "
                     "encoder's witness; not gated)", rw, pl)

    def whisper_decode():
        """14c: cross K/V from the encoder states at max_len = 1500 (no
        pad rows, as the reference's test fills it), then 32 teacher-forced
        ``decode_step``s in float32 against ``decode_seq``'s logits at the
        same positions: at the weights scaled to 1/sqrt(input width)
        within WHISPER_LOGIC_TOL normwise, at the reference's draw
        (chaotic in float32, 14b) printed; then 32 greedy bf16 decode
        steps timed."""
        model, params = ctx["whisper"]
        cfg = model.cfg
        frames, tok = whisper_inputs(cfg)
        n = WHISPER_DECODE_STEPS

        def decode_vs_seq(p):
            enc = whisper.encode(p, cfg, frames)
            seq = whisper.decode_seq(p, cfg, tok[:, :n], enc).float()
            cache = whisper.fill_cross_cache(
                p, cfg, model.init_cache(WHISPER_B, WHISPER_TE), enc)
            return [normwise(model.decode_step(p, cache, tok[:, t:t + 1],
                                               t)[0][:, 0], seq[:, t])
                    for t in range(n)]
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            p32 = model.init(MODEL_SEED)
            chaotic = decode_vs_seq(p32)
            for key in model.impl.STACKED:
                scale_to_width(p32[key], len(p32[key]))
            errs = decode_vs_seq(p32)
            del p32
        finally:
            layers.COMPUTE_DTYPE = saved
        log(f"float32 decode_step vs decode_seq over {n} positions (cross "
            f"K/V of {WHISPER_TE} frames, no pad rows), the reference's "
            f"draw: normwise max {max(chaotic):.3g} mean "
            f"{np.mean(chaotic):.3g} (chaotic, as 14b's witness: not gated)")
        log(f"the same at weights scaled to 1/sqrt(input width): normwise "
            f"max {max(errs):.3g} mean {np.mean(errs):.3g} (limit "
            f"{WHISPER_LOGIC_TOL})")
        assert max(errs) <= WHISPER_LOGIC_TOL, max(errs)
        enc = whisper.encode(params, cfg, frames)
        cache = whisper.fill_cross_cache(
            params, cfg, model.init_cache(WHISPER_B, WHISPER_TE), enc)
        cur = tok[:, :1]
        model.decode_step(params, model.init_cache(WHISPER_B, 64), cur, 0)
        torch.cuda.synchronize()
        tlib.reset_launches()
        t0 = time.perf_counter()
        for t in range(n):
            lg, cache = model.decode_step(params, cache, cur, t)
            cur = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tlib.launches)
        assert counts == {**zero, "rmsnorm": n * tf_counts(cfg)[1][
            "rmsnorm"]}, counts
        tf_launches["whisper-base/decode"] = counts
        log(f"whisper-base bf16 decode at B={WHISPER_B} against {WHISPER_TE}"
            f" frames: {wall / n * 1e3:.2f} ms a step, "
            f"{WHISPER_B * n / wall:.1f} tokens/s  on {card}")

    def whisper_server():
        """14d: the ``Server`` on whisper-base, WHISPER_SLOTS slots, equal
        prompts (one position for every slot, as the reference serves this
        family; the cross K/V zeroed with the slot, as in the reference):
        every request completes, K16 19 launches a step and no K15."""
        model, params = ctx["whisper"]
        cfg = model.cfg
        rng = np.random.default_rng(SERVE_SEED)
        srv = serving.Server(model, params, n_slots=WHISPER_SLOTS,
                             max_len=WHISPER_MAX_LEN)
        objs = [serving.Request(i, rng.integers(
            0, cfg.vocab, WHISPER_PROMPT).tolist(), WHISPER_NEW)
            for i in range(WHISPER_REQUESTS)]
        for r in objs:
            srv.submit(r)
        torch.cuda.synchronize()
        tlib.reset_launches()
        t0 = time.perf_counter()
        st = srv.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(tlib.launches)
        tf_launches["whisper-base/server"] = counts
        assert st.completed == WHISPER_REQUESTS and all(
            r.done and len(r.out) == WHISPER_NEW for r in objs), st
        assert counts == {**zero, "rmsnorm": st.steps * tf_counts(cfg)[1][
            "rmsnorm"]}, counts
        log(f"whisper-base Server: {WHISPER_REQUESTS} requests, {st.steps} "
            f"steps, utilization {st.utilization(WHISPER_SLOTS):.4f}, "
            f"{st.slot_busy_steps / wall:.1f} tokens/s, "
            f"{wall / st.steps * 1e3:.2f} ms a step  on {card}")

    phase("14a K15 at head dim 64 and K16 at 512 vs plain", attn_64)
    phase("14b whisper-base forward at full width", whisper_forward)
    if "whisper" in ctx:
        phase("14c whisper-base decode against decode_seq", whisper_decode)
        phase("14d whisper-base Server", whisper_server)
        ctx.pop("whisper")
    torch.cuda.empty_cache()

    # 15. training: Qwen2-1.5B train steps at full width, every family's
    # step at smoke width, the runtime ---------------------------------------
    from repro_torch.data import pipeline as data_lib
    from repro_torch.models import layers as train_layers
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.runtime import train as train_rt

    def train_batch(cfg, B, T, seed=MODEL_SEED):
        """A ``SyntheticLM`` batch of B x T (the vlm's prefix embeddings
        and the audio family's frames drawn from numpy) on the card."""
        src = data_lib.SyntheticLM(data_lib.DataConfig(
            vocab=cfg.vocab, seq_len=T, global_batch=B, seed=seed))
        out = src.batch(0)
        rng = np.random.default_rng(seed)
        if cfg.family == "vlm":
            out["prefix_embeds"] = rng.standard_normal(
                (B, cfg.prefix_len, cfg.d_model)).astype(np.float32)
        if cfg.family == "audio":
            out["frames"] = rng.standard_normal(
                (B, TRAIN_FRAMES, cfg.d_model)).astype(np.float32)
        return data_lib.shard_batch(out, DEVICE)

    def grads_of(model, params, batch, policy="nothing"):
        """The train step's loss and gradients (``train_rt.loss_and_grads``;
        zeros where none reached a master, as ``make_train_step`` takes
        them), the launches, and how many gradients were missing."""
        torch.cuda.synchronize()
        tlib.reset_launches()
        loss, got = train_rt.loss_and_grads(model, params, batch, policy)
        torch.cuda.synchronize()
        counts = dict(tlib.launches)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(train_layers.tree_leaves(params), got)]
        return loss, grads, counts, sum(g is None for g in got)

    def leaf_paths(tree, path=""):
        """Each leaf's path (``['layers'][3]['wq']``), in ``tree_leaves``'
        order."""
        if isinstance(tree, dict):
            return [q for k, v in tree.items()
                    for q in leaf_paths(v, f"{path}[{k!r}]")]
        if isinstance(tree, list):
            return [q for i, v in enumerate(tree)
                    for q in leaf_paths(v, f"{path}[{i}]")]
        return [path]

    def grad_errors(grads, want) -> list:
        """Each leaf's normwise error (0 where both are zero)."""
        out = []
        for g, w in zip(grads, want):
            scale = float(w.abs().max())
            diff = float((g - w).abs().max())
            out.append(diff / scale if scale > 0 else
                       (0.0 if diff == 0 else math.inf))
        return out

    def train_counts(cfg):
        """K15-K18 launches of one train step under remat "nothing": each
        layer's kernels in the forward and again in its recompute (the
        final norm, zamba2's tail and whisper's norms outside the layers
        run once)."""
        n = 2
        L = cfg.n_layers
        if cfg.family == "audio":
            E = cfg.enc_layers
            return {**zero, "flash_attention": n * (E + 2 * L),
                    "rmsnorm": n * (2 * E + 3 * L) + 2}
        if cfg.family == "ssm":
            return {**zero, "wkv6": n * L, "rmsnorm": n * 2 * L + 1}
        if cfg.family == "hybrid":
            period = cfg.shared_attn_period
            groups = L // period
            tail = L - groups * period
            return {**zero, "ssd": n * groups * period + tail,
                    "flash_attention": n * groups,
                    "rmsnorm": n * groups * (period + 2) + tail + 1}
        attn = L * (2 if cfg.prefix_len else 1)
        return {**zero, "flash_attention": n * attn,
                "rmsnorm": n * 2 * L + 1}

    @contextlib.contextmanager
    def no_function():
        """While open, the ops call the K15-K18 wrappers directly, without
        the gradient's Function (``ops._apply``): the control (a raw
        kernel's output carries no graph), and, with ``plain_path``,
        plain autograd through the plain versions."""
        saved = ops._apply
        ops._apply = lambda name, kernel, plain, *inputs: kernel(*inputs)
        try:
            yield
        finally:
            ops._apply = saved

    def fn_cases():
        """15a's inputs on the card, (op, plain, inputs): K15 bf16 at the
        train step's 4 x 12 heads of 128 over 2048 (GQA 6 to 1), K16 bf16
        at 8192 x 1536, K17 and K18 float32 at rwkv6's and zamba2's smoke
        widths."""
        g = torch.Generator(device=DEVICE).manual_seed(MODEL_SEED)

        def rn(*shape, dtype=torch.float32, scale=1.0):
            return (torch.randn(*shape, generator=g, device=DEVICE)
                    * scale).to(dtype)
        bf = torch.bfloat16
        B, T = TRAIN_B, TRAIN_T
        r = registry.get_config("rwkv6-3b").smoke()
        z = registry.get_config("zamba2-7b").smoke()
        H, K, V = r.n_heads, r.ssm.d_state, r.ssm.head_dim
        zi = z.ssm.expand * z.d_model
        zH, zN, zP = zi // z.ssm.head_dim, z.ssm.d_state, z.ssm.head_dim
        Ts = FN_SMOKE_T
        return {
            "flash_attention": (
                lambda q, k, v: ops.flash_attention(q, k, v, causal=True),
                lambda q, k, v: ref.flash_attention(
                    q, k.repeat_interleave(6, 1), v.repeat_interleave(6, 1),
                    causal=True),
                [rn(B, 12, T, 128, dtype=bf), rn(B, 2, T, 128, dtype=bf),
                 rn(B, 2, T, 128, dtype=bf)]),
            "rmsnorm": (lambda x, w: ops.rmsnorm(x, w, 1e-6),
                        lambda x, w: ref.rmsnorm(x, w, 1e-6),
                        [rn(B * T, 1536, dtype=bf),
                         (1 + 0.2 * rn(1536)).to(bf)]),
            "wkv6": (ops.rwkv6_scan, ref.rwkv6_scan,
                     [rn(2, Ts, H, K), rn(2, Ts, H, K), rn(2, Ts, H, V),
                      torch.exp(-torch.exp(rn(2, Ts, H, K, scale=0.5))),
                      rn(H, K)]),
            "ssd": (ops.mamba2_ssd, ref.mamba2_ssd,
                    [rn(2, Ts, zH, zP), -torch.exp(rn(2, Ts, zH)),
                     rn(2, Ts, zN), rn(2, Ts, zN)]),
        }

    def op_grads(fn, inputs):
        """Gradients of ((fn(1.5 x...) + bias) c).sum() with respect to
        the leaves x (upstream of the op) and bias, None where the graph
        does not reach one."""
        leaves = [t.clone().requires_grad_(True) for t in inputs]
        out = fn(*(1.5 * t for t in leaves))
        bias = torch.zeros((), device=DEVICE, requires_grad=True)
        c = torch.randn(out.shape, device=DEVICE, generator=torch.Generator(
            device=DEVICE).manual_seed(1)).to(out.dtype)
        loss = ((out + bias) * c).float().sum()
        return torch.autograd.grad(loss, leaves + [bias], allow_unused=True)

    def functions_on_card():
        """15a: each op's Function on the card at its model shape: the
        gradients through the kernel's Function equal plain autograd's bit
        for bit (both are the plain version's VJP of the same inputs);
        the control, the raw kernel without the Function, leaves every
        upstream gradient None."""
        for name, (fn, plain, inputs) in fn_cases().items():
            tlib.reset_launches()
            got = op_grads(fn, inputs)
            launched = tlib.launches[name]
            want = op_grads(plain, inputs)
            with no_function():
                ctl = op_grads(fn, inputs)
            torch.cuda.synchronize()
            assert launched == 1, (name, launched)
            same = all(g is not None and torch.equal(g, w)
                       for g, w in zip(got, want))
            assert same, f"{name}: the Function's gradients differ from plain"
            assert all(g is None for g in ctl[:-1]), \
                f"{name}: the control's upstream gradients are not None"
            shapes = [tuple(t.shape) for t in inputs]
            log(f"15a {name:15s} {shapes} {inputs[0].dtype}: "
                f"{len(got)} gradients through the Function equal plain "
                "autograd's bit for bit; control (raw kernel): upstream "
                "gradients None")

    def train_split(prof) -> dict:
        """A traced train step's device time (ms) by part: K15 and K16
        (forward and recompute), the plain attention backward (inside the
        Function's ``ref_vjp:flash_attention``), AdamW (``adamw.update``),
        the cross-entropy (its forward and its two V-wide backward nodes),
        the other matrix products, the rest."""
        parts = dict.fromkeys(("k15", "k16", "attention_backward", "adamw",
                               "cross_entropy", "products"), 0.0)
        linked = 0.0
        for e in prof.events():
            if not getattr(e, "kernels", None):
                continue
            chain = []
            p = e
            while p is not None:
                chain.append(p.name)
                p = p.cpu_parent
            for kern in e.kernels:
                us = kern.duration
                linked += us
                if "flash_attention" in kern.name:
                    key = "k15"
                elif "rmsnorm" in kern.name:
                    key = "k16"
                elif any(n.startswith("ref_vjp:flash_attention")
                         for n in chain):
                    key = "attention_backward"
                elif "adamw.update" in chain:
                    key = "adamw"
                elif any(n == "softmax_xent" or "LogsumexpBackward" in n
                         or "GatherBackward" in n for n in chain):
                    key = "cross_entropy"
                elif e.name in ("aten::mm", "aten::addmm", "aten::bmm",
                                "aten::baddbmm"):
                    key = "products"
                else:
                    continue
                parts[key] += us
        out = {k: v / 1e3 for k, v in parts.items()}
        out["linked"] = linked / 1e3
        return out

    @contextlib.contextmanager
    def xent_range():
        """``layers.softmax_xent`` inside ``record_function("softmax_xent")``
        (the time split reads it)."""
        saved = train_layers.softmax_xent

        def ranged(*a, **k):
            with torch.profiler.record_function("softmax_xent"):
                return saved(*a, **k)
        train_layers.softmax_xent = ranged
        try:
            yield
        finally:
            train_layers.softmax_xent = saved

    def qwen2_train():
        """15b: Qwen2-1.5B at full width and depth, float32 masters drawn
        from MODEL_SEED, bf16 compute, remat "nothing": TRAIN_WARM
        warm-up steps, then TRAIN_STEPS timed steps of make_train_step on
        TRAIN_B x TRAIN_T tokens, each checked for finite losses and its
        K15 and K16 launches; ms a step, tokens/s, peak memory; then a
        traced step's busy share and its device time split."""
        cfg = model_config(registry.get_config)
        model = registry.build(cfg, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = train_rt.init_state(model, MODEL_SEED)
        torch.cuda.synchronize()
        log(f"{cfg.name} train state: {model.param_count() / 1e9:.4f} B "
            "float32 masters with AdamW's m and v, "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB on the card")
        tcfg = train_rt.TrainConfig(optimizer=AdamWConfig(lr=3e-4),
                                    remat_policy="nothing", warmup_steps=2,
                                    total_steps=100)
        step = train_rt.make_train_step(model, tcfg)
        source = data_lib.SyntheticLM(data_lib.DataConfig(
            vocab=cfg.vocab, seq_len=TRAIN_T, global_batch=TRAIN_B,
            seed=MODEL_SEED))
        want = train_counts(cfg)
        n = 0
        walls, losses = [], []

        def one():
            nonlocal state, n
            batch = source.batch(n)
            n += 1
            torch.cuda.synchronize()
            tlib.reset_launches()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            loss = float(met["loss"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(tlib.launches)
            assert math.isfinite(loss), f"step {n - 1}: loss {loss}"
            assert counts == want, (counts, want)
            return wall, loss, met
        for _ in range(TRAIN_WARM):
            one()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(TRAIN_STEPS):
            wall, loss, met = one()
            walls.append(wall)
            losses.append(loss)
        peak = torch.cuda.max_memory_allocated()
        tf_launches[f"train/{cfg.name}"] = want
        ms = statistics.median(walls) * 1e3
        log(f"15b {cfg.name} train step at {TRAIN_B} x {TRAIN_T} tokens, "
            f"bf16, remat 'nothing': {[round(w * 1e3, 1) for w in walls]} ms "
            f"(median {ms:.1f} ms, {TRAIN_B * TRAIN_T / ms * 1e3:.0f} "
            f"tokens/s), losses {[round(x, 4) for x in losses]}, grad_norm "
            f"{float(met['grad_norm']):.4g}, lr {float(met['lr']):.3g}, peak "
            f"{peak / 1e9:.2f} GB, launches a step {want}  on {card}")
        out: dict = {}

        def traced_step():
            # a traced step's own failure (a loss not finite, other
            # launches, a device fault) fails the phase: only the
            # profiler's own may pass as "not measured"
            try:
                one()
            except Exception as e:
                raise StepFailed(f"a traced train step: {e!r}") from e
        try:
            with xent_range():
                events, wall_us = trace_window(
                    torch, traced_step, traced_step,
                    on_trace=lambda p: out.update(split=train_split(p)))
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"15b time split not measured (profiler: {e})")
        else:
            busy = sum(us for _k, us in events) / 1e3
            s = out["split"]
            rest = busy - sum(v for k, v in s.items() if k != "linked")
            log(f"15b a traced train step: wall {wall_us / 1e3:.1f} ms, "
                f"device busy {busy:.1f} ms ({100 * busy * 1e3 / wall_us:.1f}"
                f" %), {len(events)} device activities: products "
                f"{s['products']:.1f}, K15 forward {s['k15']:.1f}, K16 "
                f"{s['k16']:.1f}, the plain attention backward "
                f"{s['attention_backward']:.1f}, AdamW {s['adamw']:.1f}, the "
                f"cross-entropy {s['cross_entropy']:.1f}, the rest "
                f"{rest:.1f} ms ({s['linked']:.1f} ms linked to host ops)  "
                f"on {card}")
            for key, us, cnt in costliest(events, 1, 10):
                log(f"    {us / 1e3:9.3f} ms  x{cnt:<5d} {key}")
        del state
        torch.cuda.empty_cache()

    def gate_step(model, params, batch, tol, what, routing=False,
                  witness=False):
        """Loss and gradients on the kernels, on the plain versions (plain
        autograd) and on the control (the kernels without the Function:
        missing gradients read as zeros), the MoE routing forced to the
        plain run's; the loss within TRAIN_LOSS_TOL relative and every
        leaf's gradient within ``tol`` normwise of plain, the control past
        ``tol``.  ``witness``: plain autograd again on the embedding one
        ulp up (a perturbation of K16's size on no kernel at all), held
        against plain leaf by leaf and printed beside the kernels' reading
        (how far one ulp carries into the gradients; not gated).  Returns
        the loss's and the worst gradient's relative errors, the
        control's, and the kernels' launches."""
        with plain_path(True, ref, **kernels), no_function(), \
                record_routing(transformer) as routes:
            pl_loss, pl, _, _ = grads_of(model, params, batch)
        w_err = None
        if witness:
            emb = params["embed"]
            params["embed"] = torch.nextafter(emb, emb.new_tensor(math.inf))
            try:
                with plain_path(True, ref, **kernels), no_function():
                    w_loss, wg, _, _ = grads_of(model, params, batch)
            finally:
                params["embed"] = emb
            w_err = grad_errors(wg, pl)
            del wg
        with force_routing(transformer, routes) if routing else \
                contextlib.nullcontext():
            k_loss, kg, counts, k_none = grads_of(model, params, batch)
        k_err = grad_errors(kg, pl)
        del kg
        with force_routing(transformer, routes) if routing else \
                contextlib.nullcontext(), no_function():
            _, cg, _, c_none = grads_of(model, params, batch)
        c_err = grad_errors(cg, pl)
        del cg
        rel = abs(float(k_loss) - float(pl_loss)) / abs(float(pl_loss))
        worst = int(np.argmax(k_err))
        names = leaf_paths(params)
        log(f"{what}: loss {float(k_loss):.7g} vs plain {float(pl_loss):.7g}"
            f" ({rel:.3g} relative), {len(k_err)} gradients normwise max "
            f"{max(k_err):.3g} (leaf {worst}, {names[worst]}) mean "
            f"{np.mean(k_err):.3g} (limit {tol}); control (no Function: "
            f"{c_none} of {len(c_err)} gradients missing) max "
            f"{max(c_err):.3g}")
        if w_err is not None:
            w_rel = abs(float(w_loss) - float(pl_loss)) / abs(float(pl_loss))
            w_worst = int(np.argmax(w_err))
            ratio = [k / w if w > 0 else (math.inf if k > 0 else 1.0)
                     for k, w in zip(k_err, w_err)]
            log(f"{what}, the witness (plain on the embedding one ulp up vs "
                f"plain; not gated): loss {w_rel:.3g} relative, gradients "
                f"normwise max {max(w_err):.3g} (leaf {w_worst}, "
                f"{names[w_worst]}) mean {np.mean(w_err):.3g}; kernels over "
                f"witness, leaf by leaf: median {np.median(ratio):.3g}, max "
                f"{max(ratio):.3g} (leaf {int(np.argmax(ratio))}), "
                f"{sum(k > w for k, w in zip(k_err, w_err))} of "
                f"{len(k_err)} leaves above the witness")
            for i in np.argsort(k_err)[::-1][:6]:
                log(f"    leaf {int(i):4d} {names[i]:32s} kernels "
                    f"{k_err[i]:.3g}  witness {w_err[i]:.3g}")
        return rel, max(k_err), max(c_err), counts

    def qwen2_fp32_gate():
        """15c: Qwen2-1.5B at full depth and width in float32 on
        TRAIN_F32_B x TRAIN_T tokens: one loss-and-gradient of the train
        step on the kernels, one on the plain versions; the loss within
        TRAIN_LOSS_TOL, every leaf's gradient within TRAIN_GRAD_TOL
        normwise, the control past it, the one-ulp witness printed beside
        them; then the same readings in bf16, printed, not gated."""
        cfg = model_config(registry.get_config)
        model = registry.build(cfg, device=DEVICE)
        batch = train_batch(cfg, TRAIN_F32_B, TRAIN_T)
        torch.cuda.empty_cache()
        params = model.init_masters(MODEL_SEED)
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            rel, err, c_err, counts = gate_step(
                model, params, batch, TRAIN_GRAD_TOL,
                f"15c {cfg.name} float32 at {TRAIN_F32_B} x {TRAIN_T}",
                witness=True)
        finally:
            layers.COMPUTE_DTYPE = saved
        assert counts == train_counts(cfg), counts
        assert rel <= TRAIN_LOSS_TOL, f"loss {rel:.3g} > {TRAIN_LOSS_TOL}"
        assert err <= TRAIN_GRAD_TOL, f"gradients {err:.3g}"
        if c_err <= TRAIN_GRAD_TOL:
            raise AssertionError(f"the control passes the gate ({c_err:.3g})")
        log(f"15c: the control fails the gate, as it must ({c_err:.3g} > "
            f"{TRAIN_GRAD_TOL})")
        gate_step(model, params, batch, TRAIN_GRAD_TOL,
                  f"15c {cfg.name} bf16 at {TRAIN_F32_B} x {TRAIN_T} (not "
                  "gated)")
        del params
        torch.cuda.empty_cache()

    def family_steps():
        """15d: one train step of each family's smoke model on the card in
        float32, from float32 masters drawn from MODEL_SEED: its loss and
        gradients, kernels against plain, within the model's forward gate
        (FP32_LOGIT_TOL, at the forward gate's draw: WIDTH_DRAW_GATES'
        weight matrices scaled to 1/sqrt(input width), their reading at
        the reference's draw printed first), the control past it (olmoe's
        routing forced to plain's); then make_train_step on the kernels,
        its loss the gate's."""
        saved = layers.COMPUTE_DTYPE
        layers.COMPUTE_DTYPE = torch.float32
        try:
            for arch in TRAIN_FAMILIES:
                cfg = registry.get_config(arch).smoke()
                model = registry.build(cfg, device=DEVICE)
                batch = train_batch(cfg, 2, TRAIN_SMOKE_T)
                params = model.init_masters(MODEL_SEED)
                tol = FP32_LOGIT_TOL[arch]
                what = f"15d {arch} ({cfg.family}) smoke float32"
                if arch in WIDTH_DRAW_GATES:
                    # chaotic at the reference's draw, as its forward:
                    # printed there, gated at the forward gate's draw
                    gate_step(model, params, batch, tol, what + " at the "
                              "reference's draw (not gated)",
                              routing=bool(cfg.moe))
                    for key in model.impl.STACKED:
                        scale_to_width(params[key], len(params[key]))
                    what += " at weights scaled to 1/sqrt(input width)"
                rel, err, c_err, counts = gate_step(
                    model, params, batch, tol, what, routing=bool(cfg.moe))
                assert counts == train_counts(cfg), (arch, counts)
                assert rel <= tol and err <= tol, (arch, rel, err)
                assert c_err > tol, f"{arch}: the control passes ({c_err})"
                state = {"params": params,
                         "opt": train_rt.adamw.init(params)}
                step = train_rt.make_train_step(model, train_rt.TrainConfig(
                    warmup_steps=0, total_steps=10))
                tlib.reset_launches()
                state, met = step(state, batch)
                torch.cuda.synchronize()
                tf_launches[f"train/{arch} smoke"] = dict(tlib.launches)
                assert math.isfinite(float(met["loss"]))
                log(f"15d {arch}: make_train_step loss "
                    f"{float(met['loss']):.7g}, launches "
                    f"{dict(tlib.launches)}")
        finally:
            layers.COMPUTE_DTYPE = saved

    def runtime_on_card():
        """15e: in subprocesses on the card, (1) ``TrainLoop`` at Qwen2's
        smoke config with a failure injected at step 6 against an
        uninterrupted run, under ``torch.use_deterministic_algorithms``
        (the embedding's backward accumulates with atomics otherwise):
        every loss and the final state equal bit for bit; (2) the launcher
        ``python -m repro_torch.launch.train --arch qwen2-1.5b --smoke
        --steps 8`` into a temporary directory."""
        import os
        import tempfile
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUBLAS_WORKSPACE_CONFIG=":4096:8")
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--train-resume", tmp], env=env, capture_output=True,
                text=True, timeout=600)
            log(out.stdout.strip())
            assert out.returncode == 0, out.stderr[-3000:]
            log(f"15e resume: {time.perf_counter() - t0:.1f} s (subprocess)")
            t0 = time.perf_counter()
            cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                   "qwen2-1.5b", "--smoke", "--steps", "8", "--ckpt-dir",
                   str(Path(tmp) / "launch")]
            out = subprocess.run(cmd, env=env, capture_output=True,
                                 text=True, timeout=600)
            log(out.stdout.strip())
            assert out.returncode == 0, out.stderr[-3000:]
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith("{'step'")]
            assert len(lines) == 6 and "device=cuda" in out.stdout, lines
            log(f"15e launcher: {' '.join(cmd[1:])}: exit 0 in "
                f"{time.perf_counter() - t0:.1f} s")

    phase("15a the gradient's Function on the card", functions_on_card)
    phase("15b Qwen2-1.5B train steps at full width", qwen2_train)
    phase("15c Qwen2-1.5B float32 gradient gate", qwen2_fp32_gate)
    phase("15d one train step a family", family_steps)
    phase("15e the runtime on the card", runtime_on_card)
    torch.cuda.empty_cache()

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
            if name == "adaptive_fir" and p != DSP_PARAM[name]:
                key += f"_k{p}"
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
            if name == "flash_attention" and "d96" in ctx:
                # phi3-mini-3.8b's prefill at head dim 96 (13a)
                t = ctx["d96"]
                row.update({f"{k}_d96_prefill": v for k, v in t.items()})
                extra += (f"; D 96 prefill {t['shape']}: "
                          f"kernel {t['ms']} ms on the device, "
                          f"{t['call_ms']:.4f} ms a call, bound "
                          f"{t['bound_ms']:.4f} ms, SDPA "
                          f"{t['library_ms']:.4f} ms")
            if name == "flash_attention" and "d64" in ctx:
                # whisper-base's three calls at head dim 64 (14a), by label
                for label, t in ctx["d64"].items():
                    row.update({f"{k}_d64_{label}": v for k, v in t.items()})
                    extra += (f"; D 64 {label} {t['shape']}: kernel "
                              f"{t['ms']} ms on the device, "
                              f"{t['call_ms']:.4f} ms a call, bound "
                              f"{t['bound_ms']:.4f} ms, SDPA "
                              f"{t['library_ms']:.4f} ms")
            if name == "rmsnorm" and "r512" in ctx:
                # whisper-base's encoder rows at width 512 (14a)
                t = ctx["r512"]
                key = "x".join(map(str, t["shape"]))
                row.update({f"{k}_{key}": v for k, v in t.items()
                            if k != "shape"})
                extra += (f"; at {key} (whisper-base): kernel {t['ms']} ms "
                          f"on the device, library {t['library_ms']:.4f} ms, "
                          f"bound {t['bound_ms']:.4f} ms")
            if name == "flash_attention" and "d256" in ctx:
                # paligemma-3b's calls at head dim 256 (12a), by label
                for label, t in ctx["d256"].items():
                    row.update({f"{k}_d256_{label}": v for k, v in t.items()})
                    sdpa = (None if t["library_ms"] is None
                            else round(t["library_ms"], 4))
                    extra += (f"; D 256 {label} {t['shape']}: kernel "
                              f"{t['ms']} ms on the device, {t['call_ms']:.4f}"
                              f" ms a call, bound {t['bound_ms']:.4f} ms, "
                              f"SDPA {sdpa} ms")
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
