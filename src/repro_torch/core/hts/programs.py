"""Benchmark program library (paper §VI-C), written against the
Program Builder (:mod:`builder`) — no hand-assembled hex anywhere.

Each generator constructs a :class:`builder.Program` (tasks, regions,
structured loops/branches) and wraps its lowering in a :class:`Bench` for
the benchmark drivers; region placement and branch steering memory images
(``mem_init``/``effects``) come from the builder's region allocator instead
of manual ``OUT_BASE + i * RSTRIDE`` arithmetic.

The nine custom benchmarks match the paper's list:
  1. no_dependency           5. loop_no_dependency    8. branch_not_taken_no_dep
  2. same_dependency         6. loop_dependency       9. branch_taken_dependency
  3. diff_dependency         7. branch_taken_no_dep
  4. random_dependency

plus the real application: audio compression (Algorithm 1), with
time-domain (branch-taken) / frequency-domain (branch-not-taken) variants and
a ``bands`` hyper-parameter for the Fig-10 strong-scaling sweep.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .builder import Program

OUT_BASE = 0x100      # historical region-space origin (builder default)
RSTRIDE = 0x8         # historical region stride (builder default alignment)
INPUT = 0x10          # shared input frame address
INPUT_WORDS = 4

#: the paper's task mix (Table II keynames) used round-robin by the synthetic
#: benchmarks — mirrors the §V-B example listing.
MIX = ("real_fir", "complex_fir", "adaptive_fir", "vector_dot", "iir",
       "vector_add", "vector_max", "fft_256", "dct", "correlation")


@dataclasses.dataclass
class Bench:
    """A built benchmark: assembly text + memory images, plus the source
    :class:`Program` for graph-level operations (e.g. interleaving)."""
    name: str
    asm: str
    mem_init: dict[int, int]
    effects: dict[int, int]
    n_tasks_hint: int = 0   # static task count (0 if loop/branch dependent)
    program: Program | None = None
    policy: object | None = None   # SchedPolicy riding along (hts.run default)

    @classmethod
    def of(cls, p: Program) -> "Bench":
        built = p.build()
        return cls(p.name, built.asm, built.mem_init, built.effects,
                   built.n_tasks_hint, p, built.policy)


def _mix_program(name: str) -> tuple[Program, "object"]:
    p = Program(name)
    return p, p.input(INPUT, INPUT_WORDS, "frame")


def no_dependency(n: int = 20) -> Bench:
    """Independent tasks: every task reads the shared input, writes its own region."""
    p, frame = _mix_program("no_dependency")
    for i in range(n):
        p.task(MIX[i % len(MIX)], in_=frame, out=4, tid=i)
    return Bench.of(p)


def same_dependency(chains: int = 4, depth: int = 5) -> Bench:
    """Chains of RAW-dependent tasks, every task mapped to the SAME function."""
    p, frame = _mix_program("same_dependency")
    for c in range(chains):
        func = MIX[c % len(MIX)]
        prev = frame
        for d in range(depth):
            prev = p.task(func, in_=prev, out=4, in_size=4, tid=d)
    return Bench.of(p)


def diff_dependency(chains: int = 4, depth: int = 5) -> Bench:
    """Chains of RAW-dependent tasks mapped to DIFFERENT functions."""
    p, frame = _mix_program("diff_dependency")
    k = 0
    for c in range(chains):
        prev = frame
        for d in range(depth):
            prev = p.task(MIX[k % len(MIX)], in_=prev, out=4, in_size=4,
                          tid=d)
            k += 1
    return Bench.of(p)


def random_dependency(n: int = 24, seed: int = 0, p_dep: float = 0.5) -> Bench:
    """Random DAG: each task reads a random earlier task's output w.p. ``p_dep``."""
    rng = np.random.default_rng(seed)
    p, frame = _mix_program("random_dependency")
    handles = []
    for i in range(n):
        if i > 0 and rng.random() < p_dep:
            src = handles[int(rng.integers(0, i))]
        else:
            src = frame
        func = MIX[int(rng.integers(0, len(MIX)))]
        handles.append(p.task(func, in_=src, out=4, in_size=4, tid=i))
    return Bench.of(p)


def loop_no_dependency(iters: int = 8, body: int = 3) -> Bench:
    """One loop; iterations write disjoint regions via indirect addressing."""
    p, frame = _mix_program("loop_no_dependency")
    w = p.walker(stride=body * RSTRIDE, count=iters, name="out")
    with p.loop(iters):
        for j in range(body):
            p.task(MIX[j % len(MIX)], in_=frame,
                   out=w if j == 0 else w.offset(j * RSTRIDE),
                   out_size=4, tid=j)
        w.advance()
    return Bench.of(p)


def loop_dependency(iters: int = 8) -> Bench:
    """A pre-loop task produces data every iteration consumes (paper: 'dependency
    of the loop iteration on one or more outside tasks')."""
    p, frame = _mix_program("loop_dependency")
    pre = p.task("fft_256", in_=frame, out=4, tid=0)    # long-latency producer
    w = p.walker(stride=RSTRIDE, count=iters, name="out")
    with p.loop(iters):
        p.task("iir", in_=pre, out=w, out_size=4, tid=1)
        w.advance()
    return Bench.of(p)


def _branch_bench(name: str, taken: bool, kind: str, n_each: int = 6) -> Bench:
    """Shared skeleton for the three branch benchmarks.

    Layout:   [optional producer task]
              if <region> → taken block
              <not-taken block: n_each tasks>     (speculated path)
              <taken block: n_each tasks>
              vector_max join
    """
    p, frame = _mix_program(name)
    thr = p.let(5, "thr")
    cond = p.region(1, name="cond")
    if kind == "bus":
        # producer the branch waits on (Bus-Read)
        p.task("correlation", in_=frame, out=cond, tid=0)
        cond.effect(9 if taken else 1)
    else:
        cond.init(9 if taken else 1)
    br = p.branch(on=cond, cond=">=", thr=thr, kind=kind)
    with br.not_taken():                 # fall-through, speculated path
        for i in range(n_each):
            p.task(MIX[i % len(MIX)], in_=frame, out=4, tid=i)
    with br.taken():
        for i in range(n_each):
            p.task(MIX[(i + 3) % len(MIX)], in_=frame, out=4, tid=i)
    p.task("vector_max", in_=frame, out=1, tid=0xF)
    return Bench.of(p)


def branch_taken_no_dep(n_each: int = 6) -> Bench:
    return _branch_bench("branch_taken_no_dep", True, "mem", n_each)


def branch_not_taken_no_dep(n_each: int = 6) -> Bench:
    return _branch_bench("branch_not_taken_no_dep", False, "mem", n_each)


def branch_taken_dependency(n_each: int = 6) -> Bench:
    return _branch_bench("branch_taken_dependency", True, "bus", n_each)


BAND_WORDS = 0x20      # per-band region footprint of the audio pipeline


def audio_compression(bands: int = 8, time_domain: bool = False) -> Bench:
    """Algorithm 1: correlate; if correlated ≥ threshold → per-band FIR×3
    (time domain) else per-band FFT→VecDot×3→iFFT (frequency domain).

    Branch kind: BR (the condition value is produced by the correlation task).
    Speculation predicts not-taken = frequency domain, so ``time_domain=True``
    is the mis-speculated variant (paper Fig 9 'BT').

    Both arms process the same band span (only one arm ever runs), so the
    per-band space is allocated once and walked by each arm's own pointer.
    """
    p = Program(f"audio_compression_{'bt' if time_domain else 'bnt'}")
    frame = p.input(INPUT, INPUT_WORDS, "audio")
    corr = p.task("correlation", in_=frame, out=1, tid=0)   # "Correlate audio"
    corr.out.effect(9 if time_domain else 1)
    thr = p.let(5, "thr")
    bandspace = p.region(bands * BAND_WORDS, name="bands")

    br = p.branch(on=corr.out, cond=">=", thr=thr, kind="bus")
    with br.not_taken():
        # ---- frequency domain (fall-through / speculated path) ----
        w = p.walker(start=bandspace.addr, stride=BAND_WORDS, name="band")
        with p.loop(bands):
            fft_o = w.offset(0x8)
            dot_o = w.offset(0x10)
            ifft_o = w.offset(0x18)
            p.task("fft_256", in_=w, out=fft_o, in_size=4, out_size=4, tid=1)
            for j in range(3):
                p.task("vector_dot", in_=fft_o, out=dot_o, in_size=4,
                       out_size=1, tid=2 + j)
            p.task("fft_256", in_=dot_o, out=ifft_o, in_size=4, out_size=4,
                   tid=5)
            w.advance()
    with br.taken():
        # ---- time domain ----
        w = p.walker(start=bandspace.addr, stride=BAND_WORDS, name="band")
        with p.loop(bands):
            outs = [w.offset(k) for k in (0x8, 0x10, 0x18)]
            for j, o in enumerate(outs):
                p.task("real_fir", in_=w, out=o, in_size=4, out_size=4,
                       tid=1 + j)
            w.advance()
    return Bench.of(p)


# ---------------------------------------------------------------------------
# multi-application pair (the paper's abstract motivation): a second real
# application interleaved with the audio stream under one HTS — formerly
# core/hts/multiapp.py, superseded by Program.merge for the general case
# ---------------------------------------------------------------------------
IMG_BASE = 0x800        # image app's region space (disjoint from audio's)
TILE_WORDS = 0x20


def image_compression(tiles: int = 8) -> Bench:
    """Per 8×8 tile: DCT → vector_max (quantization range proxy) →
    correlation (inter-tile prediction) → vector_add (residual).
    Straight-line (unrolled), pid=1 — the DCT-heavy complement to the
    FIR/FFT-heavy audio mix (Fig 2's image-processing example)."""
    p = Program("image_compression", region_base=IMG_BASE)
    with p.process(1):
        prev = None
        for t in range(tiles):
            tile = p.region(TILE_WORDS, align=TILE_WORDS, name=f"tile{t}")
            dct = p.task("dct", in_=tile.sub(0x0, 8), out=tile.sub(0x8, 8),
                         tid=t)
            p.task("vector_max", in_=dct, out=tile.sub(0x10, 1), tid=t)
            if prev is not None:
                p.task("correlation", in_=dct, out=tile.sub(0x11, 1), tid=t)
            p.task("vector_add", in_=dct, out=tile.sub(0x18, 8), tid=t)
            prev = dct
    return Bench.of(p)


def audio_straightline(bands: int = 8) -> Bench:
    """Unrolled audio compression, frequency-domain path (pid=0) — the
    loop-free variant used for multi-application sharing studies (merge it
    with :func:`image_compression` via ``Program.merge``)."""
    p = Program("audio_straightline")
    frame = p.input(INPUT, INPUT_WORDS, "audio")
    p.task("correlation", in_=frame, out=1, tid=0)
    for b in range(bands):
        band = p.region(TILE_WORDS, align=TILE_WORDS, name=f"band{b}")
        fft = p.task("fft_256", in_=band.sub(0x0, 4), out=band.sub(0x8, 4),
                     tid=1)
        for j in range(3):
            p.task("vector_dot", in_=fft, out=band.sub(0x10 + j, 1),
                   tid=2 + j)
        p.task("fft_256", in_=band.sub(0x10, 4), out=band.sub(0x18, 4),
               tid=5)
    return Bench.of(p)


SYNTHETIC_NO_BRANCH = (no_dependency, same_dependency, diff_dependency,
                       random_dependency, loop_no_dependency, loop_dependency)
SYNTHETIC_BRANCH = (branch_taken_no_dep, branch_not_taken_no_dep,
                    branch_taken_dependency)
ALL_SYNTHETIC = SYNTHETIC_NO_BRANCH + SYNTHETIC_BRANCH


def all_benches() -> list[Bench]:
    return [g() for g in ALL_SYNTHETIC] + [
        audio_compression(8, False), audio_compression(8, True)]


def merge_benches(benches, name: str = "shared", **merge_kwargs) -> Bench:
    """N-way :meth:`builder.Program.merge` of builder-backed benches (N CPUs
    pushing into the one Task Queue; pids distinguish the owners) —
    performed on the program graphs, not on assembly text."""
    benches = list(benches)
    if any(b.program is None for b in benches):
        raise ValueError("merge needs builder-backed Bench objects")
    return Bench.of(Program.merge([b.program for b in benches], name,
                                  **merge_kwargs))
