#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It builds the kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, started together) and drives the port's two paths on the card —
the population scheduler machine through ``run_many``, and the audio
pipeline, whose schedule runs the DSP kernels — then checks them:

1. device and build: the card's name and power limit, the two kernel
   libraries' builds (time and ``-Xptxas -v`` report);
2. kernels against plain: for the first 64 trips of the main-path
   population, and 64 trips from the middle of its run, every K1–K4 launch
   is checked against its plain torch version on a clone of the same carry
   (``torch.equal`` on every state array: the machine is int32/bool, the
   tolerance is zero); the run carries on from the kernel's result;
3. main path: ``run_many`` on 1024 lanes at ``HtsParams()`` defaults,
   ``hts_spec``, ``n_fu=2``, event-skip on, over ``generate_scenario(seed)``
   for seeds 0..1023 (mixed priority / per-tenant frontends with arrivals /
   heterogeneous units / plain, by ``seed % 4``).  Every lane must halt
   without overflow, each kernel's launch count must equal the host loop's
   trips, and every 8th lane must match the golden oracle's cycles and
   schedule;
4. single lane: ``run`` on every paper bench under ``naive`` and
   ``hts_spec``, each against golden;
5. kernel times: each step kernel and its plain version timed with CUDA
   events on a mid-run carry of the main-path population, beside its
   bound;
6a. DSP kernels against plain: K5 ``real_fir``, K9 ``vector_dot``, K12
   ``correlation`` and K13 ``fft`` at the pipeline's shape (65536 frames
   of 256 samples, 8 taps, lag 4) and at ragged edge shapes, within the
   reference tests' tolerances (1e-5; 1e-3 for the FFT);
6b. audio pipeline: ``audio_compression(8)``, both arms, scheduled on the
   card (equal to golden in cycles and schedule) and executed through
   ``run_pipeline`` on 65536 × 256 float32 frames; each DSP kernel must
   launch once per live task of its function, and the output must be
   finite and within 1e-3 of the same tasks run through the plain table;
5b. DSP kernel times: device, call, plain and library times at the
   pipeline's shape, beside the bound.

The last lines are the card (``nvidia-smi``), one JSON object
``{"kernels": [...]}`` (all eight kernels), and ``{"ok": true, "device":
{...}}``.  Any failed
phase exits non-zero without the last line; so does a machine without a
card, or a directory without the rest of the repository.
"""
from __future__ import annotations

import functools
import json
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

# the audio pipeline's DSP kernels (csrc/dsp.cu), by launch counter
DSP_SOURCE = "src/repro_torch/csrc/dsp.cu"
DSP_REPLACES = {
    "real_fir": "src/repro/kernels/dsp_fir.py:49",
    "vector_dot": "src/repro/kernels/dsp_vector.py:22",
    "correlation": "src/repro/kernels/dsp_vector.py:83",
    "fft": "src/repro/kernels/dsp_spectral.py:78",
}
#: 1024 audio channels × 64 frames of 256 samples (64 MiB of float32,
#: beyond the 50 MB L2), the pipeline's 8 FIR taps and lag 4
FRAMES, SAMPLES, TAPS, MAX_LAG = 65536, 256, 8, 4
BANDS = 8
PIPELINE_SEED = 2019
DSP_TOL = {"real_fir": 1e-5, "vector_dot": 1e-5, "correlation": 1e-5,
           "fft": 1e-3}
PIPELINE_TOL = 1e-3
EXEC_REPS = 5          # timed executions of each schedule (median kept)
#: (B, N, taps or lag) per kernel: the pipeline's shape, then ragged edges
DSP_CASES = {
    "real_fir": [(FRAMES, SAMPLES, TAPS), (1, 40, 8), (300, 40, 5),
                 (300, 256, 8)],
    "vector_dot": [(FRAMES, SAMPLES, None), (1, 40, None), (300, 40, None),
                   (300, 256, None)],
    "correlation": [(FRAMES, SAMPLES, MAX_LAG), (1, 40, 4), (300, 40, 10),
                    (300, 256, 4)],
    "fft": [(FRAMES, SAMPLES, None), (1, 256, None), (300, 256, None),
            (300, 64, None)],
}
#: live tasks per DSP kernel in the 8-band audio schedules, by time_domain
LIVE_8_BANDS = {False: {"correlation": 1, "fft": 16, "vector_dot": 24},
                True: {"correlation": 1, "real_fir": 24}}


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


def profiled_ms(torch, calls, kernel: str, warm=3):
    """Mean device time per launch of ``kernel`` over ``calls`` after the
    first ``warm`` (torch.profiler's CUPTI trace); None when the profiler
    or its trace has no device time."""
    from torch.profiler import ProfilerActivity, profile
    for c in calls[:warm]:
        c()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for c in calls[warm:]:
                c()
            torch.cuda.synchronize()
    except (RuntimeError, AssertionError, AttributeError) as e:
        log(f"profiler unavailable ({e}): device time not measured")
        return None
    times = [us for key, us in device_events(prof) if kernel in key]
    return sum(times) / len(times) / 1e3 if times else None


def device_events(prof):
    """(name, µs) of every device-side activity in a profile: kernels,
    copies and sets.  Counting these, and not the host ops that launched
    them, counts each microsecond of device work once."""
    from torch.autograd import DeviceType
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


def trip_profile(torch, machine, m, st, a, trips=32):
    """Where a trip's time goes, over ``trips`` steps of a mid-run carry:
    wall per trip, device busy time per trip, device activities per trip,
    and the costliest kernels."""
    from torch.profiler import ProfilerActivity, profile
    limit = torch.full_like(st["steps"], machine.BIG)
    for _ in range(4):
        machine.step(m, st, a, limit)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(trips):
            machine.step(m, st, a, limit)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = device_events(prof)
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
# the DSP kernels (K5, K9, K12, K13) and the audio pipeline
# ---------------------------------------------------------------------------
def dsp_case(torch, kern, name, b, n, p, seed):
    """(wrapper, plain version, args) of one call of DSP kernel ``name`` on
    float32 frames made from ``seed``; ``p`` is the FIR's tap count or the
    correlation's lag.  ``kern`` holds the port's kernel modules."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                                ).to(DEVICE)

    ref = kern["ref"]
    if name == "real_fir":
        return kern["fir"].real_fir, ref.real_fir, (f(b, n), f(p))
    if name == "vector_dot":
        return kern["vec"].vector_dot, ref.vector_dot, (f(b, n), f(b, n))
    if name == "correlation":
        return (kern["vec"].correlation, ref.correlation,
                (f(b, n), f(b, n), p))
    return kern["spec"].fft, ref.fft, (f(b, n, 2),)


def dsp_bound(name, args):
    """Least time for the function on these inputs: each input byte read
    once and each output byte written once at HBM bandwidth, against the
    flops these inputs need (zero-fill terms not counted) at the fp32 rate
    outside the tensor cores; the larger, and which one it is."""
    if name == "real_fir":
        x, h = args
        (B, N), K = x.shape, h.shape[0]
        nbytes = 4 * (2 * B * N + K)
        ops = B * sum(2 * min(K, i + 1) - 1 for i in range(N))
    elif name == "vector_dot":
        x, _y = args
        B, N = x.shape
        nbytes = 4 * (2 * B * N + B)
        ops = B * (2 * N - 1)
    elif name == "correlation":
        x, _y, L = args
        B, N = x.shape
        nbytes = 4 * (2 * B * N + B * (2 * L + 1))
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


def library_call(torch, name, args):
    """One PyTorch call that computes the same function on the same
    inputs: the yardstick, timed here and used nowhere in the port."""
    F = torch.nn.functional
    if name == "real_fir":
        x, h = args
        K, N = h.shape[0], x.shape[1]
        w = h.flip(0).view(1, 1, K)
        return lambda: F.conv1d(x[:, None], w, padding=K - 1)[:, 0, :N]
    if name == "vector_dot":
        x, y = args
        return lambda: torch.linalg.vecdot(x, y)
    if name == "correlation":
        x, y, L = args
        w = x[:, None, :]
        return lambda: F.conv1d(y[None], w, padding=L, groups=x.shape[0])[0]
    (x,) = args
    return lambda: torch.view_as_real(torch.fft.fft(torch.view_as_complex(x)))


def max_err(got, want) -> float:
    return float((got - want).abs().max()) if got.numel() else 0.0


def main() -> int:
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
        from repro_torch.core.hts import (api, batch, costs, cuda_step,
                                          machine, programs, workloads)
        from repro_torch.examples import dsp_pipeline
        from repro_torch.kernels import common as dsp
        from repro_torch.kernels import (dsp_fir, dsp_spectral, dsp_vector,
                                         ops, ref)
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

    # 1. build: one nvcc per source, started together ----------------------
    def build():
        libs = (cuda_step.LIB, dsp.LIB)
        with ThreadPoolExecutor(len(libs)) as pool:
            paths = list(pool.map(lambda lib: lib.build(), libs))
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
    pop, spec = ctx["pop"], ctx["spec"]
    checker = CheckedOps(torch, cuda_step)

    def checked(carry, trips):
        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        a = machine.norm_args(m, *pop.machine_args())
        st = {k: v.clone() for k, v in carry.items()}
        limit = torch.full_like(st["steps"], machine.BIG)
        for _ in range(trips):
            machine.step(m, st, a, limit, ops=checker)
        torch.cuda.synchronize()
        return st

    # 2a. the first trips, checked (also warms the card up) ----------------
    def check_first():
        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        st = checked(m.init(*pop.machine_args()), CHECK_TRIPS)
        log(f"trips 0..{CHECK_TRIPS - 1}: {checker.checks} kernel launches "
            "equal to their plain versions")
    phase("2a kernels vs plain, first trips", check_first)

    # 3. main path ----------------------------------------------------------
    def main_path():
        cuda_step.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = api.run_many(pop, scheduler="hts_spec", device=DEVICE,
                         check=False)
        wall = time.perf_counter() - t0
        counts = dict(cuda_step.launches)
        ctx.update(result=r, counts=counts, wall=wall)
        overflow = int(r.raw["overflow"].sum())
        log(f"lanes {len(r)}  halted {int(r.halted.sum())}  overflow "
            f"{overflow}  trips {r.trips}  max steps {int(r.steps.max())}")
        log(f"launch counts {counts}")
        log(f"main path wall {wall:.3f} s  {wall / r.trips * 1e3:.3f} ms/trip"
            f"  {LANES / wall:.1f} scenarios/s  on {card}")
        assert r.all_halted and overflow == 0, "a lane did not halt"
        for k, v in counts.items():
            assert v == r.trips, f"{k} launched {v} times in {r.trips} trips"
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
            "plain versions")
    if "result" in ctx:
        phase("2b kernels vs plain, middle trips", check_middle)

    # 4. single lane ---------------------------------------------------------
    def single_lane():
        n = 0
        for sched in ("naive", "hts_spec"):
            for b in programs.all_benches():
                mine = api.run(b, scheduler=sched, device=DEVICE)
                g = api.run(b, scheduler=sched, backend="golden")
                assert mine.cycles == g.cycles and \
                    mine.schedule_tuple() == g.schedule_tuple(), \
                    f"{b.name} under {sched} differs from golden"
                n += 1
        log(f"{n} single-lane runs equal to golden")
    phase("4 single lane", single_lane)

    # 5. kernel times --------------------------------------------------------
    rows = []

    def kernel_times():
        counts = ctx.get("counts", {})
        for name, (wrapper, plain, _keys) in cuda_step.KERNELS.items():
            saved = checker.saved[name]
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
                replaces=REPLACES[name], launches=counts.get(name, 0),
                max_abs_err=checker.max_err[name],
                ms=k_dev if k_dev is not None else k_call,
                kernel_ms=k_dev if k_dev is not None else k_call,
                call_ms=k_call, plain_ms=p_call, bound_ms=bound,
                bound_by=by, library_ms=None))
            dev = "not measured" if k_dev is None else f"{k_dev:.4f} ms"
            log(f"{name:8s} kernel {dev} on the device, {k_call:.4f} ms per "
                f"call  plain {p_call:.4f} ms per call  bound {bound:.6f} ms "
                f"({by})  on {card}")

        m = machine.make_machine(spec, pop.max_prog, DEVICE)
        a = machine.norm_args(m, *pop.machine_args())
        st = {k: v.clone() for k, v in ctx["mid_state"].items()}
        try:
            wall, busy, launches, top = trip_profile(torch, machine, m, st, a)
        except (RuntimeError, AssertionError, AttributeError) as e:
            log(f"trip profile not measured (profiler unavailable: {e})")
            return
        log(f"trip profile (mid-run, 32 trips): {wall / 1e3:.3f} ms wall per "
            f"trip, device busy {busy / 1e3:.3f} ms per trip "
            f"({100 * busy / wall:.1f} %), {launches:.0f} device activities "
            f"(kernels, copies, sets) per trip  on {card}")
        for key, us, cnt in top:
            log(f"    {us:9.1f} us/trip  x{cnt:<4d} {key}")

    if "mid_state" in ctx:
        phase("5 kernel times", kernel_times)

    kern = dict(fir=dsp_fir, vec=dsp_vector, spec=dsp_spectral, ref=ref)
    dsp_err = {k: 0.0 for k in dsp.launches}

    # 6a. DSP kernels against their plain versions -------------------------
    def dsp_vs_plain():
        for name, cases in DSP_CASES.items():
            for i, (b, n, p) in enumerate(cases):
                wrapper, plain, args = dsp_case(torch, kern, name, b, n, p, i)
                got, want = wrapper(*args), plain(*args)
                torch.cuda.synchronize()
                err = max_err(got, want)
                dsp_err[name] = max(dsp_err[name], err)
                tol = DSP_TOL[name]
                assert got.shape == want.shape and torch.allclose(
                    got, want, rtol=tol, atol=tol), \
                    f"{name} at B={b} N={n} differs from plain (max abs " \
                    f"err {err:.3g}, tolerance {tol})"
                log(f"{name:11s} B={b:<6d} N={n:<4d} p={p}  max abs err "
                    f"{err:.3g} (tolerance {tol})")
        # rows 4 bytes past a 16-byte boundary: vector_dot's scalar loads
        x = dsp_case(torch, kern, "vector_dot", 1, 300 * 256 + 1, None,
                     9)[2][0][0, 1:].view(300, 256)
        got, want = dsp_vector.vector_dot(x, x), ref.vector_dot(x, x)
        err = max_err(got, want)
        dsp_err["vector_dot"] = max(dsp_err["vector_dot"], err)
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), \
            f"vector_dot on unaligned rows: max abs err {err:.3g}"
        log(f"vector_dot  B=300    N=256  unaligned rows  max abs err "
            f"{err:.3g}")
    phase("6a DSP kernels vs plain", dsp_vs_plain)

    # 6b. the audio pipeline: schedule on the card, DSP kernels execute it --
    def audio_pipeline():
        rng = np.random.default_rng(PIPELINE_SEED)
        x = torch.from_numpy(rng.standard_normal(
            (FRAMES, SAMPLES), dtype=np.float32)).to(DEVICE)
        total = {k: 0 for k in dsp.launches}
        for td in (False, True):
            bench = programs.audio_compression(BANDS, time_domain=td)
            g = api.run(bench, scheduler="hts_spec", n_fu=2,
                        backend="golden")
            dsp.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r, executed, out = dsp_pipeline.run_pipeline(bench, x,
                                                         device=DEVICE)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(dsp.launches)
            assert r.cycles == g.cycles and \
                r.schedule_tuple() == g.schedule_tuple(), \
                f"{bench.name}: the card's schedule differs from golden"
            live = {k: 0 for k in counts}
            for _uid, fname in executed:
                live["fft" if fname == "fft_256" else fname] += 1
            assert counts == live, \
                f"{bench.name}: launches {counts} != live tasks {live}"
            assert {k: v for k, v in live.items() if v} == LIVE_8_BANDS[td]
            for k, v in counts.items():
                total[k] += v
            tasks = dsp_pipeline.issued_tasks(r)
            table = ops.dsp_dispatch_table()
            walls = []
            for _ in range(EXEC_REPS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                again = dsp_pipeline.execute(tasks, x, table)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            exec_s = sorted(walls)[EXEC_REPS // 2]
            plain = dsp_pipeline.execute(tasks, x, ops.plain_dispatch_table())
            err = max_err(out, plain)
            assert bool(torch.isfinite(out).all()), "output not finite"
            assert torch.allclose(out, plain, rtol=PIPELINE_TOL,
                                  atol=PIPELINE_TOL), \
                f"{bench.name}: output differs from the plain pipeline " \
                f"(max abs err {err:.3g})"
            assert torch.equal(again, out), "the kernels are not repeatable"
            log(f"{bench.name}: {r.cycles} cycles = golden, "
                f"{len(executed)} tasks executed, launches {counts}, "
                f"max abs err vs plain {err:.3g} (tolerance {PIPELINE_TOL})")
            log(f"{bench.name}: run_pipeline {wall:.3f} s (schedule + "
                f"execute); executed schedule, median of {EXEC_REPS}: "
                f"{exec_s * 1e3:.3f} ms (min {min(walls) * 1e3:.3f}, max "
                f"{max(walls) * 1e3:.3f}), {FRAMES / exec_s:.0f} frames/s, "
                f"{FRAMES * SAMPLES / exec_s:.4g} samples/s  on {card}")
            try:
                from torch.profiler import ProfilerActivity, profile
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    dsp_pipeline.execute(tasks, x, table)
                    torch.cuda.synchronize()
                    wall_us = (time.perf_counter() - t0) * 1e6
            except (RuntimeError, AssertionError, AttributeError) as e:
                log(f"pipeline profile not measured (profiler: {e})")
                continue
            events = device_events(prof)
            busy = sum(us for _k, us in events)
            log(f"{bench.name}: profiled execution {wall_us / 1e3:.3f} ms "
                f"wall, device busy {busy / 1e3:.3f} ms "
                f"({100 * busy / wall_us:.1f} % of the profiled wall, "
                f"{100 * busy / (exec_s * 1e6):.1f} % of the unprofiled "
                f"median), {len(events)} device activities  on {card}")
            for key, us, cnt in costliest(events):
                log(f"    {us:9.1f} us  x{cnt:<4d} {key}  on {card}")
        ctx["dsp_launches"] = total
        log(f"DSP launches on the pipeline (both arms) {total}")
    phase("6b audio pipeline", audio_pipeline)

    # 5b. DSP kernel times at the pipeline's shape --------------------------
    def dsp_times():
        launches = ctx.get("dsp_launches", {})
        lags = {"real_fir": TAPS, "correlation": MAX_LAG}
        for i, name in enumerate(dsp.launches):
            wrapper, plain, args = dsp_case(torch, kern, name, FRAMES,
                                            SAMPLES, lags.get(name), 100 + i)
            got = wrapper(*args)
            bound, by = dsp_bound(name, args)
            calls = [functools.partial(wrapper, *args)] * 23
            k_call = events_ms(torch, calls)
            p_call = events_ms(torch, [functools.partial(plain, *args)] * 8)
            k_dev = profiled_ms(torch, calls, f"{name}_kernel")
            lib, lib_note = None, ""
            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                call = library_call(torch, name, args)
                lib_err = max_err(call(), got)
                lib = events_ms(torch, [call] * 23)
                lib_note = f" (max abs diff from the kernel {lib_err:.3g})"
            except RuntimeError as e:
                lib_note = f" (library call failed: {e})"
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            rows.append(dict(
                name=name, route="cuda", source=DSP_SOURCE,
                replaces=DSP_REPLACES[name], launches=launches.get(name, 0),
                max_abs_err=dsp_err[name],
                ms=k_dev if k_dev is not None else k_call,
                kernel_ms=k_dev if k_dev is not None else k_call,
                call_ms=k_call, plain_ms=p_call, bound_ms=bound,
                bound_by=by, library_ms=lib))
            dev = "not measured" if k_dev is None else f"{k_dev:.4f} ms"
            libs = "none" if lib is None else f"{lib:.4f} ms"
            log(f"{name:11s} kernel {dev} on the device, {k_call:.4f} ms per "
                f"call  plain {p_call:.4f} ms  library {libs}{lib_note}  "
                f"bound {bound:.4f} ms ({by})  on {card}")
    if "dsp_launches" in ctx:
        phase("5b DSP kernel times", dsp_times)

    n_kernels = len(cuda_step.KERNELS) + len(dsp.launches)
    if failures or len(rows) != n_kernels:
        log(f"FAILED phases: {failures or ['kernel times (not run)']}")
        return 1
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
