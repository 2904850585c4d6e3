"""HTS on PyTorch: the population scheduler machine with CUDA step kernels.

Public surface (mirrors the reference ``repro.core.hts`` facade as far as
this port reaches):

* :class:`Program` / :class:`Region` / :class:`Reg` — the typed
  Program-Builder front-end (``builder.py``).
* :func:`run` / :func:`run_many` / :func:`sweep` / :func:`compare` /
  :func:`compare_population` — the simulation facade
  (``api.py``) over the torch population machine (``machine.py``, its four
  kernel phases in ``cuda_step.py``) and the pure-Python golden oracle
  (``golden.py``).  Every torch entry point takes ``device=`` (``None`` =
  the CUDA card; without one it raises unless ``device="cpu"``).
* :func:`pack_population` pads N programs to one lane axis;
  ``workloads.py`` generates seeded multi-tenant scenarios.
* serving + sharding (``serve.py`` / ``shard.py``): :func:`serve` builds
  a continuously-batched :class:`Server` — ``submit(scenario) ->
  Future[Result]``, shape-bucket routing, launch-on-full/deadline,
  slice-and-refill with the carry kept on the device, bounded-queue
  backpressure, per-bucket/per-tenant service metrics and a probe of
  builds and ``hts_run`` launches (:meth:`Server.cache_info`);
  ``run_many(devices=N)`` and ``ServeSpec(devices=N)`` split the lanes
  over N cards (``compare_population(devices=N)`` holds them to golden).

    >>> from repro_torch.core import hts
    >>> p = hts.Program("demo")
    >>> x = p.input(0x10, 4)
    >>> fft = p.task("fft_256", in_=x, out=4)
    >>> print(hts.run(p, scheduler="hts_spec", n_fu=2, device="cpu").table())
"""
from .api import (ALL_SCHEDULERS, CompareReport, FairnessReport,
                  MismatchError, PopulationCompareReport, PopulationResult,
                  Result, SimulationError, SweepResult, TaskRow, compare,
                  compare_population, run, run_many, scenarios_per_second,
                  sweep)
from .batch import PackedPopulation, pack_population, prog_bucket
from .builder import (BuilderError, BuiltProgram, Program, Reg, Region,
                      TaskHandle, Walker)
from .costs import SchedulerCosts, costs_by_name
from .frontend import MultiProgram, Stream, StreamSet, build_frontends
from .golden import HtsParams
from .machine import MachineSpec, make_machine
from .policy import SchedPolicy
from .serve import (CacheInfo, ManualClock, QueueFullError, Server,
                    ServeReport, ServeSpec, SystemClock, serve)

__all__ = [
    "ALL_SCHEDULERS", "BuilderError", "BuiltProgram", "CacheInfo",
    "CompareReport", "FairnessReport", "HtsParams", "MachineSpec",
    "ManualClock", "MismatchError", "MultiProgram", "PackedPopulation",
    "PopulationCompareReport", "PopulationResult", "Program",
    "QueueFullError", "Reg", "Region", "Result", "SchedPolicy",
    "SchedulerCosts", "Server", "ServeReport", "ServeSpec",
    "SimulationError", "Stream", "StreamSet", "SweepResult", "SystemClock",
    "TaskHandle", "TaskRow", "Walker", "build_frontends", "compare",
    "compare_population", "costs_by_name", "make_machine",
    "pack_population", "prog_bucket", "run", "run_many",
    "scenarios_per_second", "serve", "sweep",
]
