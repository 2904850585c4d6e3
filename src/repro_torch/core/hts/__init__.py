"""HTS on PyTorch: the population scheduler machine with CUDA step kernels.

Public surface (mirrors the reference ``repro.core.hts`` facade as far as
this port reaches):

* :class:`Program` / :class:`Region` / :class:`Reg` — the typed
  Program-Builder front-end (``builder.py``).
* :func:`run` / :func:`run_many` / :func:`compare` — the simulation facade
  (``api.py``) over the torch population machine (``machine.py``, its four
  kernel phases in ``cuda_step.py``) and the pure-Python golden oracle
  (``golden.py``).  Every torch entry point takes ``device=`` (``None`` =
  the CUDA card; without one it raises unless ``device="cpu"``).
* :func:`pack_population` pads N programs to one lane axis;
  ``workloads.py`` generates seeded multi-tenant scenarios.

    >>> from repro_torch.core import hts
    >>> p = hts.Program("demo")
    >>> x = p.input(0x10, 4)
    >>> fft = p.task("fft_256", in_=x, out=4)
    >>> print(hts.run(p, scheduler="hts_spec", n_fu=2, device="cpu").table())
"""
from .api import (ALL_SCHEDULERS, CompareReport, FairnessReport,
                  MismatchError, PopulationResult, Result, SimulationError,
                  TaskRow, compare, run, run_many, scenarios_per_second)
from .batch import PackedPopulation, pack_population, prog_bucket
from .builder import (BuilderError, BuiltProgram, Program, Reg, Region,
                      TaskHandle, Walker)
from .costs import SchedulerCosts, costs_by_name
from .frontend import MultiProgram, Stream, StreamSet, build_frontends
from .golden import HtsParams
from .machine import MachineSpec, make_machine
from .policy import SchedPolicy

__all__ = [
    "ALL_SCHEDULERS", "BuilderError", "BuiltProgram", "CompareReport",
    "FairnessReport", "HtsParams", "MachineSpec", "MismatchError",
    "MultiProgram", "PackedPopulation", "PopulationResult", "Program", "Reg",
    "Region", "Result", "SchedPolicy", "SchedulerCosts", "SimulationError",
    "Stream", "StreamSet", "TaskHandle", "TaskRow", "Walker",
    "build_frontends", "compare", "costs_by_name", "make_machine",
    "pack_population", "prog_bucket", "run", "run_many",
    "scenarios_per_second",
]
