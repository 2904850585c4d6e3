"""The port's one build route for its CUDA libraries: ``nvcc`` + ``ctypes``.

Each source under ``csrc/`` has a plain C interface (sizes, pointers, the
stream; every entry returns ``cudaGetLastError()``).  A :class:`Library`
ties one source to its signatures, its build report and its launch
counters: :meth:`Library.build` compiles it for Hopper (``-gencode
arch=compute_90a,code=sm_90a``) into a shared library under
``build/repro_torch/`` at the root of the checkout, cached by the source's
content; :meth:`Library.load` opens it with every ``argtypes`` set;
:meth:`Library.launch` launches one entry on the current stream, raises if
it returns a CUDA error, and counts it.  Nothing here builds or loads at
import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"

#: argtypes shorthands: a pointer (or the stream), an int
P, I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "port's CUDA kernels cannot be built")


def on_card(device: torch.device) -> bool:
    """A wrapper's route: True for the kernel (CUDA tensors), False for the
    plain version (CPU tensors); any other device raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {device}")


class Library:
    """One CUDA source under ``csrc/``, built and loaded at first use.

    ``info`` holds the last build's report; ``launches`` counts kernel
    launches per counter name (plain-version calls are not counted)."""

    def __init__(self, source_name: str, signatures: dict, counters):
        self.source = CSRC / source_name
        self.signatures = signatures
        self.info: dict = {}
        self.launches = {name: 0 for name in counters}
        self._handle = None

    def build(self) -> Path:
        """Compile the source into a shared library (once per source
        content) and return its path.  Raises if ``nvcc`` fails.  A fresh
        build records its seconds, command and ptxas report (``-Xptxas
        -v``) in ``info``."""
        src = self.source.read_bytes()
        out = BUILD_DIR / (f"lib{self.source.stem}_"
                           f"{hashlib.sha1(src).hexdigest()[:12]}.so")
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{self.source.name}:\n{proc.stdout}\n"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        self.info.update(seconds=time.perf_counter() - t0, cmd=" ".join(cmd),
                         ptxas=proc.stderr + proc.stdout)
        return out

    def load(self):
        """Build the source and open it (once); each entry of the
        signatures (name → argtypes, pointers and the stream as
        ``c_void_p``) gets its ``argtypes`` and an int return."""
        if self._handle is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.signatures.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._handle = lib
        return self._handle

    def launch(self, entry: str, counter: str, *args) -> None:
        """Launch ``entry`` on the current stream (tensors go as their
        device pointers, sizes as ints), raise on a CUDA error, then count
        it under ``counter``."""
        stream = torch.cuda.current_stream().cuda_stream
        conv = [a.data_ptr() if torch.is_tensor(a) else int(a) for a in args]
        rc = getattr(self.load(), entry)(*conv, stream)
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc} at launch")
        self.launches[counter] += 1

    def reset_launches(self) -> None:
        for k in self.launches:
            self.launches[k] = 0
