"""Build a span of a CUDA source for the CPU, against ``cuda_emu.h``.

``csrc/transformer.cu`` (K17) and ``csrc/dsp.cu`` (K5) mark the span of
device code and launchers that g++ can take between two comment lines; the
inline-PTX helpers (``cp_async16``) and the C entries stay outside it.  The
span is compiled with a prelude that supplies what it uses from outside
(``cuda_emu.h``'s stand-ins, ``KERNEL_LAUNCH`` as ``emu_launch``) and a
runner with a plain C entry, into a shared library loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent

PRELUDE = r"""
#include "cuda_emu.h"
#define KERNEL_LAUNCH(kernel, grid, threads, smem, stream, ...) \
  emu_launch(kernel, grid, dim3(threads), smem, __VA_ARGS__)
inline bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}
"""


def span(source: str, name: str) -> str:
    """The text between ``// ==== <name> span`` and ``// ==== end of the
    <name> span`` (each exactly once in ``source``)."""
    begin, end = f"// ==== {name} span", f"// ==== end of the {name} span"
    assert source.count(begin) == 1 and source.count(end) == 1, name
    return source[source.index(begin):source.index(end)]


def build(tmp: Path, code: str, entries: dict) -> ctypes.CDLL:
    """Compile ``PRELUDE + code`` (C++20, -O1) into ``tmp`` and load it,
    setting ``argtypes`` and an int return for each entry; skip where
    there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to build the emulated kernel")
    (tmp / "emu.cpp").write_text(PRELUDE + code)
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC",
         f"-I{HERE}", "-o", str(tmp / "libemu.so"), str(tmp / "emu.cpp")],
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(tmp / "libemu.so"))
    for name, argtypes in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
