"""What the DSP kernel wrappers share: the ``csrc/dsp.cu`` library, the
launch counters, and the input checks.

The library is built at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` (:mod:`repro_torch._build`); nothing is compiled at
import, so the CPU tests import every module.  A wrapper launches its
kernel for CUDA tensors and hands CPU tensors to its plain version in
:mod:`.ref`; no other path falls back.
"""
from __future__ import annotations

import torch

from .. import _build

_P, _I = _build.P, _build.I
#: ``csrc/dsp.cu``: ``LIB.build()`` compiles it, ``LIB.info`` holds the last
#: build's report (seconds, command, ptxas's -Xptxas -v)
LIB = _build.Library("dsp.cu", {
    # sizes..., pointers..., stream
    "dsp_real_fir": [_I] * 3 + [_P] * 3 + [_P],
    "dsp_vector_dot": [_I] * 2 + [_P] * 3 + [_P],
    "dsp_correlation": [_I] * 3 + [_P] * 3 + [_P],
    "dsp_fft": [_I] * 2 + [_P] * 4 + [_P],
}, ("real_fir", "vector_dot", "correlation", "fft"))
SOURCE = LIB.source
#: kernel launches per wrapper (plain-version calls are not counted)
launches, reset_launches = LIB.launches, LIB.reset_launches
on_card = _build.on_card


def launch(name: str, *args) -> None:
    """Launch ``dsp_<name>`` on the current stream, then count it under
    ``name``."""
    LIB.launch(f"dsp_{name}", name, *args)


def check(name: str, t: torch.Tensor, device: torch.device,
          shape: tuple) -> None:
    """Raise unless ``t`` is a contiguous float32 tensor of ``shape`` on
    ``device``."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name} is a {type(t).__name__}, expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} has dtype {t.dtype}, expected float32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
