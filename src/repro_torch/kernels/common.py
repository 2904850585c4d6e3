"""What the kernel wrappers share: the two CUDA libraries (``csrc/dsp.cu``
for the DSP kernels, ``csrc/transformer.cu`` for K15–K18), their launch
counters, and the input checks.

Each library is built at first use with ``nvcc`` for ``sm_90a`` into
``build/repro_torch/`` (:mod:`repro_torch._build`); nothing is compiled at
import, so the CPU tests import every module.  A wrapper launches its
kernel for CUDA tensors and hands CPU tensors to its plain version in
:mod:`.ref`; no other path falls back.
"""
from __future__ import annotations

import torch

from .. import _build

_P, _I, _F = _build.P, _build.I, _build.F
#: ``csrc/dsp.cu``: ``LIB.build()`` compiles it, ``LIB.info`` holds the last
#: build's report (seconds, command, ptxas's -Xptxas -v)
LIB = _build.Library("dsp.cu", {
    # sizes..., scalars..., pointers..., stream
    "dsp_real_fir": [_I] * 3 + [_P] * 3 + [_P],
    "dsp_complex_fir": [_I] * 3 + [_P] * 3 + [_P],
    "dsp_adaptive_fir": [_I] * 3 + [_F] + [_P] * 3 + [_P],
    "dsp_iir": [_I] * 4 + [_P] * 4 + [_P],
    "dsp_vector_dot": [_I] * 2 + [_P] * 3 + [_P],
    "dsp_vector_add": [_I] * 2 + [_P] * 3 + [_P],
    "dsp_vector_max": [_I] * 2 + [_P] * 2 + [_P],
    "dsp_correlation": [_I] * 3 + [_P] * 3 + [_P],
    "dsp_fft": [_I] * 2 + [_P] * 4 + [_P],
    "dsp_dct": [_I] * 2 + [_P] * 3 + [_P],
}, ("real_fir", "complex_fir", "adaptive_fir", "iir", "vector_dot",
    "vector_add", "vector_max", "correlation", "fft", "dct"))
SOURCE = LIB.source
#: kernel launches per wrapper (plain-version calls are not counted)
launches, reset_launches = LIB.launches, LIB.reset_launches
on_card = _build.on_card


#: ``csrc/transformer.cu``: K16 ``rmsnorm``, K15 ``flash_attention``, K17
#: ``wkv6`` and K18 ``ssd``, with their own launch counters; the input's
#: dtype goes to the C entries as an int (:data:`DTYPE_CODES`)
TRANSFORMER_LIB = _build.Library("transformer.cu", {
    # sizes..., dtype, flags..., scalars..., pointers..., stream
    "tf_rmsnorm": [_I] * 3 + [_F] + [_P] * 3 + [_P],
    "tf_flash_attention": [_I] * 8 + [_F] + [_P] * 4 + [_P],
    "tf_wkv6": [_I] * 5 + [_P] * 7 + [_P],
    "tf_ssd": [_I] * 6 + [_P] * 6 + [_P],
}, ("rmsnorm", "flash_attention", "wkv6", "ssd"))
#: the recurrences' state dimension (wkv6's K in a thread's registers,
#: ssd's N in shared-memory tiles), padded to 16, 32, 64 or 128
MAX_STATE = 128
#: the dtypes the transformer kernels take, and their codes in the C entries
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def launch(name: str, *args) -> None:
    """Launch ``dsp_<name>`` on the current stream, then count it under
    ``name``."""
    LIB.launch(f"dsp_{name}", name, *args)


def check(name: str, t: torch.Tensor, device: torch.device,
          shape: tuple, dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device``."""
    if not torch.is_tensor(t):
        raise TypeError(f"{name} is a {type(t).__name__}, expected a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected "
                        f"{str(dtype).removeprefix('torch.')}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
