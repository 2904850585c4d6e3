"""K16 ``rmsnorm``: the CUDA kernel (``csrc/transformer.cu``) and its
wrapper.

Counterpart of the reference's ``kernels/rmsnorm.py``.  The kernel takes
float32 or bfloat16 rows; ``x`` and ``w`` share the dtype.
"""
from __future__ import annotations

import torch

from . import ref
from .common import DTYPE_CODES, TRANSFORMER_LIB, check, on_card


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (R, D) rows; w: (D,) → (R, D).  Callers flatten leading dims."""
    if x.dim() != 2:
        raise ValueError(f"x must be (R, D), got {tuple(x.shape)}")
    R, D = x.shape
    dev = x.device
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"rmsnorm takes {list(DTYPE_CODES)}, got {x.dtype}")
    check("x", x, dev, (R, D), x.dtype)
    check("w", w, dev, (D,), x.dtype)
    if not on_card(dev):
        return ref.rmsnorm(x, w, eps)
    out = torch.empty_like(x)
    TRANSFORMER_LIB.launch("tf_rmsnorm", "rmsnorm", R, D,
                           DTYPE_CODES[x.dtype], float(eps), x, w, out)
    return out
