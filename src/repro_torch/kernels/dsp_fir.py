"""K5, the real FIR filter: a CUDA kernel (``csrc/dsp.cu``) and its wrapper.

Counterpart of the reference's ``kernels/dsp_fir.py`` ``real_fir``.  The
other three filters of that module (complex, adaptive, IIR) are not ported
yet (ROADMAP.md Queue 2).
"""
from __future__ import annotations

import torch

from . import ref
from .common import check, launch, on_card


def real_fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x: (B, N) f32, h: (K,) f32 → (B, N):
    ``y[b, n] = sum_k h[k] * x[b, n - k]`` with zero fill."""
    if x.dim() != 2 or h.dim() != 1 or h.shape[0] < 1:
        raise ValueError(f"real_fir takes x (B, N) and h (K,) with K >= 1, "
                         f"got {tuple(x.shape)} and {tuple(h.shape)}")
    B, N = x.shape
    K = h.shape[0]
    dev = x.device
    check("x", x, dev, (B, N))
    check("h", h, dev, (K,))
    if not on_card(dev):
        return ref.real_fir(x, h)
    y = torch.empty_like(x)
    launch("real_fir", B, N, K, x, h, y)
    return y
