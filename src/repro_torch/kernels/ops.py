"""The public DSP ops and the accelerator dispatch table.

Counterpart of the reference's ``kernels/ops.py`` for the functions this
port runs so far.  The ops need no row padding: the kernels mask the
ragged batch edge themselves (the reference pads rows to its block size).
The composition around the kernels (stack, slice, broadcast) stays plain
torch, as it stayed ``jnp`` in the reference.
"""
from __future__ import annotations

import torch

from . import ref
from .dsp_fir import real_fir
from .dsp_spectral import dct, fft_256
from .dsp_vector import correlation, vector_add, vector_dot, vector_max

__all__ = ["real_fir", "vector_dot", "vector_add", "vector_max",
           "correlation", "fft_256", "dct", "dsp_dispatch_table",
           "plain_dispatch_table", "DispatchTable"]


class DispatchTable(dict):
    """accelerator name → op on (B, N) frames.  A function with no Hopper
    kernel yet raises a ``KeyError`` naming it: the port never runs a plain
    version on the card in a kernel's place."""

    def __missing__(self, name):
        raise KeyError(f"accelerator function {name!r} has no Hopper kernel "
                       "in the port yet (still to port: ROADMAP.md Queue 2)")


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    cur = x.shape[1]
    if cur < n:
        return torch.nn.functional.pad(x, (0, n - cur))
    return x[:, :n]


def _table(real_fir, vector_dot, vector_add, vector_max, correlation,
           fft_256, dct) -> DispatchTable:
    """The reference's entries for these seven functions, composed exactly
    as ``ops.dsp_dispatch_table`` composes them, over the given ops.  The
    DCT entry fits the frame to 64 samples and slices back to the input's
    width, so a frame wider than 64 comes back 64 wide, as in the
    reference."""

    def fft_frame(x):
        z = _fit(x, 256)
        out = fft_256(torch.stack([z, torch.zeros_like(z)], -1))
        return out[:, :x.shape[1], 0]

    def fir(x):
        return real_fir(x.contiguous(),
                        torch.ones(8, dtype=x.dtype, device=x.device) / 8)

    def dot(x):
        x = x.contiguous()
        return vector_dot(x, x)[:, None] * torch.ones_like(x)

    def add(x):
        x = x.contiguous()
        return vector_add(x, x)

    def vmax(x):
        x = x.contiguous()
        return vector_max(x)[:, None] * torch.ones_like(x)

    def corr(x):
        x = x.contiguous()
        return correlation(x, x, 4)[:, :1] * torch.ones_like(x)

    def dct_frame(x):
        return dct(_fit(x, 64).contiguous())[:, :x.shape[1]]

    return DispatchTable(real_fir=fir, vector_dot=dot, vector_add=add,
                         vector_max=vmax, fft_256=fft_frame, dct=dct_frame,
                         correlation=corr)


def dsp_dispatch_table() -> DispatchTable:
    """accelerator id → executable op on the kernels, mirroring
    ``costs.FUNCTIONS`` as far as the port has kernels."""
    return _table(real_fir, vector_dot, vector_add, vector_max, correlation,
                  fft_256, dct)


def plain_dispatch_table() -> DispatchTable:
    """The same entries over the plain versions (:mod:`.ref`): what the
    tests and ``chip_smoke.py`` hold the kernel table against."""
    return _table(ref.real_fir, ref.vector_dot, ref.vector_add,
                  ref.vector_max, ref.correlation, ref.fft_256, ref.dct)
