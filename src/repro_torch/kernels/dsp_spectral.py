"""K13, the radix-2 FFT: a CUDA kernel (``csrc/dsp.cu``) and its wrapper.

Counterpart of the reference's ``kernels/dsp_spectral.py`` ``fft`` /
``fft_256``, with its numpy constants (``_bitrev``, ``_twiddle_tables``,
kept in :mod:`.ref`, whose plain FFT uses them too).  The kernel does the
bit-reversal in its load and takes the same float32 twiddle tables.  The
DCT is not ported yet (ROADMAP.md Queue 2).
"""
from __future__ import annotations

import torch

from . import ref
from .common import check, launch, on_card
from .ref import _bitrev, _twiddle_tables  # noqa: F401  (the copied constants)

#: one frame's re/im planes must fit the 48 KB of shared memory a block
#: uses.  Checked on the card route only (the plain version takes any
#: power of two); the C entry refuses the same sizes as a backstop.
FFT_MAX_N = 4096


def fft(x: torch.Tensor) -> torch.Tensor:
    """Radix-2 complex FFT. x: (B, N, 2) re/im, N power of two → (B, N, 2)."""
    if x.dim() != 3 or x.shape[2] != 2:
        raise ValueError(f"fft takes (B, N, 2) re/im frames, got "
                         f"{tuple(x.shape)}")
    B, N, _ = x.shape
    ref.check_fft_frame(N)
    dev = x.device
    check("x", x, dev, (B, N, 2))
    if not on_card(dev):
        return ref.fft(x)
    if N > FFT_MAX_N:
        raise ValueError(f"the fft kernel takes frames of at most "
                         f"{FFT_MAX_N} samples, got {N}")
    twr, twi = ref.twiddles(N, dev)
    out = torch.empty_like(x)
    launch("fft", B, N, x, twr, twi, out)
    return out


def fft_256(x: torch.Tensor) -> torch.Tensor:
    """256-point complex FFT. x: (B, 256, 2) re/im → (B, 256, 2)."""
    if x.dim() != 3 or x.shape[1] != 256:
        raise ValueError(f"fft_256 takes (B, 256, 2) frames, got "
                         f"{tuple(x.shape)}")
    return fft(x)
