"""K13, the radix-2 FFT, and K14, the DCT-II: CUDA kernels
(``csrc/dsp.cu``) and their wrappers.

Counterpart of the reference's ``kernels/dsp_spectral.py`` ``fft`` /
``fft_256`` and ``dct``, with its numpy constants (``_bitrev``,
``_twiddle_tables``, ``dct_matrix``, kept in :mod:`.ref`, whose plain
versions use them too).  The FFT kernel keeps 16 points of a frame in
each thread's registers, runs four stages at a time on them and goes
through shared memory once between those passes; it does the
bit-reversal in its load and takes the last row of the same float32
twiddle tables, whose every row is a stride of it
(:func:`kernel_twiddles`).  The DCT kernel takes the same float32 DCT-II
matrix and multiplies in full fp32 on the CUDA cores.
"""
from __future__ import annotations

import torch

from . import ref
from .common import check, launch, on_card
# the reference's numpy constants, copied
from .ref import _bitrev, _twiddle_tables, dct_matrix  # noqa: F401

#: the kernel is built for frames of 2 to 4096 points (the block stages one
#: frame and its twiddles in shared memory).  Checked on the card route
#: only (the plain version takes any power of two); the C entry refuses
#: the same sizes as a backstop.
FFT_MAX_N = 4096
#: the DCT kernel keeps a tile of 64 rows and the whole (N, N) matrix in
#: shared memory: 99 KB at N = 128, the reference tests' widest.  Checked
#: on the card route only; the C entry refuses the same sizes.
DCT_MAX_N = 128


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
    twr, twi = kernel_twiddles(N, dev)
    if x.data_ptr() % 8:             # the kernel loads (re, im) as 8 bytes
        x = x.clone()
    out = torch.empty_like(x)
    launch("fft", B, N, x, twr, twi, out)
    return out


def kernel_twiddles(N: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The twiddles the fft kernel takes: the last row (N/2 entries) of
    the (stages, N/2) tables.  Row s's entry j is the last row's entry
    j * 2^(stages-1-s), bit for bit, so no stage needs its own row."""
    return tuple(t[-1] for t in ref.twiddles(N, device))


def fft_256(x: torch.Tensor) -> torch.Tensor:
    """256-point complex FFT. x: (B, 256, 2) re/im → (B, 256, 2)."""
    if x.dim() != 3 or x.shape[1] != 256:
        raise ValueError(f"fft_256 takes (B, 256, 2) frames, got "
                         f"{tuple(x.shape)}")
    return fft(x)


def dct(x: torch.Tensor) -> torch.Tensor:
    """DCT-II over the last axis, ``x @ dct_matrix(N).T``: (B, N) → (B, N).
    The (N, N) matrix is built once per (N, device)."""
    if x.dim() != 2:
        raise ValueError(f"dct takes (B, N) frames, got {tuple(x.shape)}")
    B, N = x.shape
    dev = x.device
    check("x", x, dev, (B, N))
    if not on_card(dev):
        return ref.dct(x)
    if not 1 <= N <= DCT_MAX_N:
        raise ValueError(f"the dct kernel takes 1 <= N <= {DCT_MAX_N}, "
                         f"got N = {N}")
    out = torch.empty_like(x)
    launch("dct", B, N, x, ref.dct_mat(N, dev), out)
    return out
