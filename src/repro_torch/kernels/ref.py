"""Plain torch versions of the DSP kernels this port runs so far.

Counterpart of the reference's ``kernels/ref.py`` for ``real_fir``,
``vector_dot``, ``correlation`` and ``fft``/``fft_256``, each in the
reference's formula and layout.  They are what the wrappers compute on CPU
tensors, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.  The FFT is the reference kernel's own radix-2 recurrence (a
bit-reversal pre-pass, then ``log2 N`` butterfly stages over float32
twiddle tables), not ``torch.fft``.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def real_fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Real FIR: ``y[b, n] = sum_k h[k] * x[b, n - k]`` (causal, zero fill).

    x: (B, N) float; h: (K,) float → (B, N)
    """
    K, N = h.shape[0], x.shape[1]
    xp = F.pad(x, (K - 1, 0))
    y = h[0] * xp[:, K - 1:K - 1 + N]
    for k in range(1, K):
        y = y + h[k] * xp[:, K - 1 - k:K - 1 - k + N]
    return y


def vector_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N) · (B, N) → (B,)"""
    return (x * y).sum(-1)


def correlation(x: torch.Tensor, y: torch.Tensor,
                max_lag: int) -> torch.Tensor:
    """Sliding cross-correlation:
    ``c[b, l] = sum_n x[b, n] * y[b, n + l - max_lag]`` against zero-padded
    ``y``; column 0 is lag ``-max_lag``.  x, y: (B, N) → (B, 2*max_lag + 1)
    """
    N = x.shape[1]
    yp = F.pad(y, (max_lag, max_lag))
    return torch.stack([(x * yp[:, l:l + N]).sum(-1)
                        for l in range(2 * max_lag + 1)], -1)


# ---------------------------------------------------------------------------
# radix-2 FFT (the reference's kernels/dsp_spectral.py, its constants copied)
# ---------------------------------------------------------------------------
def _bitrev(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def _twiddle_tables(N: int) -> tuple[np.ndarray, np.ndarray]:
    """(stages, N/2) twiddle tables; stage s uses the first 2^s entries."""
    stages = N.bit_length() - 1
    twr = np.zeros((stages, N // 2), np.float32)
    twi = np.zeros((stages, N // 2), np.float32)
    for s in range(stages):
        m = 1 << s
        tw = np.exp(-2j * np.pi * np.arange(m) / (2 * m))
        twr[s, :m], twi[s, :m] = tw.real, tw.imag
    return twr, twi


@functools.lru_cache(maxsize=None)
def twiddles(N: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The float32 twiddle tables of an ``N``-point FFT on ``device``
    (one small upload per (N, device))."""
    return tuple(torch.from_numpy(t).to(device) for t in _twiddle_tables(N))


def check_fft_frame(N: int) -> None:
    if N < 2 or N & (N - 1):
        raise ValueError(f"radix-2 FFT needs a power-of-two frame of at "
                         f"least 2 samples, got N = {N}")


def fft(x: torch.Tensor) -> torch.Tensor:
    """Radix-2 complex FFT. x: (B, N, 2) re/im, N power of two → (B, N, 2)."""
    B, N, _ = x.shape
    check_fft_frame(N)
    twr, twi = twiddles(N, x.device)
    rev = torch.from_numpy(_bitrev(N)).to(x.device)
    xr, xi = x[:, rev, 0], x[:, rev, 1]          # bit-reversal pre-pass
    for s in range(N.bit_length() - 1):
        m = 1 << s                               # butterfly half-span
        g = N // (2 * m)                         # groups
        wr, wi = twr[s, :m], twi[s, :m]
        xr4, xi4 = xr.reshape(B, g, 2, m), xi.reshape(B, g, 2, m)
        er, ei = xr4[:, :, 0, :], xi4[:, :, 0, :]
        orr, oii = xr4[:, :, 1, :], xi4[:, :, 1, :]
        tr = orr * wr - oii * wi                 # twiddled odd
        ti = orr * wi + oii * wr
        xr = torch.stack([er + tr, er - tr], 2).reshape(B, N)
        xi = torch.stack([ei + ti, ei - ti], 2).reshape(B, N)
    return torch.stack([xr, xi], -1)


def fft_256(x: torch.Tensor) -> torch.Tensor:
    """256-point complex FFT. x: (B, 256, 2) re/im → (B, 256, 2)."""
    if x.shape[1] != 256:
        raise ValueError(f"fft_256 takes 256-sample frames, got {x.shape[1]}")
    return fft(x)
