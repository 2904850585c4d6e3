"""K5 real FIR, K6 complex FIR, K7 adaptive (LMS) FIR and K8 IIR: CUDA
kernels (``csrc/dsp.cu``) and their wrappers.

Counterpart of the reference's ``kernels/dsp_fir.py``.
"""
from __future__ import annotations

import torch

from . import ref
from .common import check, launch, on_card

#: the most weights a frame of the LMS kernel's generic instance holds
#: (``min(K, N)``; they and as many past samples, less one, in shared
#: memory: ``LMS_W_BYTES`` in ``csrc/dsp.cu``).  K 4 and 8 (the reference's
#: tests and its dispatch entry) keep theirs in registers.  Checked on the
#: card route only; the C entry refuses past it as a backstop.
LMS_MAX_TAPS = (192 * 1024 // 4 + 1) // 2


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


def complex_fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x: (B, N, 2) re/im f32, h: (K, 2) f32 → (B, N, 2): the complex
    ``y[b, n] = sum_k h[k] * x[b, n - k]`` with zero fill, rounded in the
    reference kernel's order."""
    if x.dim() != 3 or x.shape[2] != 2 or h.dim() != 2 or h.shape[1] != 2 \
            or h.shape[0] < 1:
        raise ValueError(f"complex_fir takes x (B, N, 2) and h (K, 2) with "
                         f"K >= 1, got {tuple(x.shape)} and "
                         f"{tuple(h.shape)}")
    B, N, _ = x.shape
    K = h.shape[0]
    dev = x.device
    check("x", x, dev, (B, N, 2))
    check("h", h, dev, (K, 2))
    if not on_card(dev):
        return ref.complex_fir(x, h)
    y = torch.empty_like(x)
    launch("complex_fir", B, N, K, x, h, y)
    return y


def adaptive_fir(x: torch.Tensor, d: torch.Tensor, mu: float,
                 K: int) -> torch.Tensor:
    """LMS filter output per frame. x, d: (B, N) f32, ``K`` taps, step
    ``mu`` → (B, N).  The card takes any ``K`` with ``min(K, N)`` at most
    :data:`LMS_MAX_TAPS` (taps past ``N`` never meet a sample)."""
    if x.dim() != 2:
        raise ValueError(f"adaptive_fir takes x (B, N), got "
                         f"{tuple(x.shape)}")
    if not isinstance(K, int) or K < 1:
        raise ValueError(f"K must be an int >= 1, got {K!r}")
    B, N = x.shape
    dev = x.device
    check("x", x, dev, (B, N))
    check("d", d, dev, (B, N))
    if not on_card(dev):
        return ref.adaptive_fir(x, d, mu, K)
    if min(K, N) > LMS_MAX_TAPS:
        raise ValueError(f"the adaptive_fir kernel holds at most "
                         f"{LMS_MAX_TAPS} weights a frame (min(K, N)), got "
                         f"K = {K}, N = {N}")
    y = torch.empty_like(x)
    launch("adaptive_fir", B, N, K, float(mu), x, d, y)
    return y


def iir(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """x: (B, N) f32; b: (Kb,); a: (Ka,) with a[0] = 1 (ignored) → (B, N).
    ``Ka >= 2``: the reference cannot run a shorter ``a`` either (its
    output history changes shape inside the scan).  The card takes filters
    of any length: up to 8 coefficients each in registers, longer ones
    through the flat kernel's generic instance."""
    if x.dim() != 2 or b.dim() != 1 or a.dim() != 1 or b.shape[0] < 1:
        raise ValueError(f"iir takes x (B, N), b (Kb,) with Kb >= 1 and a "
                         f"(Ka,), got {tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(a.shape)}")
    B, N = x.shape
    Kb, Ka = b.shape[0], a.shape[0]
    if Ka < 2:
        raise ValueError(f"iir needs a of at least 2 coefficients, got {Ka}")
    dev = x.device
    check("x", x, dev, (B, N))
    check("b", b, dev, (Kb,))
    check("a", a, dev, (Ka,))
    if not on_card(dev):
        return ref.iir(x, b, a)
    y = torch.empty_like(x)
    launch("iir", B, N, Kb, Ka, x, b, a, y)
    return y
