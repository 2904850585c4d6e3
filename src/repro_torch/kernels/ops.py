"""The public ops: the ten Table II functions with the accelerator
dispatch table, the transformer's ``rmsnorm`` and ``flash_attention``, and
the recurrences ``rwkv6_scan`` and ``mamba2_ssd``.

Counterpart of the reference's ``kernels/ops.py``.  The ops need no row
padding: the kernels mask the ragged edge themselves (the reference pads
rows to its block size).  The composition around the kernels (stack,
slice, broadcast, the GQA repeat) stays plain torch, as it stayed ``jnp``
in the reference.
"""
from __future__ import annotations

import functools

import torch

from ..core.hts.costs import FUNCTIONS
from . import attention as _attn
from . import mamba2 as _m2
from . import ref
from . import rmsnorm as _rms
from . import rwkv6 as _rwkv
from .dsp_fir import adaptive_fir, complex_fir, iir, real_fir
from .dsp_spectral import dct, fft_256
from .dsp_vector import correlation, vector_add, vector_dot, vector_max

__all__ = ["real_fir", "complex_fir", "adaptive_fir", "iir", "vector_dot",
           "vector_add", "vector_max", "correlation", "fft_256", "dct",
           "dsp_dispatch_table", "plain_dispatch_table", "DispatchTable",
           "rmsnorm", "flash_attention", "rwkv6_scan", "mamba2_ssd"]


class DispatchTable(dict):
    """accelerator name → op on (B, N) frames, one entry per Table II
    function (``costs.FUNCTIONS``).  Any other name raises a ``KeyError``
    naming it."""

    def __missing__(self, name):
        raise KeyError(f"{name!r} is not an accelerator function of Table "
                       f"II (costs.FUNCTIONS: {', '.join(FUNCTIONS)})")


@functools.lru_cache(maxsize=None)
def _iir_coefs(dtype: torch.dtype,
               device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The IIR entry's (b, a) on ``device``, uploaded once: a fresh
    ``torch.tensor`` per call is a pageable copy that waits for the
    stream, so the host would stop queueing work at every IIR task."""
    return (torch.tensor([0.2, 0.3], dtype=dtype, device=device),
            torch.tensor([1.0, -0.5], dtype=dtype, device=device))


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    cur = x.shape[1]
    if cur < n:
        return torch.nn.functional.pad(x, (0, n - cur))
    return x[:, :n]


def _table(real_fir, complex_fir, adaptive_fir, iir, vector_dot,
           vector_add, vector_max, correlation, fft_256,
           dct) -> DispatchTable:
    """The reference's ten entries, composed exactly as
    ``ops.dsp_dispatch_table`` composes them, over the given ops.  The DCT
    entry fits the frame to 64 samples and slices back to the input's
    width, so a frame wider than 64 comes back 64 wide, as in the
    reference.  The complex FIR entry filters ``x + jx`` with the taps
    ``(1 + j)/8`` and keeps the real part, ``x/8 - x/8``: exactly zero, as
    in the reference."""

    def fft_frame(x):
        z = _fit(x, 256)
        out = fft_256(torch.stack([z, torch.zeros_like(z)], -1))
        return out[:, :x.shape[1], 0]

    def fir(x):
        return real_fir(x.contiguous(),
                        torch.ones(8, dtype=x.dtype, device=x.device) / 8)

    def cfir(x):
        x = x.contiguous()
        taps = torch.ones(8, 2, dtype=x.dtype, device=x.device) / 8
        return complex_fir(torch.stack([x, x], -1), taps)[..., 0]

    def lms(x):
        x = x.contiguous()
        return adaptive_fir(x, x, 0.01, 8)

    def recur(x):
        return iir(x.contiguous(), *_iir_coefs(x.dtype, x.device))

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

    return DispatchTable(real_fir=fir, complex_fir=cfir, adaptive_fir=lms,
                         iir=recur, vector_dot=dot, vector_add=add,
                         vector_max=vmax, fft_256=fft_frame, dct=dct_frame,
                         correlation=corr)


def dsp_dispatch_table() -> DispatchTable:
    """accelerator id → executable op on the kernels, mirroring
    ``costs.FUNCTIONS``."""
    return _table(real_fir, complex_fir, adaptive_fir, iir, vector_dot,
                  vector_add, vector_max, correlation, fft_256, dct)


def plain_dispatch_table() -> DispatchTable:
    """The same entries over the plain versions (:mod:`.ref`): what the
    tests and ``chip_smoke.py`` hold the kernel table against."""
    return _table(ref.real_fir, ref.complex_fir, ref.adaptive_fir, ref.iir,
                  ref.vector_dot, ref.vector_add, ref.vector_max,
                  ref.correlation, ref.fft_256, ref.dct)


# ---------------------------------------------------------------------------
# transformer ops (K15, K16)
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); w: (D,).  The leading dims go to the kernel as rows."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1]).contiguous()
    return _rms.rmsnorm(flat, w.contiguous(), eps).reshape(shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D), GQA repeated here.

    Unlike the reference, which sends ``Tq < 8`` to its jnp reference (a
    TPU tiling limit of its kernel), this launches K15 at every shape on
    the card."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    if Hq != Hkv:
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    Tk = k.shape[2]
    out = _attn.flash_attention(
        q.reshape(B * Hq, Tq, D).contiguous(),
        k.reshape(B * Hq, Tk, D).contiguous(),
        v.reshape(B * Hq, Tk, D).contiguous(),
        causal=causal, scale=scale, q_offset=int(q_offset))
    return out.reshape(B, Hq, Tq, D)


# ---------------------------------------------------------------------------
# recurrences (K17, K18)
# ---------------------------------------------------------------------------
def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               chunk: int = _rwkv.DEFAULT_CHUNK) -> torch.Tensor:
    """r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K) → (B, T, H, V).

    The heads go to the kernel as rows of (B·H, T, ·), b-major and head
    minor, with u tiled B times."""
    B, T, H, _ = r.shape
    V = v.shape[-1]

    def flat(x):
        return x.transpose(1, 2).reshape(B * H, T, -1).contiguous()

    o = _rwkv.wkv6(flat(r), flat(k), flat(v), flat(w),
                   u.tile(B, 1).contiguous(), chunk=chunk)
    return o.reshape(B, H, T, V).transpose(1, 2)


def mamba2_ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *,
               chunk: int = _m2.DEFAULT_CHUNK) -> torch.Tensor:
    """x: (B, T, H, P); a: (B, T, H); b, c: (B, T, N) → (B, T, H, P).

    Straight through to the kernel (a in float32, as the reference's
    kernel reads it; views made contiguous)."""
    return _m2.ssd(x.contiguous(), a.float().contiguous(), b.contiguous(),
                   c.contiguous(), chunk=chunk)
