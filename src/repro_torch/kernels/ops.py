"""The public ops: the ten Table II functions with the accelerator
dispatch table, the transformer's ``rmsnorm`` and ``flash_attention``, and
the recurrences ``rwkv6_scan`` and ``mamba2_ssd``, each of the last four
differentiable through the plain version's VJP (:class:`_RefVJP`).

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
# gradients: each transformer op's kernel forward, its plain version's VJP
# ---------------------------------------------------------------------------
def needs_graph(*inputs) -> bool:
    """Whether a result of ``inputs`` needs a graph: grad mode on and a
    tensor among them that requires a gradient.  Otherwise the ops call
    their kernels (and the layers their functions) directly, so that the
    serving paths keep their launches and their host time."""
    return torch.is_grad_enabled() and any(
        torch.is_tensor(t) and t.requires_grad for t in inputs)


class _RefVJP(torch.autograd.Function):
    """The counterpart of the reference's ``_make_ref_bwd``: the forward
    is ``kernel(*inputs)`` (a K15–K18 wrapper, whose output carries no
    graph), the residuals are the primal inputs, and the backward re-runs
    ``plain(*inputs)`` (the kernel's plain version in :mod:`.ref`) under
    autograd and returns its vector-Jacobian product.  So the gradients
    are the plain version's, while the forward stays on the kernel: the
    reference has no backward kernel either.  The non-tensor arguments
    (``eps``, ``causal``, ``scale``, ``q_offset``, ``chunk``) ride in
    ``kernel`` and ``plain`` and get no gradient.  The backward runs
    inside ``record_function("ref_vjp:<name>")`` (chip_smoke's time split
    reads it)."""

    @staticmethod
    def forward(ctx, name, kernel, plain, *inputs):
        ctx.name, ctx.plain = name, plain
        ctx.save_for_backward(*inputs)
        return kernel(*inputs)

    @staticmethod
    def backward(ctx, grad):
        need = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad(), \
                torch.profiler.record_function(f"ref_vjp:{ctx.name}"):
            out = ctx.plain(*inputs)
            got = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], grad,
                allow_unused=True))
        return (None, None, None, *(next(got) if n else None for n in need))


def _apply(name: str, kernel, plain, *inputs: torch.Tensor) -> torch.Tensor:
    """``kernel(*inputs)``, behind :class:`_RefVJP` where the result
    needs a graph."""
    if needs_graph(*inputs):
        return _RefVJP.apply(name, kernel, plain, *inputs)
    return kernel(*inputs)


# ---------------------------------------------------------------------------
# transformer ops (K15, K16)
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x: (..., D); w: (D,).  The leading dims go to the kernel as rows;
    the gradient is the plain version's on those rows (:class:`_RefVJP`)."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1]).contiguous()
    out = _apply("rmsnorm",
                 lambda xf, wf: _rms.rmsnorm(xf, wf, eps),
                 lambda xf, wf: ref.rmsnorm(xf, wf, eps),
                 flat, w.contiguous())
    return out.reshape(shape)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B, Hq, Tq, D); k, v: (B, Hkv, Tk, D), GQA repeated here.

    Unlike the reference, which sends ``Tq < 8`` to its jnp reference (a
    TPU tiling limit of its kernel), this launches K15 at every shape on
    the card.  The gradient is the plain version's on the (B·Hq, T, D)
    rows after the GQA repeat, whose own backward sums each group
    (:class:`_RefVJP`)."""
    B, Hq, Tq, D = q.shape
    Hkv = k.shape[1]
    if Hq != Hkv:
        rep = Hq // Hkv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    Tk = k.shape[2]
    q_offset = int(q_offset)

    def kernel(q3, k3, v3):
        return _attn.flash_attention(q3, k3, v3, causal=causal, scale=scale,
                                     q_offset=q_offset)

    def plain(q3, k3, v3):
        return ref.flash_attention(q3[:, None], k3[:, None], v3[:, None],
                                   causal=causal, scale=scale,
                                   q_offset=q_offset)[:, 0]

    out = _apply("flash_attention", kernel, plain,
                 q.reshape(B * Hq, Tq, D).contiguous(),
                 k.reshape(B * Hq, Tk, D).contiguous(),
                 v.reshape(B * Hq, Tk, D).contiguous())
    return out.reshape(B, Hq, Tq, D)


# ---------------------------------------------------------------------------
# recurrences (K17, K18)
# ---------------------------------------------------------------------------
def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               chunk: int = _rwkv.DEFAULT_CHUNK) -> torch.Tensor:
    """r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K) → (B, T, H, V).

    The heads go to the kernel as rows of (B·H, T, ·), b-major and head
    minor, with u tiled B times.  The gradient is the plain version's on
    the (B, T, H, ·) inputs and the untiled u (:class:`_RefVJP`)."""
    def kernel(r, k, v, w, u):
        B, T, H, _ = r.shape
        V = v.shape[-1]

        def flat(x):
            return x.transpose(1, 2).reshape(B * H, T, -1).contiguous()

        o = _rwkv.wkv6(flat(r), flat(k), flat(v), flat(w),
                       u.tile(B, 1).contiguous(), chunk=chunk)
        return o.reshape(B, H, T, V).transpose(1, 2)

    return _apply("rwkv6_scan", kernel, ref.rwkv6_scan, r, k, v, w, u)


def mamba2_ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor, *,
               chunk: int = _m2.DEFAULT_CHUNK) -> torch.Tensor:
    """x: (B, T, H, P); a: (B, T, H); b, c: (B, T, N) → (B, T, H, P).

    Straight through to the kernel (a in float32, as the reference's
    kernel reads it, cast before the gradient's boundary; views made
    contiguous).  The gradient is the plain version's
    (:class:`_RefVJP`)."""
    def kernel(x, a, b, c):
        return _m2.ssd(x, a, b, c, chunk=chunk)

    return _apply("mamba2_ssd", kernel, ref.mamba2_ssd, x.contiguous(),
                  a.float().contiguous(), b.contiguous(), c.contiguous())
