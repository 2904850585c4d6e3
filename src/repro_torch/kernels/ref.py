"""Plain torch versions of the kernels: the DSP kernels (the paper's Table
II), the transformer's K15 ``flash_attention`` and K16 ``rmsnorm``, and the
recurrences K17 ``rwkv6_scan`` and K18 ``mamba2_ssd`` (and
``mamba2_ssd_chunked``, the K18 kernel's three chunked steps in plain
torch, which the tests hold against both).

Counterpart of the reference's ``kernels/ref.py`` for ``real_fir``,
``complex_fir``, ``adaptive_fir``, ``iir``, ``vector_dot``, ``vector_add``,
``vector_max``, ``correlation``, ``fft``/``fft_256``, ``dct``, ``rmsnorm``,
``flash_attention``, ``rwkv6_scan`` and ``mamba2_ssd``, each in the
reference's formula, layout and
rounding order.  They are what the wrappers compute on CPU
tensors, and what ``chip_smoke.py`` holds each CUDA kernel against on the
card.  The FFT is the reference kernel's own radix-2 recurrence (a
bit-reversal pre-pass, then ``log2 N`` butterfly stages over float32
twiddle tables), not ``torch.fft``.
"""
from __future__ import annotations

import functools
import math

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


def complex_fir(x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """Complex FIR on interleaved re/im, in the reference Pallas kernel's
    order (``dsp_fir.py:67-73``), every product and sum a separate op:
    ``ar = h00*xr - h01*xi``, ``ai = h00*xi + h01*xr``, then per tap
    ``ar = (ar + hk0*sr) - hk1*si`` and ``ai = (ai + hk0*si) + hk1*sr``.

    x: (B, N, 2); h: (K, 2) → (B, N, 2)
    """
    K, N = h.shape[0], x.shape[1]
    xr, xi = x[..., 0], x[..., 1]
    ar = h[0, 0] * xr - h[0, 1] * xi
    ai = h[0, 0] * xi + h[0, 1] * xr
    pr, pi = F.pad(xr, (K - 1, 0)), F.pad(xi, (K - 1, 0))
    for k in range(1, K):
        sr = pr[:, K - 1 - k:K - 1 - k + N]
        si = pi[:, K - 1 - k:K - 1 - k + N]
        ar = ar + h[k, 0] * sr - h[k, 1] * si
        ai = ai + h[k, 0] * si + h[k, 1] * sr
    return torch.stack([ar, ai], -1)


def _windows(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B, N, K) windows, ``win[:, n, k] = x[:, n - k]`` with zero fill."""
    N = x.shape[1]
    xp = F.pad(x, (K - 1, 0))
    return torch.stack([xp[:, K - 1 - k:K - 1 - k + N] for k in range(K)],
                       -1)


def adaptive_fir(x: torch.Tensor, d: torch.Tensor, mu: float,
                 K: int) -> torch.Tensor:
    """LMS adaptive FIR, the reference's sequential update per frame:
    weights from zero; ``y[n] = w · win[n]``, ``e = d[n] - y[n]``,
    ``w += (mu*e) * win[n]`` with ``mu`` as float32.

    x, d: (B, N) input / desired → (B, N) filter output sequence.
    """
    B, N = x.shape
    win = _windows(x, K)
    w = torch.zeros(B, K, dtype=x.dtype, device=x.device)
    mu = torch.tensor(mu, dtype=x.dtype, device=x.device)
    ys = []
    for n in range(N):
        y = (w * win[:, n]).sum(-1)
        e = d[:, n] - y
        w = w + (mu * e)[:, None] * win[:, n]
        ys.append(y)
    return torch.stack(ys, -1)


def iir(x: torch.Tensor, b: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """Direct-form recurrence, the reference's:
    ``y[n] = sum_j b[j] x[n-j] - sum_{j>=1} a[j] y[n-j]``, the two sums
    formed separately; ``a[0]`` is ignored (assumed 1, never divided by).
    Needs ``len(a) >= 2``, as the reference does.

    x: (B, N); b: (Kb,); a: (Ka,) → (B, N)
    """
    Kb, Ka = b.shape[0], a.shape[0]
    B, N = x.shape
    xwin = _windows(x, Kb)
    ys = torch.zeros(B, Ka - 1, dtype=x.dtype, device=x.device)
    out = []
    for n in range(N):
        y = (xwin[:, n] * b).sum(-1) - (ys * a[1:]).sum(-1)
        ys = torch.cat([y[:, None], ys[:, :-1]], 1)
        out.append(y)
    return torch.stack(out, -1)


def vector_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N) · (B, N) → (B,)"""
    return (x * y).sum(-1)


def vector_add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N) + (B, N) → (B, N)"""
    return x + y


def vector_max(x: torch.Tensor) -> torch.Tensor:
    """Row max, NaN propagating: (B, N) → (B,)"""
    return torch.amax(x, dim=-1)


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


# ---------------------------------------------------------------------------
# DCT-II (the reference's kernels/ref.py dct_matrix, copied)
# ---------------------------------------------------------------------------
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, built in float64 as the reference builds
    it, then cast to float32: row k is the k-th basis vector."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    m[0] *= 1.0 / np.sqrt(2)
    m *= np.sqrt(2.0 / n)
    return m.astype(np.float32)


@functools.lru_cache(maxsize=None)
def dct_mat(N: int, device: torch.device) -> torch.Tensor:
    """``dct_matrix(N)`` on ``device`` (one small upload per (N, device))."""
    return torch.from_numpy(dct_matrix(N)).to(device)


def dct(x: torch.Tensor) -> torch.Tensor:
    """DCT-II over the last axis: ``x @ dct_matrix(N).T``. (B, N) → (B, N)"""
    return x @ dct_mat(x.shape[-1], x.device).T


# ---------------------------------------------------------------------------
# transformer hot spots (K15, K16)
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``(x * rsqrt(mean(x²) + eps))`` in float32, rounded to x's dtype,
    then times ``w`` (one more rounding in that dtype), over the last
    axis."""
    dt = x.dtype
    xf = x.float()
    r = torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (xf * r).to(dt) * w


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Multi-head attention in float32, output in q's dtype: q (B, H, Tq,
    D), k/v (B, H, Tk, D).  ``q_offset`` is the absolute position of q[0]
    against k[0]; the causal mask is ``-inf``, so a row with no key left is
    NaN, as in the reference."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        Tq, Tk = q.shape[2], k.shape[2]
        qi = torch.arange(Tq, device=q.device)[:, None] + q_offset
        ki = torch.arange(Tk, device=q.device)[None, :]
        logits = logits.masked_fill(ki > qi, -math.inf)
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


# ---------------------------------------------------------------------------
# recurrences (K17, K18): a loop over time in float32, as the reference's
# lax.scan, the output rounded once to the input's dtype
# ---------------------------------------------------------------------------
def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """RWKV-6 (Finch) WKV recurrence, per head.

    r, k, w: (B, T, H, K); v: (B, T, H, V); u: (H, K).
    ``o_t = r_t (S_{t-1} + diag(u) k_tᵀ v_t)``, ``S_t = diag(w_t) S_{t-1} +
    k_tᵀ v_t``, S from zero.  Returns o: (B, T, H, V) in r's dtype.
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[:, :, None]                                 # (H, K, 1)
    S = torch.zeros(B, H, K, V, dtype=torch.float32, device=r.device)
    out = torch.empty(B, T, H, V, dtype=torch.float32, device=r.device)
    for t in range(T):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]        # (B, H, K, V)
        out[:, t] = torch.einsum("bhk,bhkv->bhv", rf[:, t], S + uf * kv)
        S = wf[:, t, :, :, None] * S + kv
    return out.to(r.dtype)


def rwkv6_scan_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       w: torch.Tensor, u: torch.Tensor,
                       chunk: int = 64) -> torch.Tensor:
    """:func:`rwkv6_scan` in the chunked form of the K17 kernel, its three
    steps in plain torch, for the tests.

    Per chunk of ``chunk`` steps: (1) each chunk's own end state ``L_c``
    by the exact update from zero, and its decay product ``D_c = Π_t
    w_t`` as a running product; (2) the state entering each chunk, ``S_0
    = 0``, ``S_{c+1} = diag(D_c) S_c + L_c``; (3) each chunk's outputs by
    the exact recurrence from ``S_c``.  No ratio of decay products and no
    log-space sum, so w = 0 and w = 1 are exact.  Steps past T are zeros
    in the last chunk, whose state is never passed on.  o in r's dtype,
    rounded once.
    """
    B, T, H, K = r.shape
    V = v.shape[-1]
    nc = -(-T // chunk)
    pad = nc * chunk - T

    def chunks(x):
        return F.pad(x.float(), (0, 0, 0, 0, 0, pad)).view(
            B, nc, chunk, H, x.shape[-1])
    rc, kc, vc, wc = (chunks(x) for x in (r, k, v, w))
    uf = u.float()[:, :, None]                                 # (H, K, 1)

    def kv_at(j):
        return kc[:, :, j, :, :, None] * vc[:, :, j, :, None, :]
    # 1. each chunk's own end state and decay product
    L = torch.zeros(B, nc, H, K, V, dtype=torch.float32, device=r.device)
    D = torch.ones(B, nc, H, K, dtype=torch.float32, device=r.device)
    for j in range(chunk):
        L = wc[:, :, j, :, :, None] * L + kv_at(j)
        D = D * wc[:, :, j]
    # 2. the state entering each chunk
    states = [torch.zeros(B, H, K, V, dtype=torch.float32, device=r.device)]
    for c in range(1, nc):
        states.append(D[:, c - 1, :, :, None] * states[-1] + L[:, c - 1])
    S = torch.stack(states, 1)                                # (B, nc, H, K, V)
    # 3. each chunk's outputs
    out = torch.empty(B, nc, chunk, H, V, dtype=torch.float32,
                      device=r.device)
    for j in range(chunk):
        kv = kv_at(j)
        out[:, :, j] = torch.einsum("bchk,bchkv->bchv", rc[:, :, j],
                                    S + uf * kv)
        S = wc[:, :, j, :, :, None] * S + kv
    return out.reshape(B, nc * chunk, H, V)[:, :T].to(r.dtype)


def mamba2_ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
               c: torch.Tensor) -> torch.Tensor:
    """Mamba-2 SSD recurrence (state-space dual), per head.

    x: (B, T, H, P); a: (B, T, H) decay exponents; b, c: (B, T, N), shared
    across heads.  ``h_t = exp(a_t) h_{t-1} + b_t ⊗ x_t``, ``y_t = c_t ·
    h_t``, h from zero.  Returns y: (B, T, H, P) in x's dtype.
    """
    B, T, H, P = x.shape
    N = b.shape[-1]
    xf, af, bf, cf = (t.float() for t in (x, a, b, c))
    h = torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)
    y = torch.empty(B, T, H, P, dtype=torch.float32, device=x.device)
    for t in range(T):
        h = (torch.exp(af[:, t])[:, :, None, None] * h
             + bf[:, t, None, :, None] * xf[:, t, :, None, :])
        y[:, t] = torch.einsum("bn,bhnp->bhp", cf[:, t], h)
    return y.to(x.dtype)


def mamba2_ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                       c: torch.Tensor, chunk: int = 64) -> torch.Tensor:
    """:func:`mamba2_ssd` in the chunked form of Mamba-2 (Dao and Gu,
    arXiv:2405.21060, §6), the three steps of the K18 kernel in plain
    torch, for the tests.

    Per chunk of ``chunk`` steps, A is the chunk-local inclusive cumsum of
    a (in float64, as the kernel takes it, so that A_i − A_j is the segment
    sum; each exponent is then rounded to float32) and "last" the chunk's
    last step: (1) each chunk's state
    ``S = Σ_j exp(A_last − A_j) b_j ⊗ x_j``; (2) the state entering each
    chunk, ``H_0 = 0``, ``H_c = exp(A_last of c−1) H_{c−1} + S_{c−1}``;
    (3) ``y_i = Σ_{j ≤ i} exp(A_i − A_j) (c_i · b_j) x_j + exp(A_i) c_i ·
    H_c``, with j > i masked before the exp.  Steps past T are zeros (a =
    0 among them) and add nothing.  y in x's dtype, rounded once.
    """
    B, T, H, P = x.shape
    N = b.shape[-1]
    nc = -(-T // chunk)
    pad = nc * chunk - T
    xc = F.pad(x.float(), (0, 0, 0, 0, 0, pad)).view(B, nc, chunk, H, P)
    ac = F.pad(a.float(), (0, 0, 0, pad)).view(B, nc, chunk, H)
    bc, cc = (F.pad(t.float(), (0, 0, 0, pad)).view(B, nc, chunk, N)
              for t in (b, c))
    A = torch.cumsum(ac.double(), dim=2)                      # (B, nc, L, H)
    last = A[:, :, -1]                                        # (B, nc, H)
    # 1. each chunk's state
    w = torch.exp((last[:, :, None] - A).float())[..., None]  # (B, nc, L, H, 1)
    S = torch.einsum("bcjn,bcjhp->bchnp", bc, w * xc)
    # 2. the state entering each chunk
    states = [torch.zeros(B, H, N, P, dtype=torch.float32, device=x.device)]
    for k in range(1, nc):
        states.append(torch.exp(last[:, k - 1].float())[:, :, None, None]
                      * states[-1] + S[:, k - 1])
    Hc = torch.stack(states, 1)                               # (B, nc, H, N, P)
    # 3. each chunk's output
    G = torch.einsum("bcin,bcjn->bcij", cc, bc)
    seg = A[:, :, :, None, :] - A[:, :, None, :, :]           # A_i - A_j
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()
    seg = seg.masked_fill(~causal[:, :, None], -math.inf)
    M = G[..., None] * torch.exp(seg.float())                 # (B, nc, i, j, H)
    y = (torch.einsum("bcijh,bcjhp->bcihp", M, xc)
         + torch.exp(A.float())[..., None]
         * torch.einsum("bcin,bchnp->bcihp", cc, Hc))
    return y.reshape(B, nc * chunk, H, P)[:, :T].to(x.dtype)
