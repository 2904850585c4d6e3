"""K9 ``vector_dot`` and K12 ``correlation``: CUDA kernels
(``csrc/dsp.cu``) and their wrappers.

Counterpart of the reference's ``kernels/dsp_vector.py``.  ``vector_add``
and ``vector_max`` are not ported yet (ROADMAP.md Queue 2).
"""
from __future__ import annotations

import torch

from . import ref
from .common import check, launch, on_card

#: the correlation kernel stages a row of x and a zero-padded row of y in
#: shared memory: (2N + 2L) floats must fit the 48 KB a block may use.
#: Checked on the card route only (the plain version takes any size); the
#: C entry refuses the same sizes as a backstop.
CORR_MAX_SPAN = 6144


def _rows(name: str, x: torch.Tensor) -> tuple[int, int]:
    if x.dim() != 2:
        raise ValueError(f"{name} must be (B, N), got {tuple(x.shape)}")
    return tuple(x.shape)


def vector_dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N) · (B, N) → (B,)"""
    B, N = _rows("x", x)
    dev = x.device
    check("x", x, dev, (B, N))
    check("y", y, dev, (B, N))
    if not on_card(dev):
        return ref.vector_dot(x, y)
    out = torch.empty(B, dtype=x.dtype, device=dev)
    launch("vector_dot", B, N, x, y, out)
    return out


def correlation(x: torch.Tensor, y: torch.Tensor,
                max_lag: int) -> torch.Tensor:
    """Sliding cross-correlation, lags in [-max_lag, max_lag]:
    (B, N) × 2 → (B, 2*max_lag + 1), column 0 = lag -max_lag."""
    B, N = _rows("x", x)
    dev = x.device
    check("x", x, dev, (B, N))
    check("y", y, dev, (B, N))
    if not isinstance(max_lag, int) or max_lag < 0:
        raise ValueError(f"max_lag must be an int >= 0, got {max_lag!r}")
    if not on_card(dev):
        return ref.correlation(x, y, max_lag)
    if N + max_lag > CORR_MAX_SPAN:
        raise ValueError(f"the correlation kernel takes N + max_lag <= "
                         f"{CORR_MAX_SPAN}, got {N} + {max_lag}")
    out = torch.empty(B, 2 * max_lag + 1, dtype=x.dtype, device=dev)
    launch("correlation", B, N, max_lag, x, y, out)
    return out
