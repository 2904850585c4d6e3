"""K18 ``ssd``, the Mamba-2 SSD recurrence: the CUDA kernel
(``csrc/transformer.cu``) and its wrapper.

Counterpart of the reference's ``kernels/mamba2.py``.  Per sequence and
head, state h (N, P) from zero: ``h ← exp(a_t) h + b_t ⊗ x_t``, ``y_t = c_t
· h``.  x, b and c are float32 or bfloat16 of one dtype; a is float32
whatever x's dtype (on the model path it is the float32 product of
``a_log`` and ``dt``).  The kernel computes it in the chunked form of
Mamba-2 (chunks of :data:`KERNEL_CHUNK` steps: each chunk's state, the
states passed from chunk to chunk, then each chunk's output;
``ref.mamba2_ssd_chunked`` is the plain mirror), in float32, and rounds
the output once to x's dtype; N is at most ``MAX_STATE``, P any width.
The kernel masks the ragged end of T itself: the reference's last chunk
reads past T.
"""
from __future__ import annotations

import torch

from . import ref
from .common import DTYPE_CODES, MAX_STATE, TRANSFORMER_LIB, check, on_card

#: the reference kernel's time block
DEFAULT_CHUNK = 64
#: the CUDA kernel's own chunk (``SSD_L`` in ``csrc/transformer.cu``)
KERNEL_CHUNK = 64


def scratch_floats(B: int, T: int, H: int, P: int, N: int) -> int:
    """float32 words of the kernel's scratch: the state entering each chunk
    but the first, (B, chunks - 1, H, N, P), then the decay exponent A_last
    of each chunk that has a successor, (B, chunks - 1, H)."""
    passed = max(0, -(-T // KERNEL_CHUNK) - 1)
    return B * passed * H * (N * P + 1)


def ssd(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
        *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """x: (B, T, H, P); a: (B, T, H) float32; b, c: (B, T, N) → y: (B, T,
    H, P) in x's dtype.

    ``chunk`` is the reference's time block, kept for API parity: it does
    not change the result (the kernel chunks time its own way)."""
    del chunk
    if x.dim() != 4 or b.dim() != 3:
        raise ValueError(f"x must be (B, T, H, P) and b (B, T, N), got "
                         f"{tuple(x.shape)} and {tuple(b.shape)}")
    B, T, H, P = x.shape
    N = b.shape[-1]
    dev = x.device
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"ssd takes {list(DTYPE_CODES)}, got {x.dtype}")
    check("x", x, dev, (B, T, H, P), x.dtype)
    check("a", a, dev, (B, T, H), torch.float32)
    check("b", b, dev, (B, T, N), x.dtype)
    check("c", c, dev, (B, T, N), x.dtype)
    if not on_card(dev):
        return ref.mamba2_ssd(x, a, b, c)
    if N > MAX_STATE:
        raise ValueError(f"the ssd kernel keeps N <= {MAX_STATE} state rows "
                         f"in its shared-memory tiles, got N = {N}")
    out = torch.empty_like(x)
    scratch = torch.empty(scratch_floats(B, T, H, P, N), dtype=torch.float32,
                          device=dev)
    TRANSFORMER_LIB.launch("tf_ssd", "ssd", B, T, H, P, N,
                           DTYPE_CODES[x.dtype], x, a, b, c, out, scratch)
    return out
