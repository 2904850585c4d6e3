"""K17 ``wkv6``, the RWKV-6 WKV recurrence: the CUDA kernel
(``csrc/transformer.cu``) and its wrapper.

Counterpart of the reference's ``kernels/rwkv6.py``.  Per row of BH
(heads already flattened by ``ops.rwkv6_scan``), state S (K, V) from zero:
``o_t = r_t (S + diag(u) k_tᵀ v_t)``, then ``S ← diag(w_t) S + k_tᵀ v_t``.
The kernel takes float32 or bfloat16 inputs of one dtype, keeps S in
float32 and rounds the output once to that dtype; K is at most
``MAX_STATE``, V any width.  It masks the ragged end of T itself: the
reference's last chunk reads past T.
"""
from __future__ import annotations

import torch

from . import ref
from .common import DTYPE_CODES, MAX_STATE, TRANSFORMER_LIB, check, on_card

#: the reference kernel's time block
DEFAULT_CHUNK = 64


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, *, chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """r, k, w: (BH, T, K); v: (BH, T, V); u: (BH, K) → o: (BH, T, V) in
    r's dtype.

    ``chunk`` is the reference's time block, kept for API parity: it does
    not change the result (the kernel stages time its own way)."""
    del chunk
    if r.dim() != 3 or v.dim() != 3:
        raise ValueError(f"r and v must be (BH, T, ·), got {tuple(r.shape)} "
                         f"and {tuple(v.shape)}")
    BH, T, K = r.shape
    V = v.shape[-1]
    dev = r.device
    if r.dtype not in DTYPE_CODES:
        raise TypeError(f"wkv6 takes {list(DTYPE_CODES)}, got {r.dtype}")
    for name, t in (("r", r), ("k", k), ("w", w)):
        check(name, t, dev, (BH, T, K), r.dtype)
    check("v", v, dev, (BH, T, V), r.dtype)
    check("u", u, dev, (BH, K), r.dtype)
    if not on_card(dev):
        # rows as heads of one sequence: (1, T, BH, ·), u per row
        o = ref.rwkv6_scan(*(t.transpose(0, 1)[None] for t in (r, k, v, w)),
                           u)
        return o[0].transpose(0, 1).contiguous()
    if K > MAX_STATE:
        raise ValueError(f"the wkv6 kernel keeps K <= {MAX_STATE} state "
                         f"rows in registers, got K = {K}")
    out = torch.empty(BH, T, V, dtype=r.dtype, device=dev)
    TRANSFORMER_LIB.launch("tf_wkv6", "wkv6", BH, T, K, V,
                           DTYPE_CODES[r.dtype], r, k, v, w, u, out)
    return out
