"""K15 ``flash_attention`` (forward): the CUDA kernels
(``csrc/transformer.cu``) and their wrapper.

Counterpart of the reference's ``kernels/attention.py``.  The kernels take
heads already flattened and GQA already repeated (``ops.flash_attention``
does both), head dims 32, 64, 96 (phi3-mini-3.8b), 112 (zamba2-7b's
shared attention), 128 and 256 (paligemma-3b).  bfloat16 runs on the
tensor cores (``wgmma``, fed by TMA, so q, k and v start on 16-byte
boundaries: the wrapper copies one that does not); float32 runs on the
CUDA cores.  Both mask keys at index ``>= Tk`` themselves: the reference
kernel's last key block reads past ``Tk`` and returns NaN when ``Tk`` is
above its block of 128 and not a multiple of it.

In bfloat16, head dim 256 has two kernel instances (:data:`INSTANCES`);
:func:`d256_instance` chooses one for a call, and a caller may name one
(``instance=``) to time or test it on its own.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .common import DTYPE_CODES, TRANSFORMER_LIB, check, on_card

#: head dims the kernel is built for (a template parameter each)
HEAD_DIMS = (32, 64, 96, 112, 128, 256)
#: the bfloat16 instances a head dim may take, by name, with their codes in
#: the C entry: at 256 one consumer warpgroup of 64 query rows, or two of
#: 64 (ping-pong) beside a producer warpgroup
INSTANCES = {256: {"one_warpgroup": 1, "two_warpgroups": 2}}
#: the two-warpgroup instance's query rows a CTA
D256_ROWS = 128


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def d256_instance(BH: int, Tq: int, device: torch.device) -> str:
    """The bfloat16 instance a call of K15 at head dim 256 takes on
    ``device``: the two-warpgroup instance where its grid (a CTA a 128
    query rows of a head) fills the card's SMs once, else the
    one-warpgroup instance, which has twice the CTAs (chip_smoke 12a
    times both; PERF.md §6)."""
    ctas = BH * -(-Tq // D256_ROWS)
    return ("two_warpgroups" if ctas >= _sm_count(device)
            else "one_warpgroup")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_offset: int = 0,
                    instance: str | None = None) -> torch.Tensor:
    """q: (BH, Tq, D); k, v: (BH, Tk, D) → (BH, Tq, D) in q's dtype.

    ``q_offset`` (>= 0) positions q[0] at absolute key index ``q_offset``
    (chunked prefill, decode append).  ``instance`` names a bfloat16
    instance of :data:`INSTANCES` at head dim 256 (None: the one
    :func:`d256_instance` chooses); the plain version ignores it."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"q and k must be (BH, T, D), got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    BH, Tq, D = q.shape
    Tk = k.shape[1]
    dev = q.device
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention takes {list(DTYPE_CODES)}, got "
                        f"{q.dtype}")
    check("q", q, dev, (BH, Tq, D), q.dtype)
    check("k", k, dev, (BH, Tk, D), q.dtype)
    check("v", v, dev, (BH, Tk, D), q.dtype)
    if Tk < 1:
        raise ValueError("flash_attention needs at least one key")
    if not isinstance(q_offset, int) or q_offset < 0:
        raise ValueError(f"q_offset must be an int >= 0, got {q_offset!r}")
    if instance is not None and (q.dtype != torch.bfloat16
                                 or instance not in INSTANCES.get(D, ())):
        raise ValueError(f"no {q.dtype} instance {instance!r} at head dim "
                         f"{D} (bfloat16: {INSTANCES})")
    if scale is None:
        scale = D ** -0.5
    if not on_card(dev):
        return ref.flash_attention(q[:, None], k[:, None], v[:, None],
                                   causal=causal, scale=scale,
                                   q_offset=q_offset)[:, 0]
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims "
                         f"{HEAD_DIMS}, got {D}")
    code = 0
    if q.dtype == torch.bfloat16:
        q, k, v = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (q, k, v))
        if D in INSTANCES:
            code = INSTANCES[D][instance or d256_instance(BH, Tq, dev)]
    out = torch.empty_like(q)
    TRANSFORMER_LIB.launch("tf_flash_attention", "flash_attention", BH, Tq,
                           Tk, D, DTYPE_CODES[q.dtype], code, int(causal),
                           q_offset, float(scale), q, k, v, out)
    return out
