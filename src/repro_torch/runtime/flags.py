"""Performance feature flags (§Perf hillclimbing: baseline vs optimized).

The paper-faithful/baseline lowering keeps all flags False; each hillclimb
iteration toggles one flag so EXPERIMENTS.md §Perf can record isolated
before/after roofline terms (hypothesis → change → measure → validate).

The port's copy of the reference's ``runtime/flags.py``.  The port runs the
default path, all flags False, and keeps only the flags its model reads:
``moe_grouped`` (``models/transformer.py`` ``moe_apply``: the grouped
dispatch), ``decode_gqa_packed`` (``models/layers.py``
``decode_attention``: the grouped-query contraction) and
``decode_kv_int8`` (``models/transformer.py``: the int8 cache of
``init_cache``, chosen by ``decode_step`` where the cache has ``k_s``,
and its ``cache_axes``).  The reference's fourth,
``decode_kv_seq_shard``, is not here, so ``use_flags`` refuses it with a
``TypeError``: it only changes sharding rules, which one card does not
have.
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class PerfFlags:
    #: MoE: GShard-style grouped dispatch — per-sequence position cumsum
    #: (data-sharded, short) instead of one global replicated cumsum.
    moe_grouped: bool = False
    #: decode attention: grouped-query einsum without materializing the
    #: GQA-repeated (and fp32-cast) K/V cache.
    decode_gqa_packed: bool = False
    #: decode: int8 KV cache with per-(token, head) scales — halves cache
    #: bytes and cache-side collective traffic (transformer family,
    #: scalar-pos decode path).
    decode_kv_int8: bool = False


FLAGS = PerfFlags()


@contextlib.contextmanager
def use_flags(**kw):
    global FLAGS
    prev = FLAGS
    FLAGS = dataclasses.replace(prev, **kw)
    try:
        yield FLAGS
    finally:
        FLAGS = prev

