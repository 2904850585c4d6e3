"""Performance feature flags (§Perf hillclimbing: baseline vs optimized).

The paper-faithful/baseline lowering keeps all flags False; each hillclimb
iteration toggles one flag so EXPERIMENTS.md §Perf can record isolated
before/after roofline terms (hypothesis → change → measure → validate).

The port's copy of the reference's ``runtime/flags.py``.  The port runs the
default path, all flags False, and keeps only the flags its model reads:
``decode_gqa_packed`` and ``decode_kv_int8``, each of which raises
``NotImplementedError`` naming ROADMAP Queue 1 item 5e where it is read,
until a slice ports it.  The reference's other two are not here, so
``use_flags`` refuses them with a ``TypeError``: ``moe_grouped`` comes with
the MoE layer (item 5c), and ``decode_kv_seq_shard`` only changes sharding
rules, which one card does not have.
"""
from __future__ import annotations

import contextlib
import dataclasses


@dataclasses.dataclass
class PerfFlags:
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

