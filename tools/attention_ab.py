#!/usr/bin/env python3
"""Time bf16 K15 ``flash_attention`` of one or more checkouts of the port
on one card, in turns.

    python3 tools/attention_ab.py [--cases LABEL,...] TREE [TREE ...]

Each TREE is the root of a checkout of this repository.  Its
``src/repro_torch`` is imported in a subprocess of its own, so that two
versions never share an interpreter, and builds its kernels into
``TREE/build``.  Give the trees as parent, change, change, parent: both
versions are then timed on one card, in turns.  For each tree the script
prints one JSON line: for each case (``CASES``: the models' calls of K15)
and each bf16 instance the tree has at that head dim (its
``attention.INSTANCES``; one, unnamed, where it has none; a head dim the
tree refuses is left out), the device ms a launch (torch.profiler), the ms
a call (CUDA events around 20 calls after 3 warm-ups), the largest
difference from the plain version and the bound, beside the card's name
and power limit.  ``--cases`` keeps the cases of those labels only.  The
timing helpers are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import functools
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
#: (label, (BH, Tq, Tk, D, causal, q_offset)): Qwen2-1.5B's prefill 4 x
#: 2048, zamba2-7b's forward 2 x 1024, paligemma-3b's two calls a layer at
#: B = 2, a causal square and the square unmasked (every CTA the same
#: work: the kernel's rate without the causal tail), a ragged chunk after
#: 1000 positions (chip_smoke 12a's), phi3-mini-3.8b's prefill 4 x 2048
CASES = [("qwen2_prefill", (48, 2048, 2048, 128, True, 0)),
         ("zamba2_forward", (64, 1024, 1024, 112, True, 0)),
         ("d256_text", (16, 1792, 2048, 256, True, 256)),
         ("d256_prefix", (16, 256, 256, 256, False, 0)),
         ("d256_square", (16, 2048, 2048, 256, True, 0)),
         ("d256_full", (16, 2048, 2048, 256, False, 0)),
         ("d256_ragged", (16, 300, 1300, 256, True, 1000)),
         ("phi3_prefill", (128, 2048, 2048, 96, True, 0))]


def one(tree: Path, labels: set) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path
    sys.path.insert(0, str(tree / "src"))       # ... and the tree before it
    import torch
    from repro_torch.kernels import attention, common, ref
    assert Path(common.__file__).resolve().is_relative_to(tree.resolve())
    common.TRANSFORMER_LIB.load()
    out = {"tree": str(tree), "card": cs.card_line(), "cases": []}
    for i, (label, shape) in enumerate(CASES):
        d = shape[3]
        if d not in attention.HEAD_DIMS or labels and label not in labels:
            continue
        q, k, v, causal, q_offset = cs.tf_case(
            torch, "flash_attention", shape, torch.bfloat16, 700 + i)
        kw = dict(causal=causal, q_offset=q_offset)
        want = cs.plain_attention(ref, q, k, v, **kw)
        names = tuple(getattr(attention, "INSTANCES", {}).get(d, ())) or (
            None,)
        for inst in names:
            call = functools.partial(attention.flash_attention, q, k, v,
                                     **kw, **({} if inst is None else
                                              {"instance": inst}))
            got = call()
            torch.cuda.synchronize()
            err = cs.max_err(got.float(), want.float())
            assert err <= cs.TF_TOL["bfloat16"][1], (label, inst, err)
            calls = [call] * 23
            out["cases"].append(dict(
                label=label, shape=list(shape), instance=inst,
                max_abs_err=err,
                ms=cs.profiled_ms(torch, calls,
                                  cs.TF_KERNEL["flash_attention"]),
                call_ms=cs.events_ms(torch, calls),
                bound_ms=cs.tf_bound("flash_attention",
                                     (q, k, v, causal, q_offset))[0]))
    return out


def main(argv: list[str]) -> int:
    cases = []
    if argv[:1] == ["--cases"]:
        cases, argv = argv[:2], argv[2:]
    if argv[:1] == ["--one"]:
        labels = set(argv[3].split(",")) if len(argv) > 3 else set()
        print(json.dumps(one(Path(argv[1]), labels)), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv:
        rc |= subprocess.run([sys.executable, __file__, "--one", tree]
                             + cases).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
