#!/usr/bin/env python3
"""Time K12 ``correlation``, K7 ``adaptive_fir`` and K8 ``iir`` of one or
more checkouts of the port on one card, in turns.

    python3 tools/dsp_kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout of this repository.  Its
``src/repro_torch`` is imported in a subprocess of its own, so that two
versions never share an interpreter, and builds its kernels into
``TREE/build``.  Give the trees as parent, change, change, parent: both
versions are then timed on one card, in turns.  For each tree the script
prints one JSON line: for each case (kernel, B, N, taps, lag or the IIR's
(b, a), whether the second array is x itself, as the dispatch entries pass
it) the device
ms a launch (torch.profiler), the ms a call (CUDA events around 20 calls
after 3 warm-ups), the largest difference from the plain version, and the
bound (x read once where it is also the second array, and read twice),
beside the card's name and power limit.  The timing helpers are
``chip_smoke.py``'s.

A TREE written ``TREE+iir8`` is a copy of TREE whose K8 packed kernel
runs at 8 registers a history for every filter (``iir_packed<8>``, where
the tree launches ``iir_packed<2>`` for first-order filters), made under
``TREE/build/iir8``: ``. .+iir8 .+iir8 .`` times the two instances at the
dispatch entry's filter, in turns.
"""
from __future__ import annotations

import functools
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
#: (kernel, B, N, taps, lag or (b, a), second array is x): the image path's
#: K12 call and K12's row in PERF.md; K7 at Table II's shape, both ways; K8
#: there with the dispatch entry's filter and the JAX tests'
CASES = [("correlation", 262144, 64, 4, True),
         ("correlation", 65536, 256, 4, False),
         ("adaptive_fir", 524288, 40, 8, False),
         ("adaptive_fir", 524288, 40, 8, True),
         ("iir", 524288, 40, ([0.2, 0.3], [1.0, -0.5]), False),
         ("iir", 524288, 40, ([0.2, 0.3, 0.1], [1.0, -0.4, 0.05]), False)]


#: the K8 launcher's first-order instance, and what ``+iir8`` puts there
IIR_FIRST_ORDER = "&iir_packed<2>"
IIR_PINNED = "&iir_packed<IIR_REG_TAPS>"


def pinned_iir8(tree: Path) -> Path:
    """A copy of ``tree``'s ``src`` under ``tree/build/iir8`` whose K8
    launcher takes ``iir_packed<8>`` for every filter."""
    dst = tree / "build" / "iir8"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(tree / "src", dst / "src",
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    cu = dst / "src" / "repro_torch" / "csrc" / "dsp.cu"
    text = cu.read_text()
    assert text.count(IIR_FIRST_ORDER) == 1, "no first-order K8 instance"
    cu.write_text(text.replace(IIR_FIRST_ORDER, IIR_PINNED))
    return dst


def one(tree: Path) -> dict:
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs                     # puts HERE/src on the path
    sys.path.insert(0, str(tree / "src"))       # ... and the tree before it
    import torch
    from repro_torch.kernels import common, dsp_fir, dsp_vector, ref
    assert Path(common.__file__).resolve().is_relative_to(tree.resolve())
    common.LIB.load()
    kern = dict(fir=dsp_fir, vec=dsp_vector, ref=ref)
    out = {"tree": str(tree), "card": cs.card_line(), "cases": []}
    for i, (name, b, n, p, alias) in enumerate(CASES):
        wrapper, plain, args = cs.dsp_case(torch, kern, name, b, n, p, 300 + i,
                                           alias=alias)
        got = wrapper(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        assert cs.same(torch, got, want, cs.DSP_TOL[name]), name
        calls = [functools.partial(wrapper, *args)] * 23
        out["cases"].append(dict(
            name=name, shape=[b, n], p=p, alias=alias,
            max_abs_err=cs.max_err(got, want),
            ms=cs.profiled_ms(torch, calls, cs.DSP_KERNEL[name]),
            call_ms=cs.events_ms(torch, calls),
            bound_ms=cs.dsp_bound(name, args)[0],
            bound_two_reads_ms=cs.dsp_bound(name, args, once=False)[0]))
    return out


def main(argv: list[str]) -> int:
    if argv[:1] == ["--one"]:
        print(json.dumps(one(Path(argv[1]))), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv:
        if tree.endswith("+iir8"):
            tree = str(pinned_iir8(Path(tree[:-len("+iir8")]).resolve()))
        rc |= subprocess.run([sys.executable, __file__, "--one", tree]
                             ).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
