"""Carry the reference's parameters into the port.

``params_from_reference`` takes the JAX package's parameter tree as numpy
arrays (``{"embed", "layers": {...every leaf stacked on a leading L
axis}, "final_norm", "lm_head"}``, ``models/transformer.py``'s template)
and returns the port's: every leaf cast once to ``COMPUTE_DTYPE`` (the
cast the reference makes at every use), the layers split into a list.
With it both packages compute the same function, which is how the tests
hold the port to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.hts.machine import resolve_device
from . import layers as L
from . import transformer as T


def params_from_reference(tree, device=None) -> dict:
    """The port's parameters from the reference's numpy tree, on
    ``device`` (``None`` = the card) in ``COMPUTE_DTYPE`` (read at call
    time)."""
    dev = resolve_device(device)

    def leaf(a):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=L.COMPUTE_DTYPE)

    params = L.tree_map(leaf, tree)
    return T.unstack_layers(params, params["layers"]["ln1"].shape[0])
