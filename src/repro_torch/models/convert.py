"""Carry the reference's parameters into the port.

``params_from_reference`` takes the JAX package's parameter tree as numpy
arrays (its template's tree: ``layers`` stacked on a leading L axis for
the dense and ssm families; zamba2's ``groups`` stacked (n_groups,
period), ``shared`` and ``tail`` on one axis each; whisper's
``enc_layers`` and ``dec_layers`` on one axis each) and the model's config,
and returns the port's: every leaf cast once to ``COMPUTE_DTYPE`` (the
cast the reference makes at every use) but the ones the family reads
uncast (its module's ``FLOAT32_LEAVES``, kept float32), and the family's
``STACKED`` subtrees split into lists (``layers.unstack_params``).  With
it both packages compute the same function, which is how the tests hold
the port to the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.hts.machine import resolve_device
from . import layers as L
from .registry import FAMILIES


def params_from_reference(tree, cfg, device=None) -> dict:
    """The port's parameters of a ``cfg`` model from the reference's numpy
    tree, on ``device`` (``None`` = the card), in the dtypes of
    ``layers.leaf_dtype`` (read at call time)."""
    dev = resolve_device(device)
    impl = FAMILIES[cfg.family]

    def leaf(a, name):
        t = torch.from_numpy(np.array(a, dtype=np.float32))
        return t.to(device=dev, dtype=L.leaf_dtype(name, impl.FLOAT32_LEAVES))

    return L.unstack_params(L.tree_map_named(leaf, tree), impl.STACKED)
