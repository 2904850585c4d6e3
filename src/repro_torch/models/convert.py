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
the port to the reference.  ``state_from_reference`` carries the
reference's training state (float32 masters, AdamW's moments and step)
across the same way, uncast, so that both packages take the same train
step from the same state.
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
    ``layers.leaf_dtype`` (read at call time; cast on the host)."""
    dev = resolve_device(device)
    impl = FAMILIES[cfg.family]
    params = L.cast_params(_float32(tree), impl.FLOAT32_LEAVES)
    return L.unstack_params(L.tree_map(lambda t: t.to(dev), params),
                            impl.STACKED)


def _float32(tree) -> dict:
    """The numpy tree as float32 tensors on the host."""
    return L.tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)


def masters_from_reference(tree, cfg, device=None) -> dict:
    """float32 masters (``Model.init_masters``'s form: the ``STACKED``
    subtrees split into leaves that own their storage) from the
    reference's numpy tree of the same shape (its parameters, or an
    optimizer moment of them), on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    split = L.unstack_params(_float32(tree), FAMILIES[cfg.family].STACKED)
    return L.tree_map(lambda t: t.to(dev, copy=True), split)


def state_from_reference(tree, cfg, device=None) -> dict:
    """The port's training state (``runtime.train.init_state``'s form)
    from the reference's ``{"params", "opt": {"m", "v", "step"}}`` as
    numpy: float32 masters and moments split as
    :func:`params_from_reference` splits them, and ``step`` a 0-d int32
    tensor, on ``device`` (``None`` = the card)."""
    dev = resolve_device(device)
    opt = tree["opt"]
    return {"params": masters_from_reference(tree["params"], cfg, dev),
            "opt": {"m": masters_from_reference(opt["m"], cfg, dev),
                    "v": masters_from_reference(opt["v"], cfg, dev),
                    "step": torch.tensor(int(np.asarray(opt["step"])),
                                         dtype=torch.int32, device=dev)}}
