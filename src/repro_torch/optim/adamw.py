"""Functional AdamW with global-norm clipping.

Port of the reference's ``optim/adamw.py``.  The state mirrors the
parameter tree (``m``, ``v``) beside an int32 ``step``.  The reference
donates its state to the jitted step; here :func:`update` writes the
parameters, ``m`` and ``v`` in place (under ``torch.no_grad``) and returns
them, in the reference's float32 arithmetic and order.  A Python scalar on
the left of a tensor division is ``reciprocal() * scalar`` in torch, and
a Python float power is float64: both are written as float32 tensor ops
so that the rounding is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.layers import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak; scheduled externally
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def init(params) -> dict[str, Any]:
    """Zero ``m`` and ``v`` shaped as ``params`` and a 0-d int32 ``step``,
    on the parameters' device."""
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of the sum of squares, in float32
    (the leaves in the tree's order: the reference sums its own sorted,
    stacked leaves, so the two agree to rounding, not bit for bit)."""
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig, lr_scale=1.0):
    """One AdamW step: returns (params, state, metrics) with the
    parameters, ``m`` and ``v`` updated in place and ``step`` one more;
    the metrics ``grad_norm``, ``lr`` and ``clip`` are 0-d float32
    tensors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp_max(_f32(cfg.grad_clip, gnorm) / (gnorm + 1e-9), 1.0)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=gnorm.device)
    t = step.to(torch.float32)
    b1c = 1.0 - torch.pow(_f32(cfg.b1, t), t)
    b2c = 1.0 - torch.pow(_f32(cfg.b2, t), t)
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state["m"]),
                          tree_leaves(state["v"]), tree_leaves(params)):
        g = g.float() * clip
        m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p
        p.sub_(lr * upd)
    metrics = {"grad_norm": gnorm, "lr": lr, "clip": clip}
    return params, {"m": state["m"], "v": state["v"], "step": step}, metrics
