"""Learning-rate schedules (scale factors applied to ``AdamWConfig.lr``).

Port of the reference's ``optim/schedule.py``: float32 arithmetic on a 0-d
tensor, in the reference's order of operations.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    if torch.is_tensor(step):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def warmup_cosine(step, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warm-up over ``warmup`` steps, then a cosine from 1 down to
    ``floor`` at ``total``; a float32 0-d tensor on ``step``'s device."""
    step = _f32(step)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos


def linear_warmup(step, warmup: int) -> torch.Tensor:
    return torch.clamp_max(_f32(step) / max(warmup, 1), 1.0)
