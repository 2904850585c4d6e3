"""The Model API over the ported architecture families.

Port of the reference's ``models/registry.py``.  ``build(cfg)`` returns a
:class:`Model` bound to a device (``None`` = the CUDA card; without one it
raises unless the caller passes ``device="cpu"``).  Only ``family ==
"dense"`` is ported; every other family raises ``NotImplementedError``
naming the slice that ports it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..configs.registry import get_config
from ..core.hts.machine import resolve_device
from . import layers as L
from . import transformer as T

#: the ROADMAP item (Queue 1) that ports each family not ported yet
LATER = {"moe": "5c (MoE and the VLM prefix)",
         "vlm": "5c (MoE and the VLM prefix)",
         "ssm": "5b (rwkv6-3b and zamba2-7b, K17 and K18)",
         "hybrid": "5b (rwkv6-3b and zamba2-7b, K17 and K18)",
         "audio": "5d (whisper)"}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    template: Any
    device: torch.device

    def init(self, seed: int = 0):
        """Random parameters on the model's device, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's draws)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        params = L.init_params(gen, self.template)
        return T.unstack_layers(params, self.cfg.n_layers)

    def param_count(self) -> int:
        return L.param_count(self.template)

    def prefill(self, params, tokens, max_len: int):
        return T.prefill(params, self.cfg, tokens, max_len)

    def decode_step(self, params, cache, tokens, pos):
        return T.decode_step(params, self.cfg, cache, tokens, pos)

    def chunk_step(self, params, cache, tokens, pos: int):
        return T.chunk_step(params, self.cfg, cache, tokens, pos)

    def init_cache(self, batch: int, max_len: int):
        return T.init_cache(self.cfg, batch, max_len, device=self.device)


def build(cfg: ArchConfig, device=None) -> Model:
    if cfg.family != "dense":
        item = LATER.get(cfg.family, "none yet")
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ROADMAP Queue 1 item {item})")
    return Model(cfg=cfg, template=T.template(cfg),
                 device=resolve_device(device))


def build_arch(arch: str, device=None) -> Model:
    return build(get_config(arch), device)


def build_smoke(arch: str, device=None) -> Model:
    return build(get_config(arch).smoke(), device)
