"""The Model API over the ported architecture families.

Port of the reference's ``models/registry.py``.  ``build(cfg)`` returns a
:class:`Model` bound to a device (``None`` = the CUDA card; without one it
raises unless the caller passes ``device="cpu"``).  Every family of the
reference is ported: ``dense``, ``moe`` and ``vlm``
(:mod:`.transformer`), ``ssm`` (:mod:`.rwkv6`), ``hybrid``
(:mod:`.zamba2`) and ``audio`` (:mod:`.whisper`), each with its
``train_loss`` (:meth:`Model.train_loss`, on the float32 masters of
:meth:`Model.init_masters`).
"""
from __future__ import annotations

import dataclasses
import math
from types import ModuleType
from typing import Any

import torch

from ..configs.base import ArchConfig
from ..configs.registry import get_config
from ..core.hts.machine import resolve_device
from . import layers as L
from . import rwkv6 as R
from . import transformer as T
from . import whisper as W
from . import zamba2 as Z

#: the module that implements each family
FAMILIES = {"dense": T, "moe": T, "vlm": T, "ssm": R, "hybrid": Z,
            "audio": W}


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    template: Any
    device: torch.device
    impl: ModuleType          # the family's module (``FAMILIES``)

    def init(self, seed: int = 0):
        """Random parameters on the model's device, drawn from a
        ``torch.Generator`` seeded with ``seed`` (not JAX's draws)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        return L.unstack_params(
            L.init_params(gen, self.template, self.impl.FLOAT32_LEAVES),
            self.impl.STACKED)

    def init_masters(self, seed: int = 0):
        """float32 master parameters for training (the reference's
        ``init``): :meth:`init`'s draws unrounded, every leaf float32, the
        family's ``STACKED`` subtrees split into lists of leaves that own
        their storage (each takes its own gradient and update)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        stacked = L.init_params(gen, self.template, masters=True)
        return L.tree_map(torch.clone,
                          L.unstack_params(stacked, self.impl.STACKED))

    def train_loss(self, params, batch, remat_policy: str = "nothing"):
        """The family's training loss of ``batch`` (``tokens``,
        ``labels``; the vlm's ``prefix_embeds``, the audio family's
        ``frames``), a float32 0-d tensor, each layer under
        ``remat_policy`` (``"none"``, ``"nothing"`` or ``"dots"``).
        ``params`` are float32 masters (:meth:`init_masters`), cast at
        each use as the reference casts them."""
        return self.impl.train_loss(params, self.cfg, batch, remat_policy)

    def param_count(self) -> int:
        return L.param_count(self.template)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed experts scaled k/E)."""
        total = 0
        m = self.cfg.moe

        def walk(node, keys):
            nonlocal total
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, keys + (k,))
                return
            n = math.prod(node.shape)
            if m and "moe" in keys and "shared" not in keys \
                    and "router" not in keys:
                n = int(n * m.top_k / max(m.num_experts, 1))
            total += n
        walk(self.template, ())
        return total

    def _prefix(self, prefix_embeds) -> dict:
        if prefix_embeds is None:
            return {}
        if self.cfg.family != "vlm":
            raise ValueError(f"{self.cfg.name}: prefix_embeds are the vlm "
                             f"family's; this is {self.cfg.family!r}")
        return {"prefix_embeds": prefix_embeds}

    def _frames(self, frames) -> dict:
        audio = self.cfg.family == "audio"
        if audio and frames is None:
            raise ValueError(f"{self.cfg.name}: the audio family's forward "
                             "needs the encoder's frames")
        if frames is not None and not audio:
            raise ValueError(f"{self.cfg.name}: frames are the audio "
                             f"family's; this is {self.cfg.family!r}")
        return {} if frames is None else {"frames": frames}

    def forward(self, params, tokens, prefix_embeds=None, frames=None):
        """The sequence path of every family (the reference's
        family-uniform prefill, ``launch/dryrun.py`` ``_prefill_logits``):
        tokens (B, T) → logits (B, T, V); the vlm takes ``prefix_embeds``
        (B, P, D) before the tokens (then T' = P + T logits), the audio
        family the encoder's ``frames`` (B, Te, D)."""
        return self.impl.forward(params, self.cfg, tokens,
                                 **self._prefix(prefix_embeds),
                                 **self._frames(frames))[0]

    def _transformer_only(self, what: str):
        if self.impl is not T:
            raise NotImplementedError(
                f"{self.cfg.name}: {what} is the transformer families' (as "
                f"in the reference); the {self.cfg.family!r} family has "
                "forward and decode_step")

    def prefill(self, params, tokens, max_len: int, prefix_embeds=None):
        self._transformer_only("prefill")
        return T.prefill(params, self.cfg, tokens, max_len,
                         **self._prefix(prefix_embeds))

    def chunk_step(self, params, cache, tokens, pos: int):
        self._transformer_only("chunk_step")
        return T.chunk_step(params, self.cfg, cache, tokens, pos)

    def decode_step(self, params, cache, tokens, pos):
        return self.impl.decode_step(params, self.cfg, cache, tokens, pos)

    def init_cache(self, batch: int, max_len: int):
        return self.impl.init_cache(self.cfg, batch, max_len,
                                    device=self.device)

    @property
    def cache_axes(self) -> dict:
        """Each cache leaf's logical axes; ``"cache_batch"`` names its
        batch (slot) axis."""
        return self.impl.cache_axes(self.cfg)


def build(cfg: ArchConfig, device=None) -> Model:
    impl = FAMILIES.get(cfg.family)
    if impl is None:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")
    return Model(cfg=cfg, template=impl.template(cfg),
                 device=resolve_device(device), impl=impl)


def build_arch(arch: str, device=None) -> Model:
    return build(get_config(arch), device)


def build_smoke(arch: str, device=None) -> Model:
    return build(get_config(arch).smoke(), device)
