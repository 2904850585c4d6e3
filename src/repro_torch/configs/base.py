"""Architecture / shape configuration dataclasses.

The port's copy of the reference's ``configs/base.py`` (without the
dry-run's shape suite, which nothing here runs yet).  Every assigned
architecture gets one module in this package defining ``CONFIG`` (exact
published dims) — see registry.py for the ``--arch <id>`` lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                  # per-expert FFN hidden dim
    num_shared: int = 0            # always-on shared experts (qwen2-moe)
    d_shared: int = 0              # hidden dim of the shared expert block
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str                      # "rwkv6" | "mamba2"
    d_state: int = 64              # N (mamba2) / head key dim (rwkv6)
    head_dim: int = 64             # P (mamba2) / head value dim (rwkv6)
    conv_kernel: int = 4           # mamba2 depthwise conv width
    expand: int = 2                # mamba2 inner expansion


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                # 0 → d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    shared_attn_period: int = 0    # zamba2: shared attn block every k layers
    n_shared_blocks: int = 0       # zamba2: alternating shared blocks
    enc_layers: int = 0            # whisper: encoder depth (n_layers = decoder)
    prefix_len: int = 0            # paligemma: image-token prefix length
    source: str = ""               # provenance note ([arXiv/hf; tier])

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        replace = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(4, max(1, self.n_kv_heads * 4 // self.n_heads)),
            d_ff=256,
            vocab=512,
            d_head=32,
            enc_layers=min(self.enc_layers, 2),
            prefix_len=min(self.prefix_len, 8),
            shared_attn_period=2 if self.shared_attn_period else 0,
            n_shared_blocks=min(self.n_shared_blocks, 2),
        )
        if self.moe:
            replace["moe"] = MoEConfig(
                num_experts=8, top_k=2, d_expert=64,
                num_shared=min(self.moe.num_shared, 1),
                d_shared=64 if self.moe.num_shared else 0)
        if self.ssm:
            replace["ssm"] = dataclasses.replace(
                self.ssm, d_state=16, head_dim=16)
        return dataclasses.replace(self, **replace)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode
