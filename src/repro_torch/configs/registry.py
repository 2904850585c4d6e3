"""--arch <id> registry for the assigned architecture pool."""
from __future__ import annotations

import importlib

from .base import ArchConfig

ARCHS = {
    "yi-34b": "yi_34b",
    "command-r-plus-104b": "command_r_plus_104b",
    "phi3-mini-3.8b": "phi3_mini_3_8b",
    "qwen2-1.5b": "qwen2_1_5b",
    "rwkv6-3b": "rwkv6_3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "paligemma-3b": "paligemma_3b",
    "zamba2-7b": "zamba2_7b",
    "whisper-base": "whisper_base",
}


def get_config(arch: str) -> ArchConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    return mod.CONFIG


def all_archs() -> list[str]:
    return list(ARCHS)
