"""qwen2-moe-a2.7b: 4 shared + 60 routed experts, top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf].

60 routed experts are padded to 64 for even expert-parallel sharding over the
16-way model axis (padding experts receive no tokens; DESIGN.md §5).
"""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936, qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, d_expert=1408,
                  num_shared=4, d_shared=4 * 1408),
    source="[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]",
)
