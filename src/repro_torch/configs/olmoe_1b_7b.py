"""olmoe-1b-7b: 64 experts, top-8 [arXiv:2409.02060; hf]."""
from .base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab=50304,
    moe=MoEConfig(num_experts=64, top_k=8, d_expert=1024),
    source="[arXiv:2409.02060; hf]",
)
