"""zamba2-7b: Mamba2 backbone + 2 alternating shared attention blocks
[arXiv:2411.15242; unverified]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm=SSMConfig(kind="mamba2", d_state=64, head_dim=64, expand=2),
    shared_attn_period=6, n_shared_blocks=2,
    source="[arXiv:2411.15242; unverified]",
)
