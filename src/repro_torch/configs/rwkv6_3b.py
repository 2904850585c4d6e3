"""rwkv6-3b (Finch): attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv_heads=40,   # 40 wkv heads × 64
    d_ff=8960, vocab=65536, d_head=64,
    ssm=SSMConfig(kind="rwkv6", d_state=64, head_dim=64),
    source="[arXiv:2404.05892; hf]",
)
