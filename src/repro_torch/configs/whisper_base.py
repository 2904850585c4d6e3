"""whisper-base: enc-dec; conv frontend STUBBED — input_specs() provides
precomputed frame embeddings (B, T, d_model) [arXiv:2212.04356; unverified]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, enc_layers=6,
    source="[arXiv:2212.04356; unverified]",
)
