"""paligemma-3b: SigLIP frontend (stubbed) + gemma MQA decoder [arXiv:2407.07726; hf].

The vision tower is a STUB per the assignment: input_specs() provides
precomputed patch embeddings (B, 256, d_model); the transformer backbone is
what is modeled (prefix-LM attention over the image prefix).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
    d_ff=16384, vocab=257216, d_head=256, prefix_len=256,
    source="[arXiv:2407.07726; hf]",
)
