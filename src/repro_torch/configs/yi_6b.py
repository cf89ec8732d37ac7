"""yi-6b [dense]: llama-architecture GQA decoder.

32L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.  [arXiv:2403.04652]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b",
    family="dense",
    source="arXiv:2403.04652",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    optimizer="adamw",
)
