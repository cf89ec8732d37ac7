"""qwen1.5-0.5b [dense]: QKV-bias decoder with tied embeddings.

24L d_model=1024 16H (GQA kv=16) d_ff=2816 vocab=151936.
[hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-0.5b",
    family="dense",
    source="hf:Qwen/Qwen1.5-0.5B",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    loss_chunk=512,
    optimizer="adamw",
)
