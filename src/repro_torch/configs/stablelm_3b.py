"""stablelm-3b [dense]: StableLM family (LayerNorm trunk, full MHA).

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b",
    family="dense",
    source="hf:stabilityai/stablelm-2-1_6b",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=6912,
    vocab_size=50304,
    norm="layernorm",
    optimizer="adamw",
)
