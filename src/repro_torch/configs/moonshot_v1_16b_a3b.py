"""moonshot-v1-16b-a3b [dense/MoE]: Moonlight-16B-A3B.

48L d_model=2048 16H (GQA kv=16) d_ff=1408 (per expert) vocab=163840,
MoE 64 experts top-6, DeepSeek-V3-style trunk: 2 shared experts, first
layer dense.  [hf:moonshotai/Moonlight-16B-A3B]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    source="hf:moonshotai/Moonlight-16B-A3B",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    capacity_factor=1.25,
    loss_chunk=512,
    optimizer="adamw",
)
