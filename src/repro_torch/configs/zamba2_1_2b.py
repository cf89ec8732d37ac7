"""zamba2-1.2b [hybrid]: Mamba-2 backbone + shared attention blocks.

38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64.
The shared transformer block (concat(h, h0) input, params shared across
invocations) fires every 2 scanned Mamba-2 layers (19 invocations).
[arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="arXiv:2411.15242",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_variant="mamba2",
    ssm_state=64,
    d_inner=4096,
    ssm_head_dim=64,
    shared_attn_every=2,
    optimizer="adamw",
)
