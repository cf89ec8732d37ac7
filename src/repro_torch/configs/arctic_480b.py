"""arctic-480b [moe]: Snowflake Arctic base — dense-MoE hybrid.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, 128 experts top-2
routed MoE in parallel with a dense residual FFN on every layer.
Memory plan: bf16 params + Adafactor (factored second moment) — Adam
moments for 470B params do not fit a 16 GB/chip single pod.
[hf:Snowflake/snowflake-arctic-base]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b",
    family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    pad_heads_to=64,   # 56 !% 16-way TP: activation-layout padding (layers.attention_fwd)
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab_size=32000,
    n_experts=128,
    top_k=2,
    first_dense_layers=0,
    moe_dense_residual=True,
    dense_residual_ff=4864,
    capacity_factor=1.25,
    param_dtype="bfloat16",
    optimizer="adafactor",
)
