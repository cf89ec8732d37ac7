"""deepseek-v2-lite-16b [moe]: MLA attention + fine-grained MoE.

27L d_model=2048 16H kv_lora_rank=512 d_ff=1408 vocab=102400,
64 routed experts top-6 + 2 shared experts, first layer dense.
Decode caches only (c_kv, k_rope) — the MLA compression — and runs the
absorbed attention form.  [arXiv:2405.04434]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="arXiv:2405.04434",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    use_mla=True,
    kv_lora_rank=512,
    qk_rope_dim=64,
    n_experts=64,
    top_k=6,
    n_shared_experts=2,
    first_dense_layers=1,
    loss_chunk=512,
    optimizer="adamw",
)
