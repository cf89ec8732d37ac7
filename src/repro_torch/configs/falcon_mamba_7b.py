"""falcon-mamba-7b [ssm]: pure Mamba-1, attention-free.

64L d_model=4096 d_inner=8192 ssm_state=16 vocab=65024.  Decode is an
O(1) recurrent-state update, so long_500k runs natively.
[arXiv:2410.05355]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="arXiv:2410.05355",
    n_layers=64,
    d_model=4096,
    n_heads=1,
    n_kv_heads=1,
    d_ff=0,
    vocab_size=65024,
    ssm_variant="mamba1",
    ssm_state=16,
    d_inner=8192,
    dt_rank=256,
    optimizer="adamw",
)
