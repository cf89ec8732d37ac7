"""llava-next-34b [vlm]: large decoder LM consuming ViT patch embeddings.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.  The vision tower
is STUBBED per the task rules: input_specs() provides precomputed patch
embeddings (B, 576, 1024) — one anyres base tile — which the learned
two-layer projector maps into the LM embedding space.
[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava-next-34b",
    family="vlm",
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    pad_heads_to=64,   # 56 !% 16-way TP: activation-layout padding (layers.attention_fwd)
    n_kv_heads=8,
    head_dim=128,
    d_ff=20480,
    vocab_size=64000,
    modality="vision",
    n_modal_tokens=576,
    optimizer="adafactor",
)
