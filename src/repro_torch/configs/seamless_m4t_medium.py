"""seamless-m4t-medium [audio]: encoder-decoder transformer backbone.

12 encoder + 12 decoder layers, d_model=1024 16H d_ff=4096 vocab=256206.
The mel-spectrogram + conv frontend is STUBBED per the task rules:
input_specs() provides precomputed frame embeddings (B, S_enc, d_model).
long_500k is SKIPPED for this arch (enc-dec target side; see DESIGN.md).
[arXiv:2308.11596]
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    source="arXiv:2308.11596",
    n_layers=12,
    n_enc_layers=12,
    is_encoder_decoder=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    norm="layernorm",
    modality="audio",
    loss_chunk=256,
    optimizer="adamw",
)
