"""Architecture registry: --arch <id> -> ArchConfig (port of
``repro.configs.registry``).

The port serves every architecture of the reference: the dense
decoder-only family (Qwen1.5-0.5B, StableLM-3B, Yi-6B), the MoE family
(DeepSeek-V2-Lite with MLA attention, Moonlight, Arctic with its dense
residual and padded heads), the SSM family (Falcon-Mamba-7B, Mamba-1),
the hybrid family (Zamba2-1.2B, Mamba-2 with a shared attention block),
the encoder-decoder (SeamlessM4T-medium, on stub frame embeddings) and
the VLM (LLaVA-NeXT-34B, on stub patch embeddings), and carries the
paper's LeNet-5 config.
"""
from __future__ import annotations

from repro_torch.configs import (
    arctic_480b,
    deepseek_v2_lite_16b,
    falcon_mamba_7b,
    lenet_mnist,
    llava_next_34b,
    moonshot_v1_16b_a3b,
    qwen1_5_0_5b,
    seamless_m4t_medium,
    stablelm_3b,
    yi_6b,
    zamba2_1_2b,
)
from repro_torch.configs.base import ArchConfig

ARCHS = {m.CONFIG.name: m.CONFIG for m in (moonshot_v1_16b_a3b, stablelm_3b, arctic_480b,
                                           deepseek_v2_lite_16b, yi_6b, qwen1_5_0_5b,
                                           falcon_mamba_7b, zamba2_1_2b,
                                           seamless_m4t_medium, llava_next_34b)}

PAPER_ARCH = lenet_mnist.CONFIG
ALL_ARCHS = dict(ARCHS, **{PAPER_ARCH.name: PAPER_ARCH})

# the reference's architectures whose families the port does not run yet
NOT_PORTED = ()


def get_config(name: str) -> ArchConfig:
    try:
        return ALL_ARCHS[name]
    except KeyError:
        if name in NOT_PORTED:
            raise KeyError(
                f"arch {name!r} needs a model family the port does not have yet "
                f"(ROADMAP queue 1, item 12); available: {sorted(ALL_ARCHS)}") from None
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ALL_ARCHS)}") from None
