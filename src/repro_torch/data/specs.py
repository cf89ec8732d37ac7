"""Input specs per (architecture x input shape) (port of
``repro.data.specs``).

``train_specs`` returns ``TensorSpec`` stand-ins (shape and dtype, no
allocation) for a prefill batch; ``dummy_batch`` draws small real inputs
from a ``torch.Generator``.  The audio and vision frontends are stubs, as
in the reference: an encoder-decoder takes precomputed frame embeddings
(B, S, d_model), a VLM precomputed patch embeddings (B, n_modal,
``MODAL_EMBED_DIM``) beside its text tokens.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.kernels.common import resolve_device
from repro_torch.models.model import MODAL_EMBED_DIM

ENC_LEN_DECODE = 4096  # audio encoder output length assumed during decode


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def train_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, TensorSpec]:
    """Specs for prefill (and train) batches: ``tokens`` (B, S); an
    encoder-decoder adds ``frames`` (B, S, d); a VLM's S positions are
    ``n_modal_tokens`` patch embeddings and S - n_modal tokens."""
    B, S = shape.global_batch, shape.seq_len
    dt = getattr(torch, cfg.dtype)
    if cfg.is_encoder_decoder:
        return {"frames": TensorSpec((B, S, cfg.d_model), dt),
                "tokens": TensorSpec((B, S), torch.int32)}
    if cfg.modality == "vision":
        n_img = cfg.n_modal_tokens
        return {"patch_embeds": TensorSpec((B, n_img, MODAL_EMBED_DIM), dt),
                "tokens": TensorSpec((B, S - n_img), torch.int32)}
    return {"tokens": TensorSpec((B, S), torch.int32)}


def dummy_batch(cfg: ArchConfig, batch: int, seq: int,
                generator: Optional[torch.Generator] = None, device=None
                ) -> Dict[str, torch.Tensor]:
    """Uniform random tokens in [0, vocab) on ``device`` (None: the card,
    raising without one), after unit-normal ``frames`` (B, seq, d) for an
    encoder-decoder or ``patch_embeds`` for a VLM (then ``max(seq - n_modal,
    8)`` tokens); ``generator`` (default: seed 0) must live on that
    device."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dt = getattr(torch, cfg.dtype)
    out = {}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn((batch, seq, cfg.d_model), generator=generator,
                                    device=device, dtype=dt)
    elif cfg.modality == "vision":
        out["patch_embeds"] = torch.randn((batch, cfg.n_modal_tokens, MODAL_EMBED_DIM),
                                          generator=generator, device=device, dtype=dt)
        seq = max(seq - cfg.n_modal_tokens, 8)
    out["tokens"] = torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                                  device=device, dtype=torch.int32)
    return out
