"""Input specs per (architecture x input shape), text tokens only (port of
the text parts of ``repro.data.specs``).

``train_specs`` returns ``TensorSpec`` stand-ins (shape and dtype, no
allocation) for a prefill batch; ``dummy_batch`` draws small real tokens
from a ``torch.Generator``.  The reference's frame and patch embeddings
(encoder-decoder, VLM) belong to families the port does not run yet.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.kernels.common import resolve_device

ENC_LEN_DECODE = 4096  # audio encoder output length assumed during decode


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _text_only(cfg: ArchConfig) -> None:
    if cfg.is_encoder_decoder or cfg.modality != "text":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.modality} inputs are not ported yet (ROADMAP queue 1, "
            "item 12)")


def train_specs(cfg: ArchConfig, shape: InputShape) -> Dict[str, TensorSpec]:
    """Specs for prefill (and later train) batches."""
    _text_only(cfg)
    return {"tokens": TensorSpec((shape.global_batch, shape.seq_len), torch.int32)}


def dummy_batch(cfg: ArchConfig, batch: int, seq: int,
                generator: Optional[torch.Generator] = None, device=None
                ) -> Dict[str, torch.Tensor]:
    """Uniform random tokens in [0, vocab) on ``device`` (None: the card,
    raising without one); ``generator`` (default: seed 0) must live on
    that device."""
    _text_only(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    return {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq), generator=generator,
                                    device=device, dtype=torch.int32)}
