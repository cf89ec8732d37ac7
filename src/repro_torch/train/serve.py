"""Serving step builders: prefill and single-token decode (port of
``repro.train.serve``).

``build_prefill`` runs the full-sequence forward; at prompt lengths of at
least ``layers.SDPA_CHUNK_THRESHOLD`` it reaches the flash-attention kernel
in every causal self-attention layer (a hybrid's shared block: once a
group; an SSM model has none; an encoder-decoder's encoder and
cross-attention never).  ``build_decode_step`` appends one token against a KV
cache of the context's length (an SSM layer: its O(1) state) and runs no
kernel of the port (the dense scores of one query are small), as in the
reference.  The reference's ``ServeConfig``, mesh and shardings wait for
the mode-B mesh stack (ROADMAP queue 1, item 12); on one card they are
no-ops.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.data.specs import ENC_LEN_DECODE, TensorSpec
from repro_torch.kernels.common import resolve_device
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM


def cache_shapes(cfg: ArchConfig, shape: InputShape) -> Dict[str, Any]:
    """The decode cache's layout for an input shape, without allocating it:
    ``idx``, an MoE model's ``prefix`` list and the stacked layers' specs
    (``k``/``v``, or MLA's ``ckv``/``krope``); SSM: ``conv`` (L, B, kw - 1,
    di) and ``h`` (f32); hybrid: ``attn`` ``k``/``v`` stacked (G, ...) and
    ``mamba`` ``conv``/``h`` stacked (G, every, ...); an encoder-decoder adds
    ``enc_out`` (B, ``ENC_LEN_DECODE``, d), the encoder output a decode
    step reads."""
    cap = M._cache_capacity(cfg, shape.seq_len)
    B, dt = shape.global_batch, getattr(torch, cfg.dtype)

    def ssm(lead):
        shapes = SSM.state_shapes(cfg, B)
        return {"conv": TensorSpec(lead + shapes["conv"], dt),
                "h": TensorSpec(lead + shapes["h"], torch.float32)}

    if cfg.family == "ssm":
        return {"idx": 0, "layers": ssm((cfg.n_layers,))}
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        kv = TensorSpec((cfg.n_layers // every, B, cfg.n_kv_heads, cap, cfg.head_dim_), dt)
        return {"idx": 0, "layers": {"attn": {"k": kv, "v": kv},
                                     "mamba": ssm((cfg.n_layers // every, every))}}

    def layer(lead):
        if cfg.use_mla:
            return {"ckv": TensorSpec(lead + (B, cap, cfg.kv_lora_rank), dt),
                    "krope": TensorSpec(lead + (B, cap, cfg.qk_rope_dim), dt)}
        kv = TensorSpec(lead + (B, cfg.n_kv_heads, cap, cfg.head_dim_), dt)
        return {"k": kv, "v": kv}

    n_prefix = M._n_prefix(cfg)
    out: Dict[str, Any] = {"idx": 0}
    if cfg.is_encoder_decoder:
        out["enc_out"] = TensorSpec((B, ENC_LEN_DECODE, cfg.d_model), dt)
    if n_prefix:
        out["prefix"] = [layer(()) for _ in range(n_prefix)]
    out["layers"] = layer((cfg.n_layers - n_prefix,))
    return out


def _on(dev: torch.device, params: M.DecoderLM) -> None:
    p = params.embedding.embed
    if p.device.type != dev.type:
        raise ValueError(f"the model is on {p.device}, the step runs on {dev}")


def build_decode_step(cfg: ArchConfig, device=None) -> Callable:
    """fn(params, cache, tokens (B, 1)) -> (logits, cache), on ``device``
    (None: the card).  The cache is updated in place (the reference donates
    it)."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(params, cache, tokens):
        if isinstance(tokens, dict):
            tokens = tokens["tokens"]
        _on(dev, params)
        return M.decode_step(cfg, params, cache, tokens.to(dev))

    return fn


def build_prefill(cfg: ArchConfig, device=None, flash: bool = True) -> Callable:
    """fn(params, batch) -> logits (full-sequence forward), on ``device``
    (None: the card); every tensor of ``batch`` (``tokens``, and
    ``frames`` or ``patch_embeds``) goes to the device.  ``flash=False``
    is the port of
    ``REPRO_FLASH_KERNEL=0``: the flash branch then runs the chunked
    online softmax in plain PyTorch."""
    dev = resolve_device(device)

    @torch.inference_mode()
    def fn(params, batch):
        _on(dev, params)
        logits, _ = M.forward(cfg, params, {k: v.to(dev) for k, v in batch.items()},
                              flash=flash)
        return logits

    return fn
