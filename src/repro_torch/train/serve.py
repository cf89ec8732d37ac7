"""Serving step builders: prefill and single-token decode (port of
``repro.train.serve``).

``build_prefill`` runs the full-sequence forward; at prompt lengths of at
least ``layers.SDPA_CHUNK_THRESHOLD`` it reaches the flash-attention kernel
in every causal self-attention layer (a hybrid's shared block: once a
group; an SSM model has none; an encoder-decoder's encoder and
cross-attention never).  ``build_decode_step`` appends one token against a KV
cache of the context's length (an SSM layer: its O(1) state) and runs no
kernel of the port (the dense scores of one query are small), as in the
reference.

On a mesh with ``model`` = M > 1 (a dense, MoE, SSM or hybrid model cut
by ``models.model.init_params(..., mesh=)``, a cache from
``models.model.init_cache(..., mesh=)``) every model rank runs the step on
its H/M heads (the prefill at S >= 8192 reaches kernel 8 on them; MLA
never), ff/M columns, E/M experts and di/M Mamba channels.  On a grid (the data axis as processes) the batch rows split
over ``data`` as well: each data rank runs its B/K rows of the global
batch every rank passes (``models.model.local_rows``; the cache holds
them), its model the FSDP blocks of ``serve_shardings``'s parameter specs,
each layer's weights gathered over the data group just before the layer
(``models.model._gathered``).  The logits come back gathered over the
data group, then the model group (or the rank's block of rows and
vocabulary: ``gather=False``).  ``ServeConfig``, ``serve_rules`` and
``serve_shardings`` are the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.data.specs import ENC_LEN_DECODE, TensorSpec
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.logical import use_sharding
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import model_size
from repro_torch.models import model as M
from repro_torch.models import ssm as SSM


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    multi_pod: bool = False

    def data_axes(self) -> Tuple[str, ...]:
        return ("pod", "data") if self.multi_pod else ("data",)


def serve_rules(sc: ServeConfig) -> Dict[str, Any]:
    return shd.activation_rules("gspmd", sc.multi_pod)


def serve_shardings(cfg: ArchConfig, sc: ServeConfig, mesh, params_shape: Any,
                    cache_shape: Any):
    """The reference's (parameter specs, cache specs): parameters FSDP + TP
    (``param_specs(fsdp=True)``), the cache batch over the data axes and
    heads over ``model``; plain tuples.  The port serves both on a grid
    (``models.model.init_params(..., mesh=)``, ``init_cache(mesh=)``)."""
    data_axes = sc.data_axes()
    return (shd.param_specs(cfg, params_shape, fsdp=True, data_axes=data_axes, mesh=mesh),
            shd.cache_specs(cfg, cache_shape, data_axes=data_axes, mesh=mesh))


def _sharded(cfg: ArchConfig, sc: Optional[ServeConfig], mesh):
    """The step's ``use_sharding`` context: a no-op at M = 1."""
    if model_size(mesh) == 1:
        return contextlib.nullcontext
    rules = shd.tp_rules(cfg, serve_rules(sc or ServeConfig()), mesh)
    return lambda: use_sharding(mesh, rules, shd.model_dims(cfg, mesh))


def _rows(batch: Dict[str, torch.Tensor], mesh, dev) -> Dict[str, torch.Tensor]:
    """This rank's rows of every entry of a global batch, on ``dev``."""
    a, n = M.local_rows(next(iter(batch.values())).shape[0], mesh)
    return {k: v[a:a + n].to(dev) for k, v in batch.items()}


def _gathered(logits: torch.Tensor, mesh, batch: int) -> torch.Tensor:
    """The logits of the whole batch over the whole vocabulary: the data
    ranks' rows, then the model ranks' vocabulary blocks, gathered."""
    rows = M.local_rows(batch, mesh)[1] != batch
    spec = (("pod", "data") if mesh.shape.get("pod") else "data") if rows else None, None, \
        "model" if model_size(mesh) > 1 else None
    if spec == (None, None, None):
        return logits
    return shd.gather_tensor(logits, spec, mesh)


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


def build_decode_step(cfg: ArchConfig, device=None, *, sc: Optional[ServeConfig] = None,
                      mesh=None) -> Callable:
    """fn(params, cache, tokens (B, 1)) -> (logits, cache), on ``device``
    (None: the card).  The cache is updated in place (the reference donates
    it).  ``mesh``: see the module docstring (the cache from
    ``models.model.init_cache(..., mesh=mesh)``)."""
    dev = resolve_device(device)
    ctx = _sharded(cfg, sc, mesh)

    @torch.inference_mode()
    def fn(params, cache, tokens):
        if isinstance(tokens, dict):
            tokens = tokens["tokens"]
        _on(dev, params)
        B = tokens.shape[0]
        with ctx():
            logits, cache = M.decode_step(cfg, params, cache,
                                          _rows({"tokens": tokens}, mesh, dev)["tokens"])
        return (logits if mesh is None else _gathered(logits, mesh, B)), cache

    return fn


def build_prefill(cfg: ArchConfig, device=None, flash: bool = True, *,
                  sc: Optional[ServeConfig] = None, mesh=None,
                  gather: bool = True) -> Callable:
    """fn(params, batch) -> logits (full-sequence forward), on ``device``
    (None: the card); every tensor of ``batch`` (``tokens``, and
    ``frames`` or ``patch_embeds``) goes to the device.  ``flash=False``
    is the port of
    ``REPRO_FLASH_KERNEL=0``: the flash branch then runs the chunked
    online softmax in plain PyTorch.  ``mesh``: see the module docstring."""
    dev = resolve_device(device)
    ctx = _sharded(cfg, sc, mesh)

    @torch.inference_mode()
    def fn(params, batch):
        _on(dev, params)
        B = next(iter(batch.values())).shape[0]
        with ctx():
            logits, _ = M.forward(cfg, params, _rows(batch, mesh, dev), flash=flash)
        return _gathered(logits, mesh, B) if gather and mesh is not None else logits

    return fn
