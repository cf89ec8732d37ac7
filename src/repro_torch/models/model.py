"""The dense decoder-only LM (port of the dense branch of
``repro.models.model``).

Public API, as the reference's:
  init_params(cfg, generator, device)     -> DecoderLM
  forward(cfg, params, batch, flash=True) -> (logits, aux_loss)
  loss_fn(cfg, params, batch)             -> (loss, {"ce", "aux"})
  init_cache(cfg, batch, total_len, ...)  -> decode cache
  decode_step(cfg, params, cache, tokens) -> (logits, cache)
  params_from_jax(tree, cfg, device)      -> DecoderLM with the reference's weights

The reference scans stacked layers; here the layers are a ``ModuleList``
and the scan a loop.  The decode cache keeps the reference's layout
(``{"idx", "layers": {"k", "v"}}`` with the layers stacked on a leading
axis) and ``decode_step`` writes it in place.  The other families (MoE,
MLA, SSM, hybrid, encoder-decoder, VLM) raise (ROADMAP queue 1, item 12).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.common import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """``init_block`` of the dense kind: ``ln1``, ``attn``, ``ln2``, ``ffn``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        self.ln1 = L.Norm(cfg, cfg.d_model, device)
        self.attn = L.Attention(cfg, generator, device)
        self.ln2 = L.Norm(cfg, cfg.d_model, device)
        self.ffn = L.MLP(cfg, generator, device)


def block_fwd(cfg: ArchConfig, p: Block, h: torch.Tensor, positions: torch.Tensor, *,
              cache: Optional[Params] = None, cache_index=None,
              flash: bool = True) -> Tuple[torch.Tensor, Optional[Params]]:
    a_in = L.norm_fwd(p.ln1, h)
    attn_out, new_cache = L.attention_fwd(cfg, p.attn, a_in, positions, cache=cache,
                                          cache_index=cache_index, flash=flash)
    h = h + attn_out
    f_in = L.norm_fwd(p.ln2, h)
    return h + L.mlp_fwd(p.ffn, f_in), new_cache


class DecoderLM(nn.Module):
    """``init_params`` of the dense decoder: ``embedding``, ``final_norm`` and
    ``layers`` (the reference's stacked L axis, one module per layer)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        L.check_dense(cfg)
        if cfg.param_dtype != "float32":
            raise NotImplementedError(f"param_dtype {cfg.param_dtype!r}: the port keeps "
                                      "f32 parameters (ROADMAP queue 1, item 12)")
        self.cfg = cfg
        self.embedding = L.Embedding(cfg, generator, device)
        self.final_norm = L.Norm(cfg, cfg.d_model, device)
        self.layers = nn.ModuleList(Block(cfg, generator, device)
                                    for _ in range(cfg.n_layers))


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None) -> DecoderLM:
    """A randomly initialised model on ``device`` (None: the card), its
    values drawn from ``generator`` (default: seed 0 on that device)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        return DecoderLM(cfg, generator, dev)


def _trunk(cfg: ArchConfig, params: DecoderLM, h: torch.Tensor, positions: torch.Tensor,
           caches: Optional[Params] = None, cache_index=None, flash: bool = True
           ) -> torch.Tensor:
    """The reference's ``_scan_blocks`` as a loop; the caches' layer slices
    are views of the stacked tensors, written in place."""
    for i, lp in enumerate(params.layers):
        cache = None if caches is None else {"k": caches["k"][i], "v": caches["v"][i]}
        h, _ = block_fwd(cfg, lp, h, positions, cache=cache, cache_index=cache_index,
                         flash=flash)
    return h


# ---------------------------------------------------------------------------
# forward (prefill / single-shot)
# ---------------------------------------------------------------------------

def _hidden(cfg: ArchConfig, params: DecoderLM, tokens: torch.Tensor,
            flash: bool) -> torch.Tensor:
    """The trunk's output after the final norm, (B, S, d)."""
    h = L.embed_fwd(params.embedding, tokens, _dtype(cfg))
    B, S = h.shape[:2]
    pos = torch.arange(S, device=h.device).expand(B, S)
    h = _trunk(cfg, params, h, pos, flash=flash)
    return L.norm_fwd(params.final_norm, h)


def forward(cfg: ArchConfig, params: DecoderLM, batch: Dict[str, torch.Tensor],
            flash: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  Returns (logits, aux_loss); the dense FFN has
    no auxiliary loss, so aux is 0.  ``flash`` is the port of the
    reference's ``REPRO_FLASH_KERNEL`` (see ``layers.attention_fwd``)."""
    h = _hidden(cfg, params, batch["tokens"], flash)
    logits = L.unembed_fwd(params.embedding, h)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _chunked_ce(cfg: ArchConfig, params: DecoderLM, h: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy without the whole (B, S, V) logits: the reference's
    ``lax.map`` over sequence chunks of ``cfg.loss_chunk`` positions as a
    loop.  As the reference, only the first ``(S // C) * C`` positions
    count: with fewer than C positions the loss is 0 (and so is its
    gradient)."""
    C = cfg.loss_chunk
    nC = h.shape[1] // C
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nC):
        sl = slice(c * C, (c + 1) * C)
        logits = L.unembed_fwd(params.embedding, h[:, sl]).to(torch.float32)
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels[:, sl, None].long())[..., 0]
        total = total + ((logz - gold) * mask[:, sl]).sum()
        count = count + mask[:, sl].sum()
    return total / torch.clamp(count, min=1.0)


def loss_fn(cfg: ArchConfig, params: DecoderLM, batch: Dict[str, torch.Tensor],
            flash: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32 (log-sum-exp of float32 logits),
    chunked over the sequence when ``cfg.loss_chunk`` is set.  ``flash``
    defaults off, as the reference's ``REPRO_FLASH_KERNEL``; kernel 8 has
    no backward in either package, so asking for it with gradients on
    raises.  Returns (loss, {"ce", "aux"})."""
    if flash and torch.is_grad_enabled():
        raise NotImplementedError(
            "flash=True under autograd: kernel 8 (flash attention) has no backward yet "
            "(ROADMAP queue 1, item 12); training runs flash=False, the reference's default")
    tokens = batch["tokens"]
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if cfg.loss_chunk:
        h = _hidden(cfg, params, tokens, flash)
        lab = tokens[:, 1:]
        mask = torch.ones(lab.shape, dtype=torch.float32, device=tokens.device)
        ce = _chunked_ce(cfg, params, h[:, :-1], lab, mask)
        return ce + aux, {"ce": ce, "aux": aux}
    logits, aux = forward(cfg, params, batch, flash=flash)
    lg = logits[:, :-1].to(torch.float32)
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, tokens[:, 1:, None].long())[..., 0]
    ce = (logz - gold).mean()
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def _cache_capacity(cfg: ArchConfig, total_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, total_len)
    return total_len


def init_cache(cfg: ArchConfig, batch: int, total_len: int, dtype=None,
               device=None) -> Params:
    """Decode cache for a context of ``total_len`` positions: ``idx`` (the
    next position, a host int) and the layers' ``k``/``v`` stacked as
    ``(L, B, Hkv, capacity, hd)``, on ``device`` (None: the card)."""
    L.check_dense(cfg)
    dev = resolve_device(device)
    dt = dtype or _dtype(cfg)
    cap = _cache_capacity(cfg, total_len)
    return {"idx": 0,
            "layers": L.init_kv_cache(cfg, batch, cap, dt, dev, lead=(cfg.n_layers,))}


def decode_step(cfg: ArchConfig, params: DecoderLM, cache: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), cache).  The
    token's K/V go into slot ``idx % capacity`` of the cache's tensors, in
    place; the returned cache holds the same tensors and ``idx + 1``."""
    dt = _dtype(cfg)
    idx = int(cache["idx"])
    B = tokens.shape[0]
    pos = torch.full((B, 1), idx, dtype=torch.int64, device=tokens.device)
    h = L.embed_fwd(params.embedding, tokens, dt)
    h = _trunk(cfg, params, h, pos, caches=cache["layers"], cache_index=idx)
    h = L.norm_fwd(params.final_norm, h)
    logits = L.unembed_fwd(params.embedding, h)
    return logits, {"idx": idx + 1, "layers": cache["layers"]}


# ---------------------------------------------------------------------------
# weights carried across from the reference
# ---------------------------------------------------------------------------

def _flatten(node: Params, prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for key, val in node.items():
        if isinstance(val, dict):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val, np.float32)
    return out


def params_from_jax(tree: Params, cfg: ArchConfig, device=None) -> DecoderLM:
    """The reference's ``init_params`` pytree (numpy leaves, the layers
    stacked on a leading L axis) as a ``DecoderLM`` on ``device`` (None:
    the card): each stacked leaf ``layers/<path>`` becomes ``layers.<i>.<path>``."""
    dev = resolve_device(device)
    state = _flatten({k: v for k, v in tree.items() if k != "layers"})
    for path, arr in _flatten(tree["layers"]).items():
        if arr.shape[0] != cfg.n_layers:
            raise ValueError(f"layers/{path} has {arr.shape[0]} layers, expected "
                             f"{cfg.n_layers}")
        for i in range(cfg.n_layers):
            state[f"layers.{i}.{path}"] = arr[i]
    model = DecoderLM(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in state.items()}, strict=True)
    return model.to(dev)
