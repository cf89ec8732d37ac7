"""Dense decoder layers: norms, RoPE, GQA attention with a ring-buffer KV
cache, SwiGLU MLP, embeddings (port of the dense parts of
``repro.models.layers``).

Each parameter set is an ``nn.Module`` whose parameter names are the
reference's dictionary keys, so a ``state_dict`` reads like the
reference's parameter paths (``attn.wq``, ``ln1.scale``, ...).  Parameters
stay in ``cfg.param_dtype`` (f32) and are cast to the activation dtype at
each use, as the reference does (``p["wq"].astype(dt)``).  Weights are laid
out as the reference's, ``(d_in, d_out)``, and applied as ``x @ w``.

The reference's sharding annotations (``shard``) are no-ops outside a mesh
and are dropped; the mode-B mesh is ROADMAP queue 1, item 12.  MLA, MoE
and head padding (``pad_heads_to``) are not ported (ROADMAP queue 1, item
12).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attn.ops import flash_attention

NOT_PORTED = "is not ported yet (ROADMAP queue 1, item 12)"

# KV lengths at or above this take the chunked online-softmax route (or
# the flash kernel); below it the dense scores are cheaper
# (``src/repro/models/layers.py:168-169``).
SDPA_CHUNK_THRESHOLD = 8192
SDPA_CHUNK = 1024
NEG_INF = -1e30


def _param(shape, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def _dense_init_(p: torch.Tensor, generator: torch.Generator) -> None:
    """The reference's ``_dense_init``: a unit normal truncated to [-2, 2],
    times 1/sqrt(fan_in).  Drawn from ``generator``; the values are not
    the reference's (its ``jax.random`` bits)."""
    with torch.no_grad():
        nn.init.trunc_normal_(p, 0.0, 1.0, -2.0, 2.0, generator=generator)
        p.mul_(1.0 / math.sqrt(p.shape[0]))


def check_dense(cfg: ArchConfig) -> None:
    """Raise for what the port's dense stack does not run."""
    if cfg.use_mla:
        raise NotImplementedError(f"MLA attention {NOT_PORTED}")
    if cfg.n_experts:
        raise NotImplementedError(f"the MoE FFN {NOT_PORTED}")
    if cfg.pad_heads_to and cfg.n_heads < cfg.pad_heads_to:
        raise NotImplementedError(f"pad_heads_to {NOT_PORTED}")
    if cfg.family != "dense" or cfg.is_encoder_decoder or cfg.modality != "text":
        raise NotImplementedError(f"the {cfg.family!r} family ({cfg.name}) {NOT_PORTED}")


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``init_norm``: ``scale`` (ones) and, for LayerNorm, ``bias`` (zeros)."""

    def __init__(self, cfg: ArchConfig, d: int, device=None):
        super().__init__()
        self.layernorm = cfg.norm == "layernorm"
        self.eps = float(cfg.norm_eps)
        self.scale = _param((d,), device)
        nn.init.ones_(self.scale)
        if self.layernorm:
            self.bias = _param((d,), device)
            nn.init.zeros_(self.bias)


def norm_fwd(p: Norm, x: torch.Tensor) -> torch.Tensor:
    """Reduction statistics in f32, application in the activation dtype."""
    dt = x.dtype
    xf = x.to(torch.float32)
    if p.layernorm:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, correction=0)
        inv = torch.rsqrt(var + p.eps)
        return ((xf - mu) * inv).to(dt) * p.scale.to(dt) + p.bias.to(dt)
    ms = (xf * xf).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + p.eps)
    return (xf * inv).to(dt) * p.scale.to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on the last dim.  x: (..., S, H, hd), positions (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=x.device)
                             / half))
    ang = positions[..., :, None].to(torch.float32) * freqs   # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                         # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA + optional ring-buffer sliding-window cache)
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """``init_attention`` (GQA): ``wq (d, H*hd)``, ``wk``/``wv (d, Hkv*hd)``,
    ``wo (H*hd, d)`` and, with ``qkv_bias``, ``bq``/``bk``/``bv`` (zeros)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        d = cfg.d_model
        hd, H, Hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
        for name, shape in (("wq", (d, H * hd)), ("wk", (d, Hkv * hd)),
                            ("wv", (d, Hkv * hd)), ("wo", (H * hd, d))):
            setattr(self, name, _param(shape, device))
            _dense_init_(getattr(self, name), generator)
        if cfg.qkv_bias:
            for name, n in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
                setattr(self, name, _param((n,), device))
                nn.init.zeros_(getattr(self, name))


def init_kv_cache(cfg: ArchConfig, batch: int, capacity: int, dtype, device=None,
                  lead: Tuple[int, ...] = ()) -> Dict[str, torch.Tensor]:
    """Zero ``k``/``v`` of shape ``lead + (batch, Hkv, capacity, hd)``
    (``lead = (L,)`` stacks the layers, as the reference's vmap does)."""
    hd, Hkv = cfg.head_dim_, cfg.n_kv_heads
    if cfg.use_mla:
        raise NotImplementedError(f"the MLA cache {NOT_PORTED}")
    shape = tuple(lead) + (batch, Hkv, capacity, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _sdpa(q, k, v, mask: torch.Tensor, scale) -> torch.Tensor:
    """q (B,H,Sq,hd), k/v (B,H,Sk,hd) -> (B,H,Sq,hd)."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _sdpa_chunked(q, k, v, scale, mask_chunk_fn, chunk: int = SDPA_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks with a running (max,
    denominator, accumulator); ``mask_chunk_fn(offset, C)`` gives the mask
    block (broadcastable to (B, 1|H, Sq, C)) of KV slots [offset, offset+C),
    so neither the (Sq, Sk) scores nor the mask exist whole."""
    B, H, Sq, hd = q.shape
    Sk = k.shape[2]
    nc = -(-Sk // chunk)
    pad = nc * chunk - Sk
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    m = torch.full((B, H, Sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, hd), dtype=torch.float32, device=q.device)
    for ci in range(nc):
        off = ci * chunk
        kc, vc = k[:, :, off:off + chunk], v[:, :, off:off + chunk]
        s = torch.einsum("bhqd,bhkd->bhqk", q, kc).to(torch.float32) * scale
        msk = ((off + torch.arange(chunk, device=q.device)) < Sk)[None, None, None, :]
        msk = msk & mask_chunk_fn(off, chunk)
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", p.to(vc.dtype), vc).to(torch.float32)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=1)


def attention_fwd(
    cfg: ArchConfig,
    p: Attention,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    flash: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Causal GQA self-attention.

    Modes:
      prefill: cache=None -> full causal self-attention.
      decode:  cache given -> write x's K/V at ``cache_index`` (ring buffer
               modulo capacity, i.e. a sliding window when the capacity is
               below the positions seen), in place, and attend to the cache.
    ``flash`` is the port of the reference's ``REPRO_FLASH_KERNEL`` switch
    (``src/repro/models/layers.py:172``): with it, self-attention without
    a cache over at least ``SDPA_CHUNK_THRESHOLD`` keys and 128
    queries runs the flash kernel; without it that branch runs
    ``_sdpa_chunked``.  Returns (out, cache)."""
    B, S, d = x.shape
    hd, H, Hkv = cfg.head_dim_, cfg.n_heads, cfg.n_kv_heads
    dt = x.dtype

    q = x @ p.wq.to(dt)
    k = x @ p.wk.to(dt)
    v = x @ p.wv.to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + p.bk.to(dt)
        v = v + p.bv.to(dt)
    q = rope(q.reshape(B, S, H, hd), positions, cfg.rope_theta)
    k = rope(k.reshape(B, S, Hkv, hd), positions, cfg.rope_theta)
    v = v.reshape(B, S, Hkv, hd)

    q = q.transpose(1, 2)  # (B,H,S,hd)
    k = k.transpose(1, 2)  # (B,Hkv,S,hd)
    v = v.transpose(1, 2)

    if cache is not None:
        cap = cache["k"].shape[2]
        # the reference's dynamic_update_slice clamps the start so that the
        # S rows fit; decode has S == 1
        slot = min(cache_index % cap, cap - S)
        cache["k"][:, :, slot:slot + S] = k.to(cache["k"].dtype)
        cache["v"][:, :, slot:slot + S] = v.to(cache["v"].dtype)
        k, v = cache["k"].to(dt), cache["v"].to(dt)
        n_valid = min(cache_index + S, cap)
        # Before the ring buffer wraps, slot j holds absolute position j, so
        # S > 1 still needs the causal constraint.  Once wrapped, every
        # valid slot is in the query's past by construction.
        qpos = cache_index + torch.arange(S, device=x.device)
        no_wrap = (cache_index + S) <= cap

        def _cache_mask(off, C):
            slots_c = off + torch.arange(C, device=x.device)
            valid = slots_c[None, None, None, :] < n_valid
            if not no_wrap:
                return valid
            return valid & (slots_c[None, :] <= qpos[:, None])[None, None, :, :]

        mask_chunk_fn = _cache_mask
    else:
        def _causal_mask(off, C):
            pos = F.pad(positions, (0, (-positions.shape[1]) % C))
            kpos_c = pos[:, off:off + C]
            return kpos_c[:, None, None, :] <= positions[:, None, :, None]

        mask_chunk_fn = _causal_mask

    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    # 1 / sqrt(hd) in f32, as the reference's ``1.0 / jnp.sqrt(hd)``
    scale = float(1.0 / torch.tensor(float(hd), dtype=torch.float32).sqrt())
    # the chunked (or flash) route only when both dims are large: a decode
    # step's (B, H, 1, Sk) scores are small
    if k.shape[2] >= SDPA_CHUNK_THRESHOLD and q.shape[2] >= 128:
        if flash and cache is None:
            out = flash_attention(q, k, v, float(1.0 / hd ** 0.5), causal=True)
        else:
            out = _sdpa_chunked(q, k, v, scale, mask_chunk_fn)
    else:
        out = _sdpa(q, k, v, mask_chunk_fn(0, k.shape[2]), scale)
    out = out.transpose(1, 2).reshape(B, S, H * hd)
    return out @ p.wo.to(dt), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``init_mlp`` (SwiGLU): ``w_gate``/``w_up (d, ff)``, ``w_down (ff, d)``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        for name, shape in (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d))):
            setattr(self, name, _param(shape, device))
            _dense_init_(getattr(self, name), generator)


def mlp_fwd(p: MLP, x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = F.silu(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
    return h @ p.w_down.to(dt)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``init_embedding``: ``embed (V, d)`` (0.02 * normal) and, untied,
    ``unembed (d, V)``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        self.tied = cfg.tie_embeddings
        self.embed = _param((cfg.vocab_size, cfg.d_model), device)
        with torch.no_grad():
            self.embed.normal_(0.0, 1.0, generator=generator).mul_(0.02)
        if not self.tied:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), device)
            _dense_init_(self.unembed, generator)


def embed_fwd(p: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The reference casts the whole table and gathers; gathering first and
    casting the rows gives the same values without the table's copy."""
    return p.embed[tokens.long()].to(dtype)


def unembed_fwd(p: Embedding, h: torch.Tensor) -> torch.Tensor:
    dt = h.dtype
    if p.tied:
        return h @ p.embed.to(dt).T
    return h @ p.unembed.to(dt)
