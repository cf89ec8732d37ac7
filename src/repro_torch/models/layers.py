"""Decoder layers: norms, RoPE, GQA attention with a ring-buffer KV cache
and head padding, MLA attention with its latent cache, the SwiGLU MLP, the
MoE FFN, embeddings (port of ``repro.models.layers``).  The Mamba mixers
of the SSM and hybrid families are ``models.ssm``.

Each parameter set is an ``nn.Module`` whose parameter names are the
reference's dictionary keys, so a ``state_dict`` reads like the
reference's parameter paths (``attn.wq``, ``ln1.scale``, ...).  Parameters
stay in ``cfg.param_dtype`` and are cast to the activation dtype at each
use, as the reference does (``p["wq"].astype(dt)``).  Weights are laid
out as the reference's, ``(d_in, d_out)``, and applied as ``x @ w``; the
experts' weights are stacked on a leading expert axis.

Non-causal attention serves the encoder-decoder's encoder, and
cross-attention (``kv_source``) its decoder; neither reaches the causal
flash kernel.

**The model axis (tensor parallelism).**  On a mesh with ``model`` = M >
1 a dense model's ``Attention`` holds its rank's H/M query heads (``wq``,
``bq`` by columns, ``wo`` by rows) and Hkv/M KV heads, or every KV head
when ``n_kv_heads % M != 0`` (then each rank uses the ones its query heads
map to); ``MLP`` holds ff/M (``w_gate``, ``w_up`` by columns, ``w_down``
by rows); ``Embedding`` holds V/M vocabulary rows (and ``unembed`` V/M
columns): a lookup masks the ids outside the rank's range and all-reduces,
and the unembedding gives the rank's vocabulary block of the logits.  Two
autograd functions carry the collectives (Megatron's f and g):
``copy_to_model`` (identity forward, all-reduce of the gradient) before a
column-split product, ``reduce_from_model`` (all-reduce forward, identity
backward) after a row-split one; ``sum_over_model`` (all-reduce both
ways) for a sum of partial values that every rank then uses for its own
part (a row-split product feeding column-split ones, a norm's sum of
squares), ``gather_from_model`` (all-gather forward, the rank's slice
backward) where a column-split product's whole output is needed.  Every
all-reduce gathers the M parts in rank order and adds them in float32 in
that order, so every rank holds the same bits.  The layers find their
``ModelAxis`` in their ``tp`` attribute (None: whole, M = 1), which
``models.model`` sets when it cuts a model; the reference's ``shard``
annotations check the local extents (``distributed.logical``).

The other families on the model axis (the reference's GSPMD layout of the
same leaves, ``activation_rules``' ``"expert"`` and ``"inner"``):

* ``MoE``: the router is replicated, the expert slabs split E/M a rank.
  Every rank routes every token on the replicated activations (the same
  bits, the same picks, the global capacity and slots), keeps the picks of
  its experts, runs its experts' three ``bmm``s and combines its picks;
  the shared and dense-residual MLPs run their TP form, and one
  all-reduce sums the parts.  The gate path's probabilities carry a
  summed gradient (each rank's combine reads its picks only); the aux
  loss, whole on every rank, reads them directly, so its router gradient
  counts once.
* ``MLAAttention``: H/M heads a rank (``wq``, ``w_uk``, ``w_uv`` by
  columns, ``wo`` by rows); the latent's down projections and norm are
  replicated, their gradients summed; the latent cache is replicated.
* padded heads (``pad_heads_to``): where M divides the live heads a rank
  splits them as ``wq``'s spec does and pads its own to ``pad_heads_to /
  M`` for attention (the reference's activation layout); where it does
  not, a rank holds ``pad_heads_to / M`` head slots of the padded layout
  (``distributed.sharding.tp_cut``), the pad slots' q, k and v zero.

The encoder-decoder's and the VLM's layers take the same forms: the
encoder's blocks are dense blocks, a cross-attention (``kv_source``) splits
its heads as the self-attention does, the replicated encoder output's
gradient summed over the model axis by its ``copy_to_model``; the VLM's
projector is split as an MLP is (``models.model._project``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.logical import shard
from repro_torch.kernels.flash_attn.ops import flash_attention

# the families of ``repro.models.model``: ``vlm`` and ``audio`` (the
# encoder-decoder) are decoders too, with a modal prefix or an encoder
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "audio")

# KV lengths at or above this take the chunked online-softmax route (or
# the flash kernel); below it the dense scores are cheaper
# (``src/repro/models/layers.py:168-169``).
SDPA_CHUNK_THRESHOLD = 8192
SDPA_CHUNK = 1024
NEG_INF = -1e30


def _param(shape, device, dtype=torch.float32) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


def _pdtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def _parts(p: torch.Tensor):
    """A leaf one expert slab at a time (a stacked (E, ...) leaf), else whole."""
    return p.unbind(0) if p.dim() == 3 else (p,)


def _draw_(p: torch.Tensor, draw) -> None:
    """``draw(t)`` fills an f32 tensor in place; each part of ``p`` is drawn
    in f32 and cast into it, as the reference draws in f32 and casts every
    leaf to ``param_dtype``: a bf16 leaf never has a whole f32 twin."""
    with torch.no_grad():
        for part in _parts(p):
            if part.dtype == torch.float32:
                draw(part)
            else:
                tmp = torch.empty(part.shape, dtype=torch.float32, device=part.device)
                draw(tmp)
                part.copy_(tmp)


def _dense_init_(p: torch.Tensor, generator: torch.Generator, scale=None) -> None:
    """The reference's ``_dense_init``: a unit normal truncated to [-2, 2],
    times ``scale`` (default 1/sqrt(shape[0]), the reference's fan-in: the
    expert count for a stacked (E, d_in, d_out) leaf).  Drawn from
    ``generator``; the values are not the reference's (its ``jax.random``
    bits)."""
    scale = 1.0 / math.sqrt(p.shape[0]) if scale is None else scale

    def draw(t):
        nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
        t.mul_(scale)

    _draw_(p, draw)


def check_family(cfg: ArchConfig) -> None:
    """Raise for what the reference's model cannot run: a family that is
    not a language model (the paper's CNN is ``models.lenet``), an SSM or
    hybrid config without a Mamba variant or, hybrid, whose layers do not
    split into whole groups.  Every language-model family runs on the
    model axis and on the grid."""
    if cfg.family in ("ssm", "hybrid"):
        if cfg.ssm_variant not in ("mamba1", "mamba2"):
            raise ValueError(f"{cfg.name}: the {cfg.family!r} family needs ssm_variant "
                             f"'mamba1' or 'mamba2', not {cfg.ssm_variant!r}")
        if cfg.family == "hybrid" and (cfg.shared_attn_every < 1
                                       or cfg.n_layers % cfg.shared_attn_every):
            raise ValueError(f"{cfg.name}: {cfg.n_layers} layers do not split into groups "
                             f"of shared_attn_every = {cfg.shared_attn_every}")
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family!r} family ({cfg.name}) is not a language model: the "
            f"decoder runs {LM_FAMILIES}; the paper's CNN is repro_torch.models.lenet")


# ---------------------------------------------------------------------------
# the model axis: collectives with autograd
# ---------------------------------------------------------------------------

def all_reduce_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of every model rank's ``x``: gathered in rank order, added in
    float32 in that order, cast back to ``x``'s dtype (the same bits on
    every rank)."""
    from repro_torch.distributed.spmd import all_gather_in_rank_order

    parts = all_gather_in_rank_order(x, group)
    acc = parts[0].to(torch.float32)
    for part in parts[1:]:
        acc = acc + part.to(torch.float32)
    return acc.to(x.dtype)


def all_max_model(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of every model rank's ``x`` (no gradient)."""
    from repro_torch.distributed.spmd import all_gather_in_rank_order

    return torch.stack(all_gather_in_rank_order(x.detach(), group)).amax(dim=0)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_model(g.contiguous(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_model(x.contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank):
        from repro_torch.distributed.spmd import all_gather_in_rank_order

        ctx.rank, ctx.n = rank, x.shape[-1]
        return torch.cat(all_gather_in_rank_order(x.contiguous(), group), dim=-1)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.rank * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """Identity forward, the gradient all-reduced over the model axis: the
    replicated input of a column-split product (or a replicated weight used
    by part of the ranks' heads).  ``tp`` None: ``x``."""
    return x if tp is None else _CopyToModel.apply(x, tp.group)


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """All-reduce forward, identity backward: the partial sums of a
    row-split product.  ``tp`` None: ``x``."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.group)


def sum_over_model(x: torch.Tensor, tp) -> torch.Tensor:
    """All-reduce forward and backward: the sum of every rank's partial
    ``x``, which every rank then uses for its own part only, so that the
    uses' gradients are summed too.  ``tp`` None: ``x``."""
    return copy_to_model(reduce_from_model(x, tp), tp)


def gather_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The ranks' blocks of the last dim joined in rank order (all-gather
    forward, the rank's block of the gradient backward): the whole output
    of a column-split product.  ``tp`` None: ``x``."""
    return x if tp is None else _GatherFromModel.apply(x, tp.group, tp.rank)



# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

class Norm(nn.Module):
    """``init_norm``: ``scale`` (ones) and, for LayerNorm, ``bias`` (zeros)."""

    def __init__(self, cfg: ArchConfig, d: int, device=None):
        super().__init__()
        self.layernorm = cfg.norm == "layernorm"
        self.eps = float(cfg.norm_eps)
        self.scale = _param((d,), device, _pdtype(cfg))
        nn.init.ones_(self.scale)
        if self.layernorm:
            self.bias = _param((d,), device, _pdtype(cfg))
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
            setattr(self, name, _param(shape, device, _pdtype(cfg)))
            _dense_init_(getattr(self, name), generator)
        if cfg.qkv_bias:
            for name, n in (("bq", H * hd), ("bk", Hkv * hd), ("bv", Hkv * hd)):
                setattr(self, name, _param((n,), device, _pdtype(cfg)))
                nn.init.zeros_(getattr(self, name))


class MLAAttention(nn.Module):
    """``init_attention`` with ``use_mla`` (DeepSeek-V2): ``wq (d,
    H*(hd+rd))``, the latent's down projection ``w_dkv (d, r)``, the shared
    rope key ``w_kr (d, rd)``, the up projections ``w_uk``/``w_uv (r,
    H*hd)``, ``wo (H*hd, d)`` and the latent's norm ``kv_norm (r,)`` (ones)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        d, hd, H = cfg.d_model, cfg.head_dim_, cfg.n_heads
        r, rd = cfg.kv_lora_rank, cfg.qk_rope_dim
        for name, shape in (("wq", (d, H * (hd + rd))), ("w_dkv", (d, r)), ("w_kr", (d, rd)),
                            ("w_uk", (r, H * hd)), ("w_uv", (r, H * hd)), ("wo", (H * hd, d))):
            setattr(self, name, _param(shape, device, _pdtype(cfg)))
            _dense_init_(getattr(self, name), generator)
        self.kv_norm = _param((r,), device, _pdtype(cfg))
        nn.init.ones_(self.kv_norm)


def init_kv_cache(cfg: ArchConfig, batch: int, capacity: int, dtype, device=None,
                  lead: Tuple[int, ...] = (), n_kv: Optional[int] = None
                  ) -> Dict[str, torch.Tensor]:
    """Zero ``k``/``v`` of shape ``lead + (batch, Hkv, capacity, hd)``
    (``lead = (L,)`` stacks the layers, as the reference's vmap does; Hkv
    ``n_kv``, default ``cfg.n_kv_heads``: a model rank's KV heads); with
    MLA the latent ``ckv`` ``lead + (batch, capacity, r)`` and the rope key
    ``krope`` ``lead + (batch, capacity, rd)``."""
    hd, Hkv = cfg.head_dim_, n_kv or cfg.n_kv_heads
    if cfg.use_mla:
        lead = tuple(lead) + (batch, capacity)
        return {"ckv": torch.zeros(lead + (cfg.kv_lora_rank,), dtype=dtype, device=device),
                "krope": torch.zeros(lead + (cfg.qk_rope_dim,), dtype=dtype, device=device)}
    shape = tuple(lead) + (batch, Hkv, capacity, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _sdpa(q, k, v, mask: Optional[torch.Tensor], scale) -> torch.Tensor:
    """q (B,H,Sq,hd), k/v (B,H,Sk,hd) -> (B,H,Sq,hd); ``mask`` None: every
    key."""
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", w, v)


def _sdpa_chunked(q, k, v, scale, mask_chunk_fn, chunk: int = SDPA_CHUNK) -> torch.Tensor:
    """Online-softmax attention over KV chunks with a running (max,
    denominator, accumulator); ``mask_chunk_fn(offset, C)`` gives the mask
    block (broadcastable to (B, 1|H, Sq, C)) of KV slots [offset, offset+C),
    so neither the (Sq, Sk) scores nor the mask exist whole; None masks
    only the padding past Sk."""
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
        if mask_chunk_fn is not None:
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
    causal: bool = True,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
    kv_source: Optional[torch.Tensor] = None,
    use_rope: bool = True,
    flash: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """GQA attention.

    Modes:
      prefill: cache=None -> full self-attention, causal unless ``causal``
               is False (the encoder: no mask at all).
      decode:  cache given -> write x's K/V at ``cache_index`` (ring buffer
               modulo capacity, i.e. a sliding window when the capacity is
               below the positions seen), in place, and attend to the cache.
      cross:   ``kv_source`` (B, Sk, d) given -> K and V from it, over its
               own length: no RoPE, no cache write.  RoPE applies to
               self-attention with ``use_rope``.
    ``flash`` is the port of the reference's ``REPRO_FLASH_KERNEL`` switch
    (``src/repro/models/layers.py:172``): with it, causal self-attention
    without a cache over at least ``SDPA_CHUNK_THRESHOLD`` keys and 128
    queries runs the flash kernel; every other attention at that size
    (without it, non-causal, cross or cached) runs ``_sdpa_chunked``.
    Returns (out, cache)."""
    B, S, d = x.shape
    hd = cfg.head_dim_
    tp = getattr(p, "tp", None)
    # the rank's heads: H/M query heads, Hkv/M KV heads or (replicated) all
    H, Hkv = p.wq.shape[1] // hd, p.wk.shape[1] // hd
    dt = x.dtype
    x = copy_to_model(x, tp)
    src = x if kv_source is None else copy_to_model(kv_source, tp)
    # replicated KV weights serve part of the ranks' heads each: their
    # gradients are summed over the model axis
    kv_tp = tp if (tp is not None and Hkv == cfg.n_kv_heads) else None

    q = x @ p.wq.to(dt)
    k = src @ copy_to_model(p.wk, kv_tp).to(dt)
    v = src @ copy_to_model(p.wv, kv_tp).to(dt)
    if cfg.qkv_bias:
        q = q + p.bq.to(dt)
        k = k + copy_to_model(p.bk, kv_tp).to(dt)
        v = v + copy_to_model(p.bv, kv_tp).to(dt)
    q = shard(q.reshape(B, S, H, hd), "batch", "seq", "heads", None)
    k = shard(k.reshape(B, src.shape[1], Hkv, hd), "batch", "seq", "kv_heads", None)
    v = shard(v.reshape(B, src.shape[1], Hkv, hd), "batch", "seq", "kv_heads", None)
    if use_rope and kv_source is None:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    q = q.transpose(1, 2)  # (B,H,S,hd)
    k = k.transpose(1, 2)  # (B,Hkv,S,hd)
    v = v.transpose(1, 2)

    if cache is not None:
        cap = cache["k"].shape[2]
        _write_ring(cache["k"], k.to(cache["k"].dtype), cache_index, 2)
        _write_ring(cache["v"], v.to(cache["v"].dtype), cache_index, 2)
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
    elif causal:
        def _causal_mask(off, C):
            pos = F.pad(positions, (0, (-positions.shape[1]) % C))
            kpos_c = pos[:, off:off + C]
            return kpos_c[:, None, None, :] <= positions[:, None, :, None]

        mask_chunk_fn = _causal_mask
    else:
        mask_chunk_fn = None

    # (first, count) of the head slots of the padded layout a rank holds
    # (set when the model is cut: ``distributed.sharding.padded_heads``)
    slots = getattr(p, "slots", None)
    if slots is not None:
        # head slots of the padded layout (every KV head held): the live
        # slots take their query head's KV head, the pad slots zeros
        g = slots[0] + torch.arange(H, device=k.device)
        live = (g < cfg.n_heads)[None, :, None, None]
        heads = g.clamp(max=cfg.n_heads - 1) // (cfg.n_heads // Hkv)
        k, v = k[:, heads] * live, v[:, heads] * live
    elif kv_tp is not None:
        # every KV head held: take the ones this rank's query heads map to
        heads = (tp.rank * H + torch.arange(H, device=k.device)) // (cfg.n_heads // Hkv)
        k, v = k[:, heads], v[:, heads]
    else:
        k = _repeat_kv(k, H // Hkv)
        v = _repeat_kv(v, H // Hkv)
    # a rank's share of the padded head count (its own heads padded to it)
    Hp = cfg.pad_heads_to // (1 if tp is None else tp.size)
    if Hp and H < Hp:
        # the reference pads the head axis after the GQA repeat to a count
        # its model axis divides; the padded heads' q, k and v are zeros, so
        # their outputs are zeros (uniform weights over zero values), sliced
        # off before ``wo``
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, Hp - H)) for t in (q, k, v))
    scale = _inv_sqrt(hd)
    # the chunked (or flash) route only when both dims are large: a decode
    # step's (B, H, 1, Sk) scores are small
    if k.shape[2] >= SDPA_CHUNK_THRESHOLD and q.shape[2] >= 128:
        if flash and cache is None and causal and kv_source is None:
            out = flash_attention(q, k, v, float(1.0 / hd ** 0.5), causal=True)
        else:
            out = _sdpa_chunked(q, k, v, scale, mask_chunk_fn)
    else:
        mask = None if mask_chunk_fn is None else mask_chunk_fn(0, k.shape[2])
        out = _sdpa(q, k, v, mask, scale)
    out = out[:, :H].transpose(1, 2).reshape(B, S, H * hd)
    return reduce_from_model(out @ p.wo.to(dt), tp), cache


def _inv_sqrt(n: int) -> float:
    """1 / sqrt(n) in f32, as the reference's ``1.0 / jnp.sqrt(n)``."""
    return float(1.0 / torch.tensor(float(n), dtype=torch.float32).sqrt())


def _write_ring(buf: torch.Tensor, x: torch.Tensor, cache_index: int, axis: int) -> None:
    """Write the S rows of ``x`` into the ring buffer at ``cache_index`` mod
    its capacity, in place; the start is clamped so that the rows fit, as
    the reference's ``dynamic_update_slice`` does (decode has S == 1)."""
    cap, S = buf.shape[axis], x.shape[axis]
    slot = min(cache_index % cap, cap - S)
    buf.narrow(axis, slot, S).copy_(x)


def mla_attention_fwd(
    cfg: ArchConfig,
    p: MLAAttention,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: Optional[Dict[str, torch.Tensor]] = None,
    cache_index: Optional[int] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Multi-head Latent Attention (DeepSeek-V2).

    Prefill / train (cache=None): K and V materialised from the latent and
    the dense ``_sdpa`` at every length, as the reference (never the
    chunked route or the flash kernel).  Decode: only the latent ``ckv`` and
    the rope key ``krope`` are cached (written in place at ``cache_index``)
    and attention runs in the absorbed form, q projected into the latent
    space.  On the model axis a rank runs its H/M heads on the replicated
    latent (its weights' gradients summed over the model group) and the
    cache is replicated.  Returns (out, cache)."""
    B, S, d = x.shape
    hd, r, rd = cfg.head_dim_, cfg.kv_lora_rank, cfg.qk_rope_dim
    tp = getattr(p, "tp", None)
    H = p.wq.shape[1] // (hd + rd)           # the rank's heads
    dt = x.dtype
    scale = _inv_sqrt(hd + rd)
    x = copy_to_model(x, tp)

    q = shard((x @ p.wq.to(dt)).reshape(B, S, H, hd + rd), "batch", "seq", "heads", None)
    q_nope, q_rope = q[..., :hd], rope(q[..., hd:], positions, cfg.rope_theta)

    ckv = x @ copy_to_model(p.w_dkv, tp).to(dt)                     # (B, S, r)
    # the latent's RMS norm: eps 1e-6 (not cfg.norm_eps), the mean in f32
    ckv = ckv * torch.rsqrt(ckv.to(torch.float32).pow(2).mean(-1, keepdim=True)
                            + 1e-6).to(dt)
    ckv = ckv * copy_to_model(p.kv_norm, tp).to(dt)
    krope = rope((x @ copy_to_model(p.w_kr, tp).to(dt)).reshape(B, S, 1, rd), positions,
                 cfg.rope_theta).reshape(B, S, rd)

    if cache is None:
        k_nope = (ckv @ p.w_uk.to(dt)).reshape(B, S, H, hd)
        v = (ckv @ p.w_uv.to(dt)).reshape(B, S, H, hd)
        k = torch.cat([k_nope, krope[:, :, None, :].expand(B, S, H, rd)], dim=-1)
        qq = torch.cat([q_nope, q_rope], dim=-1)
        mask = (positions[:, None, :] <= positions[:, :, None])[:, None, :, :]
        out = _sdpa(qq.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), mask, scale)
        out = out.transpose(1, 2).reshape(B, S, H * hd)
        return reduce_from_model(out @ p.wo.to(dt), tp), None

    cckv, ckr = cache["ckv"], cache["krope"]
    cap = cckv.shape[1]
    _write_ring(cckv, ckv.to(cckv.dtype), cache_index, 1)
    _write_ring(ckr, krope.to(ckr.dtype), cache_index, 1)
    slots = torch.arange(cap, device=x.device)
    valid = (slots < min(cache_index + S, cap))[None, :]
    if cache_index + S <= cap:       # not wrapped: slot j holds position j
        qpos = cache_index + torch.arange(S, device=x.device)
        valid = valid & (slots[None, :] <= qpos[:, None])
    valid = valid[None, None]                                       # (1, 1, S, cap)

    w_uk = p.w_uk.to(dt).reshape(r, H, hd)
    q_eff = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)            # (B, S, H, r)
    scores = (torch.einsum("bshr,bcr->bhsc", q_eff, cckv.to(dt))
              + torch.einsum("bshr,bcr->bhsc", q_rope, ckr.to(dt)))
    scores = torch.where(valid, scores.to(torch.float32) * scale, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(dt)
    ctx = torch.einsum("bhsc,bcr->bshr", w, cckv.to(dt))            # (B, S, H, r)
    w_uv = p.w_uv.to(dt).reshape(r, H, hd)
    out = torch.einsum("bshr,rhd->bshd", ctx, w_uv).reshape(B, S, H * hd)
    return reduce_from_model(out @ p.wo.to(dt), tp), cache


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """``init_mlp`` (SwiGLU): ``w_gate``/``w_up (d, ff)``, ``w_down (ff, d)``;
    ``ff`` defaults to ``cfg.d_ff``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None,
                 ff: Optional[int] = None):
        super().__init__()
        d, ff = cfg.d_model, ff or cfg.d_ff
        # the ``ff`` logical axis is d_ff wide: a shared-expert or
        # dense-residual MLP of another width is not checked against it
        self.checked = ff == cfg.d_ff
        for name, shape in (("w_gate", (d, ff)), ("w_up", (d, ff)), ("w_down", (ff, d))):
            setattr(self, name, _param(shape, device, _pdtype(cfg)))
            _dense_init_(getattr(self, name), generator)


def mlp_fwd(p: MLP, x: torch.Tensor, reduce: bool = True) -> torch.Tensor:
    """SwiGLU; on the model axis over the rank's ff/M columns, the row-split
    ``w_down``'s partial sums all-reduced (``reduce=False``: the rank's
    partial sum, for the caller to add to others before one all-reduce)."""
    dt = x.dtype
    tp = getattr(p, "tp", None)
    x = copy_to_model(x, tp)
    h = F.silu(x @ p.w_gate.to(dt)) * (x @ p.w_up.to(dt))
    if p.checked:
        h = shard(h, "batch", "seq", "ff")
    out = h @ p.w_down.to(dt)
    return reduce_from_model(out, tp) if reduce else out


# ---------------------------------------------------------------------------
# MoE (the reference's scatter-based capacity dispatch, one group per batch row)
# ---------------------------------------------------------------------------

class MoE(nn.Module):
    """``init_moe``: ``router (d, E)`` (0.02 * truncated normal), the experts'
    ``w_gate``/``w_up (E, d, ff)`` and ``w_down (E, ff, d)``, and the
    optional ``shared`` MLP (``n_shared_experts * ff`` wide) and
    ``dense_residual`` MLP (``dense_residual_ff or ff``)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
        self.router = _param((d, E), device, _pdtype(cfg))
        _dense_init_(self.router, generator, scale=0.02)
        for name, shape in (("w_gate", (E, d, ff)), ("w_up", (E, d, ff)),
                            ("w_down", (E, ff, d))):
            setattr(self, name, _param(shape, device, _pdtype(cfg)))
            _dense_init_(getattr(self, name), generator)
        if cfg.n_shared_experts:
            self.shared = MLP(cfg, generator, device, ff=cfg.n_shared_experts * ff)
        if cfg.moe_dense_residual:
            self.dense_residual = MLP(cfg, generator, device, ff=cfg.dense_residual_ff or ff)


def moe_route(cfg: ArchConfig, p: MoE, x: torch.Tensor):
    """The router: softmax probabilities (B, S, E) in f32 and the top-k
    picks (B, S, k) in descending order.  ``jax.lax.top_k`` breaks ties
    towards the lower index; a stable descending sort keeps that order,
    which ``torch.topk`` does not promise."""
    logits = (x @ p.router.to(x.dtype)).to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return probs, top[..., :cfg.top_k], idx[..., :cfg.top_k]


def moe_capacity(cfg: ArchConfig, S: int) -> int:
    """Slots per expert and batch row: the reference's floor (its docstring
    says ceil), at least 1, so a decode step (S = 1) has 1."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * S / cfg.n_experts))


def moe_dispatch(idx: torch.Tensor, n_experts: int, capacity: int):
    """Per batch row, the picks in the reference's slot order: every token's
    first choice, then every token's second, and so on (``e_flat`` (B,
    k*S)); ``pos`` each pick's slot, the count of earlier picks of its
    expert in that order; ``within`` pos < capacity, the picks kept.
    Returns (e_flat, pos with the dropped picks at slot ``capacity``,
    within)."""
    B, S, k = idx.shape
    e_flat = idx.transpose(1, 2).reshape(B, k * S)
    # the one-hot laid out (B, E, k*S), so that the count runs along the
    # contiguous axis: a scan along the picks of a (B, k*S, E) one-hot took
    # a third to a half of an MoE prefill on the card
    onehot = torch.zeros((B, n_experts, k * S), dtype=torch.int32, device=idx.device)
    onehot.scatter_(1, e_flat[:, None, :], 1)
    seen = torch.cumsum(onehot, dim=-1, dtype=torch.int32).gather(1, e_flat[:, None, :])
    pos = seen[:, 0].long() - 1
    within = pos < capacity
    return e_flat, torch.where(within, pos, capacity), within


def moe_fwd(cfg: ArchConfig, p: MoE, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out, aux loss): top-k routing with per-row expert
    capacity (a pick past its expert's capacity is dropped), the experts'
    SwiGLU as one batched product per weight over the expert axis, the
    gate-weighted combine, plus the shared and dense-residual MLPs.  The
    dispatch buffer is laid out (E, B, capacity + 1, d), so each expert's
    rows of every batch row meet its weights in one ``bmm`` (a (B, E, C,
    d) @ (E, d, ff) broadcast would copy the weights B times); its last
    slot takes the dropped picks, is zeroed before the products and so
    gathers zeros, the reference's ``mode="drop"`` / ``mode="fill"``."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    dt = x.dtype
    tp = getattr(p, "tp", None)
    El = p.w_gate.shape[0]                   # the rank's experts
    e0 = 0 if tp is None else tp.rank * El

    probs, gate, idx = moe_route(cfg, p, x)
    if tp is not None:
        # the combine reads the rank's picks only: the gate path's gradient
        # is summed over the model group; the aux loss reads ``probs``
        # itself, whole on every rank, so its gradient counts once
        gate = copy_to_model(probs, tp).gather(-1, idx)
    gate = (gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)).to(dt)
    # the load-balance loss (Switch / GShard form), in f32
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(idx[..., 0], E).to(torch.float32).mean(dim=(0, 1))
    aux = E * torch.sum(me * ce) * cfg.router_aux_coef

    # the global capacity and slots, from every expert's picks
    C = moe_capacity(cfg, S)
    e_flat, pos, _ = moe_dispatch(idx, E, C)
    if tp is not None:
        # the picks of other ranks' experts go to the dropped slot
        mine = (e_flat >= e0) & (e_flat < e0 + El)
        e_flat = torch.where(mine, e_flat - e0, 0)
        pos = torch.where(mine, pos, C)
    xd = copy_to_model(x, tp)
    rows = torch.arange(B, device=x.device)[:, None].expand(B, k * S)
    buf = x.new_zeros((El, B, C + 1, d))
    buf.index_put_((e_flat, rows, pos), xd.repeat(1, k, 1))
    buf[:, :, C] = 0
    buf = shard(buf.view(El, B * (C + 1), d), "expert", None, None)
    h = F.silu(torch.bmm(buf, p.w_gate.to(dt))) * torch.bmm(buf, p.w_up.to(dt))
    yb = torch.bmm(h, p.w_down.to(dt)).view(El, B, C + 1, d)
    y_rep = yb[e_flat, rows, pos].reshape(B, k, S, d)
    out = (y_rep * gate.transpose(1, 2)[..., None]).sum(dim=1)
    whole = []
    for name in ("shared", "dense_residual"):
        mlp = getattr(p, name, None)
        if mlp is None:
            continue
        if tp is not None and getattr(mlp, "tp", None) is not None:
            out = out + mlp_fwd(mlp, x, reduce=False)   # one all-reduce with the experts'
        else:
            whole.append(mlp_fwd(mlp, x))
    out = reduce_from_model(out, tp)
    for part in whole:
        out = out + part
    return out, aux


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

class Embedding(nn.Module):
    """``init_embedding``: ``embed (V, d)`` (0.02 * normal) and, untied,
    ``unembed (d, V)``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        self.tied = cfg.tie_embeddings
        self.embed = _param((cfg.vocab_size, cfg.d_model), device, _pdtype(cfg))
        _draw_(self.embed, lambda t: t.normal_(0.0, 1.0, generator=generator).mul_(0.02))
        if not self.tied:
            self.unembed = _param((cfg.d_model, cfg.vocab_size), device, _pdtype(cfg))
            _dense_init_(self.unembed, generator)


def vocab_range(p: Embedding) -> Tuple[int, int]:
    """The [start, end) of the vocabulary block this rank holds (the whole
    vocabulary at M = 1)."""
    tp = getattr(p, "tp", None)
    n = p.embed.shape[0]
    start = 0 if tp is None else tp.rank * n
    return start, start + n


def embed_fwd(p: Embedding, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """The reference casts the whole table and gathers; gathering first and
    casting the rows gives the same values without the table's copy.  On
    the model axis each rank looks up the ids in its vocabulary block (the
    others' rows zero) and the ranks' rows are summed: exactly one is not
    zero."""
    tp = getattr(p, "tp", None)
    if tp is None:
        return p.embed[tokens.long()].to(dtype)
    start, end = vocab_range(p)
    ids = tokens.long() - start
    inside = (ids >= 0) & (ids < end - start)
    rows = p.embed[ids.clamp(0, end - start - 1)] * inside[..., None]
    return reduce_from_model(rows.to(dtype), tp)


def unembed_fwd(p: Embedding, h: torch.Tensor) -> torch.Tensor:
    """The logits; on the model axis the rank's vocabulary block of them
    (``vocab_range``)."""
    dt = h.dtype
    h = copy_to_model(h, getattr(p, "tp", None))
    if p.tied:
        out = h @ p.embed.to(dt).T
    else:
        out = h @ p.unembed.to(dt)
    return shard(out, "batch", "seq", "vocab")
