"""State-space mixers of the SSM and hybrid families: Mamba-1
(Falcon-Mamba) and Mamba-2 (Zamba2) (port of ``repro.models.ssm``).

Prefill and training run the recurrence over the whole sequence; decode is
one O(1) state update a token, which is what lets these families decode
long contexts.  State conventions, as the reference's:

  mamba1: h (B, d_inner, n)    A (d_inner, n), one decay per channel and state
  mamba2: h (B, H, p, n)       A (H,), one scalar a head (SSD)

Both carry the causal convolution's last ``kw - 1`` inputs, laid out (B,
kw - 1, d_inner) as the reference's code does (its docstring says (B,
d_inner, conv - 1)).

The recurrence h_t = decay_t * h_{t-1} + inp_t is the reference's
``jax.lax.associative_scan`` over the whole sequence, which holds the (B,
S, d_inner, n) (Mamba-2: (B, S, H, p, n)) states at once: at 2 x 8192
positions 8 GiB for Falcon-Mamba-7B and 16 GiB for Zamba2-1.2B in f32,
before the scan's temporaries.  Here the sequence is cut into chunks of
``SCAN_CHUNK`` positions: a log-depth (Hillis-Steele) scan inside each
chunk, the carry folded in across chunks by the reference's own formula
for a stateful call, ``h + cumprod(decay) * h0``, and each chunk's states
contracted with C at once, so that only one chunk's states exist.  The
scan is plain PyTorch, as the reference's is plain JAX: no TPU kernel of
the repo computes it.

**The model axis.**  A rank of M holds di/M channels (Mamba-2: Hm/M
heads): its block of x's and of z's columns of ``in_proj``
(``distributed.sharding.tp_cut``'s two runs), its channels' ``conv_w``,
``conv_b``, ``dt_bias``, ``D``, Mamba-1's ``A_log`` rows and ``dt_proj``
columns, Mamba-2's ``dt_proj`` columns and ``gnorm``; the row-split
``x_proj`` / ``bc_proj`` give partial (B, S, dtr + 2n) / (B, S, 2n)
products, summed over the model group before the scan
(``layers.sum_over_model``); Mamba-2's replicated ``A_log`` is sliced to
the rank's heads (its gradient summed) and its RMS norm over the whole
``d_inner`` sums the squares over the model group; the row-split
``out_proj``'s partial sums are all-reduced.  The scan runs unchanged on
the rank's channels, and the decode state holds them.

``delta`` is a softplus in the activation dtype, cast to f32 afterwards,
as the reference's.  ``F.softplus`` returns x itself above its threshold
of 20, where ``jax.nn.softplus`` adds log1p(exp(-x)) < 2.1e-9: below half
an f32 ulp of 20, so the two agree.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.logical import shard
from repro_torch.models import layers as L
from repro_torch.models.layers import copy_to_model, reduce_from_model, sum_over_model

# positions a chunk of the scan: its states are (B, SCAN_CHUNK, d_inner, n)
# f32 (Mamba-2: (B, SCAN_CHUNK, H, p, n)), 128 MiB at batch 2 for
# Falcon-Mamba-7B and 256 MiB for Zamba2-1.2B
SCAN_CHUNK = 128


class Mamba(nn.Module):
    """``init_mamba``: ``in_proj (d, 2 di)``, ``conv_w (kw, di)`` (0.1 *
    normal), ``conv_b`` (zeros), ``out_proj (di, d)`` and ``D`` (ones: (di,)
    for Mamba-1, one a head for Mamba-2); Mamba-1 adds ``x_proj (di, dtr +
    2n)``, ``dt_proj (dtr, di)``, ``dt_bias`` (the inverse softplus of a
    log-uniform step in [0.001, 0.1]) and ``A_log (di, n)`` (log 1..n);
    Mamba-2 adds ``bc_proj (di, 2n)``, ``dt_proj (d, H)`` (scale 0.02),
    ``dt_bias`` (zeros), ``A_log (H,)`` (log of 1..16 spaced evenly) and
    ``gnorm`` (ones)."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        d, di, n = cfg.d_model, cfg.d_inner_, cfg.ssm_state
        pd = L._pdtype(cfg)
        mamba1 = cfg.ssm_variant == "mamba1"

        def param(name, shape, init):
            setattr(self, name, L._param(shape, device, pd))
            init(getattr(self, name))

        def dense(scale=None):
            return lambda p: L._dense_init_(p, generator, scale)

        def fill(value):
            return lambda p: nn.init.constant_(p, value)

        param("in_proj", (d, 2 * di), dense())
        param("conv_w", (cfg.ssm_conv, di), lambda p: L._draw_(
            p, lambda t: t.normal_(0.0, 1.0, generator=generator).mul_(0.1)))
        param("conv_b", (di,), fill(0.0))
        param("out_proj", (di, d), dense())
        param("D", (di,) if mamba1 else (cfg.n_ssm_heads,), fill(1.0))
        if mamba1:
            dtr = cfg.dt_rank_
            lo, hi = math.log(0.001), math.log(0.1)
            param("x_proj", (di, dtr + 2 * n), dense())
            param("dt_proj", (dtr, di), dense(dtr ** -0.5))
            param("dt_bias", (di,), lambda p: L._draw_(
                p, lambda t: t.uniform_(0.0, 1.0, generator=generator).mul_(hi - lo)
                .add_(lo).exp_().expm1_().log_()))
            param("A_log", (di, n), lambda p: L._draw_(p, lambda t: t.copy_(torch.log(
                torch.arange(1, n + 1, dtype=torch.float32)).expand(di, n))))
        else:
            Hm = cfg.n_ssm_heads
            param("bc_proj", (di, 2 * n), dense())
            param("dt_proj", (d, Hm), dense(0.02))
            param("dt_bias", (Hm,), fill(0.0))
            param("A_log", (Hm,), lambda p: L._draw_(p, lambda t: t.copy_(torch.log(
                torch.linspace(1.0, 16.0, Hm, dtype=torch.float32)))))
            param("gnorm", (di,), fill(1.0))


def state_shapes(cfg: ArchConfig, batch: int, M: int = 1) -> Dict[str, Tuple[int, ...]]:
    """One layer's decode state: the conv ring ``(B, kw - 1, di)`` and ``h``;
    a model rank's of M holds di/M channels (Hm/M heads), as
    ``distributed.sharding.cache_specs`` places them."""
    di, n = cfg.d_inner_ // M, cfg.ssm_state
    h = ((batch, di, n) if cfg.ssm_variant == "mamba1"
         else (batch, cfg.n_ssm_heads // M, cfg.ssm_head_dim, n))
    return {"conv": (batch, cfg.ssm_conv - 1, di), "h": h}


def init_ssm_state(cfg: ArchConfig, batch: int, dtype, device=None,
                   lead: Tuple[int, ...] = (), M: int = 1) -> Dict[str, torch.Tensor]:
    """Zero decode state: ``conv`` in ``dtype`` (the activations'), ``h`` in
    f32, each ``lead + state_shapes(...)`` (``lead`` stacks layers, as the
    reference's vmap does; a model rank's of M)."""
    shapes = state_shapes(cfg, batch, M)
    return {"conv": torch.zeros(tuple(lead) + shapes["conv"], dtype=dtype, device=device),
            "h": torch.zeros(tuple(lead) + shapes["h"], dtype=torch.float32, device=device)}


def _causal_conv(cfg: ArchConfig, p: Mamba, x: torch.Tensor,
                 conv_state: Optional[torch.Tensor]):
    """Depthwise causal convolution along S.  x (B, S, di).  Returns (y,
    the new conv state, or None without one)."""
    S = x.shape[1]
    kw = cfg.ssm_conv
    if conv_state is None:
        ctx = F.pad(x, (0, 0, kw - 1, 0))
        new_state = None
    else:
        ctx = torch.cat([conv_state.to(x.dtype), x], dim=1)
        new_state = ctx[:, -(kw - 1):]
    w = p.conv_w.to(x.dtype)                          # (kw, di)
    y = sum(ctx[:, i:i + S] * w[i] for i in range(kw))
    return y + p.conv_b.to(x.dtype), new_state


def _assoc_scan(decay: torch.Tensor, inp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = decay_t * h_{t-1} + inp_t along axis 1 from a zero state, by a
    log-depth (Hillis-Steele) scan, each step the reference's combine
    (da * db, xa * db + xb); ``decay`` broadcasts against ``inp``.  Returns
    (h, the running product of ``decay``)."""
    T = inp.shape[1]
    off = 1
    while off < T:
        inp = torch.cat([inp[:, :off], torch.addcmul(inp[:, off:], decay[:, off:],
                                                     inp[:, :-off])], dim=1)
        decay = torch.cat([decay[:, :off], decay[:, off:] * decay[:, :-off]], dim=1)
        off *= 2
    return inp, decay


def _chunked_scan(S: int, decay_of: Callable, inp_of: Callable, contract: Callable,
                  h0: Optional[torch.Tensor]):
    """The recurrence over S positions, ``SCAN_CHUNK`` at a time:
    ``decay_of(sl)`` and ``inp_of(sl)`` are a chunk's decays and inputs,
    ``contract(h, sl)`` its outputs from its states; ``h0`` the initial state
    or None (zero).  Returns (the outputs joined along S, the last state)."""
    ys, carry = [], h0
    for s0 in range(0, S, SCAN_CHUNK):
        sl = slice(s0, min(s0 + SCAN_CHUNK, S))
        h, cum = _assoc_scan(decay_of(sl), inp_of(sl))
        if carry is not None:
            h = h + cum * carry[:, None]
        ys.append(contract(h, sl))
        # a copy, and the chunk's states freed before the next chunk's exist
        carry = h[:, -1].clone()
        del h, cum
    return torch.cat(ys, dim=1) if len(ys) > 1 else ys[0], carry


def mamba_fwd(cfg: ArchConfig, p: Mamba, x: torch.Tensor,
              state: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Mamba mixer forward.  x (B, S, d).  With ``state`` ({"conv", "h"})
    the call is stateful at any S (S > 1 folds ``h`` in, as the
    reference's); returns (out, the new state, or None without one).  On
    the model axis over the rank's channels (see the module docstring)."""
    B, S, _ = x.shape
    tp = getattr(p, "tp", None)
    di, n = p.conv_w.shape[1], cfg.ssm_state          # the rank's channels
    dt, f32 = x.dtype, torch.float32
    x = copy_to_model(x, tp)

    xz = x @ p.in_proj.to(dt)
    xin, z = xz.chunk(2, dim=-1)
    xin = shard(xin, "batch", "seq", "inner")
    xc, new_conv = _causal_conv(cfg, p, xin, None if state is None else state["conv"])
    xc = F.silu(xc)
    h0 = None if state is None else state["h"]

    if cfg.ssm_variant == "mamba1":
        dtr = cfg.dt_rank_
        proj = sum_over_model(xc @ p.x_proj.to(dt), tp)            # (B, S, dtr + 2n)
        dt_in, Bc, Cc = proj.split([dtr, n, n], dim=-1)
        delta = F.softplus(dt_in @ p.dt_proj.to(dt) + p.dt_bias.to(dt))
        A = -torch.exp(p.A_log).to(f32)                             # (di, n)
        deltaf = delta.to(f32)
        u = deltaf * xc.to(f32)                                     # (B, S, di)
        Bf, Cf = Bc.to(f32), Cc.to(f32)
        y, new_h = _chunked_scan(
            S, lambda sl: torch.exp(deltaf[:, sl, :, None] * A),     # (B, T, di, n)
            lambda sl: u[:, sl, :, None] * Bf[:, sl, None, :],
            lambda h, sl: torch.matmul(h, Cf[:, sl, :, None])[..., 0].to(dt), h0)
        y = y + xc * p.D.to(dt)
    else:  # mamba2 / SSD
        Hm, hp = p.dt_bias.shape[0], cfg.ssm_head_dim               # the rank's heads
        bc = sum_over_model(xc @ p.bc_proj.to(dt), tp)
        Bc, Cc = bc.chunk(2, dim=-1)                                # (B, S, n) each
        delta = F.softplus(x @ p.dt_proj.to(dt) + p.dt_bias.to(dt))  # (B, S, Hm)
        A_log = p.A_log if tp is None else \
            copy_to_model(p.A_log, tp).narrow(0, tp.rank * Hm, Hm)
        A = -torch.exp(A_log).to(f32)                               # (Hm,)
        deltaf = delta.to(f32)
        decay = torch.exp(deltaf * A)[..., None, None]              # (B, S, Hm, 1, 1)
        u = deltaf[..., None] * xc.reshape(B, S, Hm, hp).to(f32)    # (B, S, Hm, hp)
        Bf, Cf = Bc.to(f32), Cc.to(f32)
        y, new_h = _chunked_scan(
            S, lambda sl: decay[:, sl],
            lambda sl: u[:, sl, :, :, None] * Bf[:, sl, None, None, :],   # (B, T, Hm, hp, n)
            lambda h, sl: torch.einsum("bshpn,bsn->bshp", h, Cf[:, sl]).to(dt), h0)
        y = y.reshape(B, S, di) + xc * p.D.to(dt).repeat_interleave(hp)
        # grouped RMS norm over the whole d_inner axis (Mamba-2 normalises
        # before the gate): the mean in f32, eps 1e-6
        if tp is None:
            ms = y.to(f32).pow(2).mean(-1, keepdim=True)
        else:
            ms = sum_over_model(y.to(f32).pow(2).sum(-1, keepdim=True), tp) / cfg.d_inner_
        y = y * torch.rsqrt(ms + 1e-6).to(dt)
        y = y * p.gnorm.to(dt)

    y = y * F.silu(z)
    out = reduce_from_model(y @ p.out_proj.to(dt), tp)
    return out, (None if state is None else {"conv": new_conv, "h": new_h})
