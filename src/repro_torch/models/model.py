"""The LM of every family of ``repro.models.model``: the decoder-only dense,
MoE, SSM, hybrid and VLM families and the encoder-decoder.

Public API, as the reference's:
  init_params(cfg, generator, device)     -> DecoderLM
  forward(cfg, params, batch, flash=True) -> (logits, aux_loss)
  loss_fn(cfg, params, batch)             -> (loss, {"ce", "aux"})
  init_cache(cfg, batch, total_len, ...)  -> decode cache
  decode_step(cfg, params, cache, tokens) -> (logits, cache)
  params_from_jax(tree, cfg, device)      -> DecoderLM with the reference's weights

The reference scans stacked layers; here the layers are a ``ModuleList``
and the scan a loop.  An MoE model (``cfg.n_experts``) has
``first_dense_layers`` dense blocks first, the reference's unstacked
``prefix_layers`` list, then MoE blocks; MLA (``cfg.use_mla``) replaces
GQA attention in every block.  An SSM model (Falcon-Mamba) is a stack of
``MambaBlock``s (Mamba-1); a hybrid (Zamba2) is a stack of Mamba-2
``MambaBlock``s in G = ``n_layers / shared_attn_every`` groups, each group
led by one ``shared_attn`` block (its parameters shared by every group) on
``concat(h, h0) @ in_proj``, ``h0`` the embedding output.  The decode
cache keeps the reference's layout, the scanned layers stacked on a
leading axis (``{"idx", "prefix": [...], "layers": {"k", "v"} or {"ckv",
"krope"}}``; SSM ``{"idx", "layers": {"conv", "h"}}``; hybrid ``{"idx",
"layers": {"attn": {"k", "v"}, "mamba": {"conv", "h"}}}`` stacked (G, ...)
and (G, every, ...); encoder-decoder ``{"idx", "enc_out", "layers"}``),
and ``decode_step`` writes it in place.  The encoder-decoder (Seamless)
runs stub frame embeddings (B, S_enc, d) through ``enc_in_proj``, a stack
of non-causal dense ``enc_layers`` and ``enc_norm``; its decoder blocks
cross-attend to that output (``Block(cross=True)``: ``ln_x``, ``xattn``,
between the self-attention and the FFN).  The VLM (LLaVA) maps stub patch
embeddings (B, n_modal, ``MODAL_EMBED_DIM``) through the two-layer GELU
``projector`` and prepends them to the token embeddings.  Parameters
are created in ``cfg.param_dtype`` (Arctic's bf16: each leaf, or each
expert slab, drawn in f32 and cast, as the reference casts its f32 init).
With ``cfg.remat`` every block (the dense, MoE and cross blocks, the MoE's
dense prefix blocks, the encoder's blocks), the Mamba layer and the
hybrid's group are recomputed in the backward (the reference's
``jax.checkpoint`` of its scanned bodies): the same values, less memory.

On a mesh with a ``model`` axis of M > 1 a model of any family is cut
(``cut_model_``): each rank holds its blocks of the one-card model (the
tensor-parallel layers of ``models.layers`` and ``models.ssm``), the
logits are its vocabulary block, and the cross-entropy meets across the
model group (``_nll``: the max, the sum of exponentials and the target's
logit from the rank that holds it), chunked or not as at M = 1.  The
hybrid's shared block holds its ``in_proj``'s d/M output columns; their
outputs are gathered over the model group before the block
(``layers.gather_from_model``).  The encoder-decoder's ``enc_in_proj``
and ``enc_norm`` are replicated and its encoder blocks are dense blocks:
the encoder output is whole on every rank, and each cross-attention
takes its heads' K and V from it.  The VLM's projector is split as an
MLP: ``w1`` by columns, ``w2`` by rows (``_project``).

On a grid (``launch.mesh``: the data axis as processes) the model is also
cut over ``data`` (``shard_data_``): each rank keeps the FSDP blocks of
its model block (``core.flatten.layout_fsdp``, the reference's
``param_specs(fsdp=True)``).  The forward gathers each layer's weights
over the data group just before that layer and frees them after it (the
reference's "weights all-gather per layer"): the embedding, the
encoder's input projection, each encoder block and its final norm, the
projector, each prefix block, block or Mamba layer, the final norm, the
unembedding, one at a time (``_gathered``); the hybrid's shared block is
gathered at each of its uses, once a group.  The trainer gathers the whole model block once
per step (``whole_block``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import flatten as FL
from repro_torch.kernels.common import resolve_device
from repro_torch.launch.mesh import ModelAxis, model_size
from repro_torch.models import layers as L
from repro_torch.models import ssm as SSM

Params = Dict[str, Any]

MODAL_EMBED_DIM = 1024  # stubbed ViT/conv frontend output width


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

class Block(nn.Module):
    """``init_block``: ``ln1``, ``attn`` (GQA, or MLA with ``cfg.use_mla``),
    ``ln2`` and ``ffn``, the SwiGLU MLP (``kind="dense"``) or the MoE FFN
    (``kind="moe"``); with ``cross`` (the encoder-decoder's decoder) also
    ``ln_x`` and the cross-attention ``xattn``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None,
                 kind: str = "dense", cross: bool = False):
        super().__init__()
        self.kind = kind
        self.ln1 = L.Norm(cfg, cfg.d_model, device)
        self.attn = (L.MLAAttention if cfg.use_mla else L.Attention)(cfg, generator, device)
        self.ln2 = L.Norm(cfg, cfg.d_model, device)
        self.ffn = (L.MoE if kind == "moe" else L.MLP)(cfg, generator, device)
        if cross:
            self.ln_x = L.Norm(cfg, cfg.d_model, device)
            self.xattn = L.Attention(cfg, generator, device)


def block_fwd(cfg: ArchConfig, p: Block, h: torch.Tensor, positions: torch.Tensor, *,
              causal: bool = True, cache: Optional[Params] = None, cache_index=None,
              enc_out: Optional[torch.Tensor] = None,
              flash: bool = True) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Returns (h, cache, aux): the MoE FFN's load-balance loss, else 0.
    ``causal=False``: the encoder's self-attention; ``enc_out`` (B, S_enc,
    d): a cross block attends to it (no mask, no RoPE) after its
    self-attention."""
    a_in = L.norm_fwd(p.ln1, h)
    if cfg.use_mla:
        attn_out, new_cache = L.mla_attention_fwd(cfg, p.attn, a_in, positions, cache=cache,
                                                  cache_index=cache_index)
    else:
        attn_out, new_cache = L.attention_fwd(cfg, p.attn, a_in, positions, causal=causal,
                                              cache=cache, cache_index=cache_index,
                                              flash=flash)
    h = h + attn_out
    if enc_out is not None:
        x_out, _ = L.attention_fwd(cfg, p.xattn, L.norm_fwd(p.ln_x, h), positions,
                                   causal=False, kv_source=enc_out, use_rope=False)
        h = h + x_out
    f_in = L.norm_fwd(p.ln2, h)
    if p.kind == "moe":
        f_out, aux = L.moe_fwd(cfg, p.ffn, f_in)
    else:
        f_out = L.mlp_fwd(p.ffn, f_in)
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h + f_out, new_cache, aux


class MambaBlock(nn.Module):
    """``init_mamba_block``: ``ln`` and the Mamba ``mixer``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        self.ln = L.Norm(cfg, cfg.d_model, device)
        self.mixer = SSM.Mamba(cfg, generator, device)


def mamba_block_fwd(cfg: ArchConfig, p: MambaBlock, h: torch.Tensor, state=None):
    """Returns (h, the mixer's new state or None)."""
    out, new_state = SSM.mamba_fwd(cfg, p.mixer, L.norm_fwd(p.ln, h), state)
    return h + out, new_state


class SharedAttention(nn.Module):
    """The hybrid's ``shared_attn``: ``in_proj (2d, d)`` and one dense
    ``block``, invoked once a group."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        self.in_proj = L._param((2 * cfg.d_model, cfg.d_model), device, L._pdtype(cfg))
        L._dense_init_(self.in_proj, generator)
        self.block = Block(cfg, generator, device)


class Projector(nn.Module):
    """The VLM's modal ``projector``: ``w1 (MODAL_EMBED_DIM, d)``, ``w2 (d,
    d)``; on the model axis (``tp``) ``w1``'s d/M columns and ``w2``'s d/M
    rows."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None):
        super().__init__()
        for name, shape in (("w1", (MODAL_EMBED_DIM, cfg.d_model)),
                            ("w2", (cfg.d_model, cfg.d_model))):
            setattr(self, name, L._param(shape, device, L._pdtype(cfg)))
            L._dense_init_(getattr(self, name), generator)


def _n_prefix(cfg: ArchConfig) -> int:
    return cfg.first_dense_layers if cfg.n_experts else 0


def _has_projector(cfg: ArchConfig) -> bool:
    return cfg.family == "vlm" or cfg.modality == "vision"


class DecoderLM(nn.Module):
    """``init_params`` of the LM: ``embedding``, ``final_norm``, for an
    MoE model ``prefix_layers`` (its ``first_dense_layers`` dense blocks),
    and ``layers`` (the reference's stacked L axis, one module per layer;
    MoE blocks in an MoE model, ``MambaBlock``s in an SSM or hybrid model,
    cross blocks in an encoder-decoder); a hybrid adds ``shared_attn``, an
    encoder-decoder ``enc_in_proj (d, d)``, ``enc_layers`` (``n_enc_layers``
    dense blocks, stacked as ``layers``) and ``enc_norm``, a VLM the
    ``projector``."""

    def __init__(self, cfg: ArchConfig, generator: torch.Generator, device=None,
                 cut: Optional[Tuple[Any, int]] = None):
        super().__init__()
        L.check_family(cfg)
        self.cfg = cfg
        # the model axis: set by ``cut_model_``; ``cut`` (mesh, model rank)
        # keeps each module's blocks as soon as it is drawn (``_keep``), so
        # that one whole module exists at a time
        self.tp = None
        self.tp_specs: Dict[str, tuple] = {}
        self.tp_cuts: Dict[str, tuple] = {}
        self._cut = cut
        # the data axis: set by ``shard_data_`` (``fsdp_blocks``: the
        # parameters are their FSDP blocks, not the whole model block;
        # ``fsdp_dims``: id of each parameter split over data -> its dim)
        self.dp = None
        self.fsdp = None
        self.fsdp_blocks = False
        self.fsdp_dims: Dict[int, int] = {}
        keep = self._keep
        self.embedding = keep("embedding", L.Embedding(cfg, generator, device))
        self.final_norm = L.Norm(cfg, cfg.d_model, device)
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(keep(f"layers.{i}", MambaBlock(cfg, generator, device))
                                        for i in range(cfg.n_layers))
            if cfg.family == "hybrid":
                self.shared_attn = keep("shared_attn", SharedAttention(cfg, generator, device))
            return
        if cfg.is_encoder_decoder:
            self.enc_in_proj = L._param((cfg.d_model, cfg.d_model), device, L._pdtype(cfg))
            L._dense_init_(self.enc_in_proj, generator)
            self.enc_layers = nn.ModuleList(keep(f"enc_layers.{i}", Block(cfg, generator, device))
                                            for i in range(cfg.n_enc_layers))
            self.enc_norm = L.Norm(cfg, cfg.d_model, device)
            self.layers = nn.ModuleList(keep(f"layers.{i}",
                                             Block(cfg, generator, device, cross=True))
                                        for i in range(cfg.n_layers))
            return
        n_prefix = _n_prefix(cfg)
        if n_prefix:
            self.prefix_layers = nn.ModuleList(keep(f"prefix_layers.{i}",
                                                    Block(cfg, generator, device))
                                               for i in range(n_prefix))
        kind = "moe" if cfg.n_experts else "dense"
        self.layers = nn.ModuleList(keep(f"layers.{i}", Block(cfg, generator, device, kind))
                                    for i in range(cfg.n_layers - n_prefix))
        if _has_projector(cfg):
            self.projector = keep("projector", Projector(cfg, generator, device))

    def _keep(self, prefix: str, mod: nn.Module) -> nn.Module:
        """``mod`` (the submodule at ``prefix``), its parameters cut to the
        model rank's blocks when the model is drawn cut."""
        if self._cut is not None:
            _cut_params_(self.cfg, mod, prefix, *self._cut, self.tp_specs, self.tp_cuts)
        return mod


def _cut_params_(cfg: ArchConfig, mod: nn.Module, prefix: str, mesh, rank: int,
                 specs: Dict[str, tuple], cuts: Dict[str, tuple]) -> None:
    """Keep, in place, model rank ``rank``'s block of every parameter of
    ``mod`` not cut yet (``specs`` names the cut ones), recording each
    parameter's spec in ``specs`` and each split one's cut and whole
    extent in ``cuts`` (names prefixed with ``prefix``)."""
    from repro_torch.distributed import sharding as shd

    with torch.no_grad():
        for name, p in mod.named_parameters():
            name = f"{prefix}.{name}" if prefix else name
            if name in specs:
                continue
            spec = shd.tp_layout(cfg, name.rsplit(".", 1)[-1], tuple(p.shape), mesh)
            specs[name] = spec
            if "model" in spec:
                cut = shd.tp_cut(cfg, name, tuple(p.shape), mesh)
                cuts[name] = (cut, p.shape[cut.dim])
                p.data = shd.shard_tensor(p.data, spec, mesh, rank, cut)


def cut_model_(cfg: ArchConfig, model: DecoderLM, mesh, rank: Optional[int] = None
               ) -> DecoderLM:
    """Keep, in place, the block of every parameter that model rank
    ``rank`` (default: this process's rank in ``mesh.model_group``) holds
    (``distributed.sharding.tp_layout`` and ``tp_cut``), and give the TP
    layers their ``ModelAxis``; ``model.tp_specs`` maps each parameter's
    name to its spec, ``model.tp_cuts`` each split one's to its cut and
    whole extent.  A mesh of M = 1 leaves the model whole."""
    from repro_torch.distributed import sharding as shd

    M = model_size(mesh)
    if model._cut is None:
        model.tp_specs, model.tp_cuts = {}, {}
    if M == 1:
        return model
    _check_split(cfg, M)
    axis = mesh.model_axis() if rank is None else ModelAxis(mesh.model_group, M, rank)
    # the parameters drawn cut (``DecoderLM(cut=)``) are kept as they are
    _cut_params_(cfg, model, "", mesh, axis.rank, model.tp_specs, model.tp_cuts)
    model._cut = None
    slots = cfg.pad_heads_to // M if shd.padded_heads(cfg, M) else 0
    for name, mod in model.named_modules():
        if isinstance(mod, (L.Attention, L.MLAAttention, L.MoE, SSM.Mamba)):
            mod.tp = axis
            if slots and isinstance(mod, L.Attention):
                mod.slots = (axis.rank * slots, slots)
        elif isinstance(mod, L.MLP):
            mod.tp = axis if "model" in model.tp_specs[f"{name}.w_gate"] else None
        elif isinstance(mod, L.Embedding):
            mod.tp = axis if "model" in model.tp_specs[f"{name}.embed"] else None
        elif isinstance(mod, SharedAttention):
            mod.tp = axis if "model" in model.tp_specs[f"{name}.in_proj"] else None
        elif isinstance(mod, Projector):
            mod.tp = axis if "model" in model.tp_specs[f"{name}.w1"] else None
    model.tp = axis
    return model


def _check_split(cfg: ArchConfig, M: int) -> None:
    """Raise for a model the model axis of M cannot cut: a config the
    reference cannot run, a Mamba mixer whose channels or heads M does not
    divide."""
    L.check_family(cfg)
    if cfg.family in ("ssm", "hybrid") and (cfg.d_inner_ % M or (
            cfg.ssm_variant == "mamba2" and cfg.n_ssm_heads % M)):
        raise NotImplementedError(
            f"{cfg.name}: d_inner = {cfg.d_inner_} ({cfg.n_ssm_heads} heads) does not split "
            f"over model = {M}")


def fsdp_layout(cfg: ArchConfig, model: DecoderLM, mesh) -> FL.FSDPLayout:
    """The FSDP layout of a model block (whole, or cut over ``model``) on
    the grid's data axis: per leaf the dim ``sharding.fsdp_dim`` splits
    over the data axes (``("pod", "data")`` across pods), judged on the
    whole leaf's shape, and the block's per-layer shapes."""
    from repro_torch.distributed import sharding as shd

    dax = mesh.data_axis()
    data_axes = ("pod", "data") if mesh.shape.get("pod") else ("data",)
    M = model_size(mesh)
    dims, shapes = {}, {}
    for (path, ps), mdim in zip(FL.leaf_params(model), FL.split_dims(model)):
        shape = list(FL.leaf_shape(path, ps))
        if mdim is not None:
            shape[mdim] *= M
        name = [k for k in path if isinstance(k, str)][-1]
        dims[path] = shd.fsdp_dim(cfg, name, tuple(shape), data_axes, mesh)
        shapes[path] = tuple(ps[0].shape)
    return FL.FSDPLayout(dax.size, dax.rank, dims, shapes)


def shard_data_(cfg: ArchConfig, model: DecoderLM, mesh,
                blocks: Optional[bool] = True) -> DecoderLM:
    """On a grid, keep in place the FSDP blocks of the model block that this
    rank's data index holds (``core.flatten.layout_fsdp``; ``blocks=False``:
    the layout only, the parameters stay the whole model block; None: the
    model as it is, e.g. for the flat layout over the data group).  A mesh
    whose data axis runs in one process leaves the model as it is."""
    dax = None if mesh is None else mesh.data_axis()
    if dax is None or blocks is None:
        return model
    model.dp = dax
    layout = fsdp_layout(cfg, model, mesh)
    if blocks:
        FL.layout_fsdp(model, layout)
        model.fsdp_dims = {id(p): d - 1 if path[0] in FL.STACKED else d
                           for path, ps in FL.leaf_params(model)
                           if (d := layout.dims[path]) is not None for p in ps}
    else:
        model.fsdp = layout
    return model


@contextlib.contextmanager
def whole_block(model: DecoderLM):
    """The whole model block for a step: every column group's blocks
    gathered over the data group in rank order (one all-gather a group) and
    the parameters made views of the model block's natural buffers
    (``core.flatten.unpack_fsdp_``); after it the blocks again, the
    gathered block freed.  A model that holds its whole block: as it is."""
    if not model.fsdp_blocks:
        yield
        return
    from repro_torch.distributed.spmd import all_gather_rows

    bufs = FL.fsdp_buffers(model)
    K = model.dp.size
    mats = [(all_gather_rows(b, model.dp.group) if b.numel() else b.view(K, 0)) if split
            else b for b, split in zip(bufs, FL.fsdp_split(model))]
    FL.unpack_fsdp_(model, mats)
    del mats
    try:
        yield
    finally:
        FL.point_fsdp_(model, bufs)


@contextlib.contextmanager
def _gathered(model: DecoderLM, *mods):
    """The parameters of the modules (or the parameters) ``mods`` whole for
    the enclosed use: their FSDP blocks gathered over the data group in
    rank order (one all-gather) and freed after it.  A model that holds
    its whole block: as it is."""
    if not model.fsdp_blocks:
        yield
        return
    from repro_torch.distributed.spmd import all_gather_rows

    dims = model.fsdp_dims
    ps = [p for m in mods for p in (m.parameters() if isinstance(m, nn.Module) else (m,))
          if id(p) in dims]
    blocks = [p.data for p in ps]
    if ps:
        K = model.dp.size
        rows = all_gather_rows(torch.cat([b.reshape(-1) for b in blocks]), model.dp.group)
        off = 0
        for p, b in zip(ps, blocks):
            n, d = b.numel(), dims[id(p)]
            shape = list(b.shape)
            shape[d] *= K
            p.data = rows[:, off:off + n].view((K,) + tuple(b.shape)).movedim(0, d) \
                .reshape(shape)
            off += n
        del rows
    try:
        yield
    finally:
        for p, b in zip(ps, blocks):
            p.data = b


def init_params(cfg: ArchConfig, generator: Optional[torch.Generator] = None,
                device=None, mesh=None, rank: Optional[int] = None,
                fsdp: Optional[bool] = True) -> DecoderLM:
    """A randomly initialised model on ``device`` (None: the card; "meta":
    shapes only), its values drawn from ``generator`` (default: seed 0 on
    that device).  On a mesh with ``model`` = M > 1 the whole model is
    drawn as at M = 1 and model rank ``rank`` keeps its blocks
    (``cut_model_``): the M ranks' model is the one-card model, cut.  On a
    grid (the data axis as processes) each rank then keeps its FSDP blocks
    (``shard_data_``; ``fsdp=False``: the whole model block).  Each block
    is cut as soon as it is drawn, so one whole block exists at a time
    beside the rank's blocks: a model whose whole exceeds the card is
    drawn cut."""
    dev = resolve_device(device)
    M = model_size(mesh)
    cut = None
    if M > 1:
        _check_split(cfg, M)
        cut = (mesh, mesh.model_axis().rank if rank is None else rank)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        model = cut_model_(cfg, DecoderLM(cfg, generator, dev, cut=cut), mesh, rank)
        return shard_data_(cfg, model, mesh, blocks=fsdp)


def _remat(cfg: ArchConfig, fn, *args):
    """``fn(*args)``; under autograd with ``cfg.remat``, checkpointed: its
    activations are recomputed in the backward instead of kept (the
    reference's ``jax.checkpoint`` of a scanned body)."""
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _scan_mamba(cfg: ArchConfig, params: "DecoderLM", blocks, h: torch.Tensor,
                states: Optional[Params] = None) -> torch.Tensor:
    """The reference's ``_scan_mamba`` as a loop over ``blocks`` (of
    ``params``); with ``states`` (``conv`` and ``h`` stacked on a leading
    axis, one slice a block) each block's new state is written into its
    slice in place."""
    for i, lp in enumerate(blocks):
        with _gathered(params, lp):
            if states is None:
                h = _remat(cfg, lambda x, lp=lp: mamba_block_fwd(cfg, lp, x)[0], h)
                continue
            h, new = mamba_block_fwd(cfg, lp, h, {k: t[i] for k, t in states.items()})
        for k, t in states.items():
            t[i].copy_(new[k])
    return h


def _shared_attn_apply(cfg: ArchConfig, p_sh: SharedAttention, h: torch.Tensor,
                       h0: torch.Tensor, positions: torch.Tensor, cache=None,
                       cache_index=None, flash: bool = True) -> torch.Tensor:
    """Zamba's shared block: ``concat(h, h0) @ in_proj`` through the dense
    block, added to ``h``.  The block adds its own input as well, so that
    input enters twice, as in the reference."""
    tp = getattr(p_sh, "tp", None)
    x = L.copy_to_model(torch.cat([h, h0], dim=-1), tp) @ p_sh.in_proj.to(h.dtype)
    x = L.gather_from_model(x, tp)
    out, _, _ = block_fwd(cfg, p_sh.block, x, positions, cache=cache, cache_index=cache_index,
                          flash=flash)
    return h + out


def _hybrid_trunk(cfg: ArchConfig, params: DecoderLM, h: torch.Tensor,
                  positions: torch.Tensor, caches: Optional[Params] = None, cache_index=None,
                  flash: bool = True) -> torch.Tensor:
    """The reference's ``_hybrid_trunk``: G groups, each the shared block,
    then ``shared_attn_every`` Mamba layers (group g: layers g * every ..
    (g + 1) * every - 1).  With ``caches`` (``attn`` stacked (G, ...),
    ``mamba`` (G, every, ...)) each group's slices are written in place."""
    every = cfg.shared_attn_every
    h0 = h
    for g in range(cfg.n_layers // every):
        blocks = params.layers[g * every:(g + 1) * every]
        if caches is None:
            def group(x, x0, blocks=blocks):
                with _gathered(params, params.shared_attn):
                    x = _shared_attn_apply(cfg, params.shared_attn, x, x0, positions,
                                           flash=flash)
                return _scan_mamba(cfg, params, blocks, x)

            h = _remat(cfg, group, h, h0)
            continue
        attn = {k: t[g] for k, t in caches["attn"].items()}
        with _gathered(params, params.shared_attn):
            h = _shared_attn_apply(cfg, params.shared_attn, h, h0, positions, attn,
                                   cache_index, flash)
        h = _scan_mamba(cfg, params, blocks, h, {k: t[g] for k, t in caches["mamba"].items()})
    return h


def _trunk(cfg: ArchConfig, params: DecoderLM, h: torch.Tensor, positions: torch.Tensor,
           caches: Optional[Params] = None, cache_index=None, flash: bool = True,
           enc_out: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The prefix blocks, then the reference's ``_scan_blocks`` as a loop;
    the stacked caches' layer slices are views, written in place; every
    block cross-attends to ``enc_out`` when it is given.  Returns (h,
    aux): the prefix blocks' aux added in order, then the scanned layers'
    sum, as the reference.  The SSM and hybrid trunks have no aux (0)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    layer_caches = None if caches is None else caches["layers"]
    if cfg.family == "ssm":
        return _scan_mamba(cfg, params, params.layers, h, layer_caches), aux
    if cfg.family == "hybrid":
        return _hybrid_trunk(cfg, params, h, positions, layer_caches, cache_index, flash), aux
    for i, lp in enumerate(getattr(params, "prefix_layers", ())):
        cache = None if caches is None else caches["prefix"][i]
        with _gathered(params, lp):
            h, a = _block(cfg, lp, h, positions, cache, cache_index, flash=flash)
        aux = aux + a
    auxs = []
    for i, lp in enumerate(params.layers):
        cache = None if caches is None else {n: t[i] for n, t in caches["layers"].items()}
        with _gathered(params, lp):
            h, a = _block(cfg, lp, h, positions, cache, cache_index, enc_out=enc_out,
                          flash=flash)
        auxs.append(a)
    return h, (aux + torch.stack(auxs).sum()) if auxs else aux


def _block(cfg: ArchConfig, lp: Block, h: torch.Tensor, positions: torch.Tensor, cache,
           cache_index, **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """One block's (h, aux); without a cache under ``_remat`` (a decode
    step writes its cache in place and is never rematerialised)."""
    if cache is not None:
        h, _, a = block_fwd(cfg, lp, h, positions, cache=cache, cache_index=cache_index, **kw)
        return h, a
    return _remat(cfg, lambda x: block_fwd(cfg, lp, x, positions, **kw)[::2], h)


# ---------------------------------------------------------------------------
# forward (prefill / single-shot)
# ---------------------------------------------------------------------------

def _encode(cfg: ArchConfig, params: DecoderLM, frames: torch.Tensor) -> torch.Tensor:
    """The encoder-decoder's encoder: ``frames @ enc_in_proj``, the
    non-causal dense ``enc_layers`` (positions 0 .. S_enc - 1) and
    ``enc_norm``, (B, S_enc, d) in the activation dtype.  ``decode_step``
    reads it from ``cache["enc_out"]``, which the caller fills.  On the
    model axis the replicated ``enc_in_proj``'s gradient is whole on every
    rank: the first block's ``copy_to_model`` sums its input's gradient
    over the model group."""
    dt = _dtype(cfg)
    frames = frames.to(dt)
    with _gathered(params, params.enc_in_proj):
        h = frames @ params.enc_in_proj.to(dt)
    pos = torch.arange(frames.shape[1], device=h.device).expand(frames.shape[:2])
    for lp in params.enc_layers:
        with _gathered(params, lp):
            h, _ = _block(cfg, lp, h, pos, None, None, causal=False)
    with _gathered(params, params.enc_norm):
        return L.norm_fwd(params.enc_norm, h)


def _project(cfg: ArchConfig, params: DecoderLM, patch_embeds: torch.Tensor) -> torch.Tensor:
    """The VLM's ``gelu(pe @ w1) @ w2``: ``jax.nn.gelu``'s default is the tanh
    form.  On the model axis the GELU runs on the rank's d/M columns of
    ``pe @ w1`` and the row-split ``w2``'s partial sums are all-reduced."""
    dt = _dtype(cfg)
    proj = params.projector
    tp = getattr(proj, "tp", None)
    with _gathered(params, proj):
        pe = L.copy_to_model(patch_embeds.to(dt), tp)
        pe = F.gelu(pe @ proj.w1.to(dt), approximate="tanh")
        return L.reduce_from_model(pe @ proj.w2.to(dt), tp)


def _hidden(cfg: ArchConfig, params: DecoderLM, batch: Dict[str, torch.Tensor],
            flash: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trunk's output after the final norm, (B, S, d), and its aux: an
    encoder-decoder's decoder over ``tokens`` cross-attending to the
    encoded ``frames``; otherwise the projected ``patch_embeds``, if given,
    before the token embeddings, the positions over the whole sequence."""
    # a batch without ``frames`` raises KeyError here, as the reference's
    # forward does (its launcher feeds tokens only)
    enc_out = _encode(cfg, params, batch["frames"]) if cfg.is_encoder_decoder else None
    with _gathered(params, params.embedding):
        h = L.embed_fwd(params.embedding, batch["tokens"], _dtype(cfg))
    if enc_out is None and "patch_embeds" in batch:
        h = torch.cat([_project(cfg, params, batch["patch_embeds"]), h], dim=1)
    B, S = h.shape[:2]
    pos = torch.arange(S, device=h.device).expand(B, S)
    h, aux = _trunk(cfg, params, h, pos, flash=flash, enc_out=enc_out)
    with _gathered(params, params.final_norm):
        return L.norm_fwd(params.final_norm, h), aux


def forward(cfg: ArchConfig, params: DecoderLM, batch: Dict[str, torch.Tensor],
            flash: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: ``batch`` holds ``tokens`` and, for an
    encoder-decoder, ``frames`` (B, S_enc, d), for a VLM optionally
    ``patch_embeds`` (B, n_modal, ``MODAL_EMBED_DIM``), whose positions
    lead the logits.  Returns (logits, aux_loss): the MoE blocks'
    load-balance loss (0 for a dense model).  ``flash`` is the port of the
    reference's ``REPRO_FLASH_KERNEL`` (see ``layers.attention_fwd``).  On
    the model axis the logits are the rank's vocabulary block
    (``layers.vocab_range``; ``train.serve.build_prefill`` gathers them)."""
    h, aux = _hidden(cfg, params, batch, flash)
    with _gathered(params, params.embedding):
        return L.unembed_fwd(params.embedding, h), aux


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def _nll(p: L.Embedding, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``logsumexp(logits) - logits[label]`` per position from float32
    logits.  On the model axis ``logits`` is the rank's vocabulary block:
    the max, the sum of exponentials and the target's logit (from the rank
    that holds it) meet across the model group."""
    tp = getattr(p, "tp", None)
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        return logz - logits.gather(-1, labels[..., None].long())[..., 0]
    start, end = L.vocab_range(p)
    m = L.all_max_model(logits.amax(dim=-1), tp.group)
    sumexp = L.reduce_from_model(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    ids = labels.long() - start
    inside = (ids >= 0) & (ids < end - start)
    gold = logits.gather(-1, ids.clamp(0, end - start - 1)[..., None])[..., 0]
    gold = L.reduce_from_model(torch.where(inside, gold, 0.0), tp)
    return m + torch.log(sumexp) - gold


def _chunked_ce(cfg: ArchConfig, params: DecoderLM, h: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Cross-entropy without the whole (B, S, V) logits: the reference's
    ``lax.map`` over sequence chunks of ``cfg.loss_chunk`` positions as a
    loop.  As the reference, only the first ``(S // C) * C`` positions
    count: with fewer than C positions the loss is 0 (and so is its
    gradient).  On the model axis each chunk's logits are the rank's
    vocabulary block (``_nll``)."""
    C = cfg.loss_chunk
    nC = h.shape[1] // C
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    with _gathered(params, params.embedding):
        for c in range(nC):
            sl = slice(c * C, (c + 1) * C)
            logits = L.unembed_fwd(params.embedding, h[:, sl]).to(torch.float32)
            total = total + (_nll(params.embedding, logits, labels[:, sl]) * mask[:, sl]).sum()
            count = count + mask[:, sl].sum()
    return total / torch.clamp(count, min=1.0)


def loss_fn(cfg: ArchConfig, params: DecoderLM, batch: Dict[str, torch.Tensor],
            flash: bool = False) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy in float32 (log-sum-exp of float32 logits),
    chunked over the sequence when ``cfg.loss_chunk`` is set (never for an
    encoder-decoder: its full logits are made), plus the MoE aux loss.  A
    VLM's loss counts text positions only, by the reference's two
    conventions, one position apart: chunked, the labels are the tokens
    after ``n_modal`` zeros, masked below position ``n_modal - 1`` (the
    last patch predicts the first token); unchunked, the text logits
    predict the next token.  ``flash``
    defaults off, as the reference's ``REPRO_FLASH_KERNEL``; kernel 8 has
    no backward in either package, so asking for it with gradients on
    raises.  Returns (loss, {"ce", "aux"})."""
    if flash and torch.is_grad_enabled():
        raise NotImplementedError(
            "flash=True under autograd: kernel 8 (flash attention) has no backward yet "
            "(ROADMAP queue 1, item 12); training runs flash=False, the reference's default")
    tokens = batch["tokens"]
    n_modal = batch["patch_embeds"].shape[1] if "patch_embeds" in batch else 0
    if cfg.loss_chunk and not cfg.is_encoder_decoder:
        h, aux = _hidden(cfg, params, batch, flash)
        labels = (torch.cat([tokens.new_zeros((tokens.shape[0], n_modal)), tokens], dim=1)
                  if n_modal else tokens)
        lab = labels[:, 1:]
        mask = torch.ones(lab.shape, dtype=torch.float32, device=tokens.device)
        if n_modal:
            mask = mask * (torch.arange(lab.shape[1], device=tokens.device)
                           >= n_modal - 1)[None, :]
        ce = _chunked_ce(cfg, params, h[:, :-1], lab, mask)
        return ce + aux, {"ce": ce, "aux": aux}
    logits, aux = forward(cfg, params, batch, flash=flash)
    ce = _nll(params.embedding, logits[:, n_modal:-1].to(torch.float32),
              tokens[:, 1:]).mean()
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def local_rows(batch: int, mesh) -> Tuple[int, int]:
    """(first row, rows) of a global batch that this rank serves: on a grid
    its data rank's B/K rows (``sharding.batch_specs`` / ``cache_specs``),
    every row where K does not divide B (the spec pruned), as without a
    grid."""
    dax = None if mesh is None else mesh.data_axis()
    if dax is None or batch % dax.size:
        return 0, batch
    n = batch // dax.size
    return dax.rank * n, n


def _cache_capacity(cfg: ArchConfig, total_len: int) -> int:
    if cfg.sliding_window:
        return min(cfg.sliding_window, total_len)
    return total_len


def init_cache(cfg: ArchConfig, batch: int, total_len: int, dtype=None,
               device=None, enc_len: int = 0, mesh=None) -> Params:
    """Decode cache for a context of ``total_len`` positions: ``idx`` (the
    next position, a host int), for an MoE model ``prefix`` (a list of one
    cache per prefix block), and the scanned layers' ``k``/``v`` stacked as
    ``(L, B, Hkv, capacity, hd)`` (MLA: ``ckv`` (L, B, capacity, r) and
    ``krope`` (L, B, capacity, rd)), on ``device`` (None: the card).  SSM:
    the layers' ``conv`` (L, B, kw - 1, di) and f32 ``h``; hybrid: the
    shared block's ``attn`` ``k``/``v`` for each of the G groups, (G, B,
    Hkv, capacity, hd), and ``mamba`` (G, every, ...) (``ssm.state_shapes``);
    encoder-decoder: ``enc_out``, zeros (B, ``enc_len``, d) for the caller to
    fill with ``_encode``'s output, and the decoder layers' ``k``/``v``.
    On a mesh with ``model`` = M > 1 the KV heads are a model rank's, as
    ``distributed.sharding.cache_specs`` places them: Hkv/M, or all of
    them when M does not divide Hkv; an SSM state's di/M channels (Hm/M
    heads); MLA's latent cache whole (replicated); on a grid ``batch`` is the global
    batch and the cache holds this rank's rows of it (``local_rows``)."""
    M = model_size(mesh)
    L.check_family(cfg)
    batch = local_rows(batch, mesh)[1]
    dev = resolve_device(device)
    dt = dtype or _dtype(cfg)
    cap = _cache_capacity(cfg, total_len)
    n_prefix = _n_prefix(cfg)
    n_kv = cfg.n_kv_heads // M if (cfg.n_kv_heads > 1 and cfg.n_kv_heads % M == 0) \
        else cfg.n_kv_heads
    cache: Params = {"idx": 0}
    if cfg.family == "ssm":
        cache["layers"] = SSM.init_ssm_state(cfg, batch, dt, dev, lead=(cfg.n_layers,), M=M)
        return cache
    if cfg.family == "hybrid":
        every = cfg.shared_attn_every
        G = cfg.n_layers // every
        cache["layers"] = {"attn": L.init_kv_cache(cfg, batch, cap, dt, dev, lead=(G,),
                                                   n_kv=n_kv),
                           "mamba": SSM.init_ssm_state(cfg, batch, dt, dev, lead=(G, every),
                                                       M=M)}
        return cache
    if cfg.is_encoder_decoder:
        cache["enc_out"] = torch.zeros((batch, enc_len, cfg.d_model), dtype=dt, device=dev)
    if n_prefix:
        cache["prefix"] = [L.init_kv_cache(cfg, batch, cap, dt, dev, n_kv=n_kv)
                           for _ in range(n_prefix)]
    cache["layers"] = L.init_kv_cache(cfg, batch, cap, dt, dev,
                                      lead=(cfg.n_layers - n_prefix,), n_kv=n_kv)
    return cache


def decode_step(cfg: ArchConfig, params: DecoderLM, cache: Params, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Params]:
    """One-token decode: tokens (B, 1) -> (logits (B, 1, V), cache).  The
    token's K/V go into slot ``idx % capacity`` of the cache's tensors (an
    SSM layer's ``conv`` and ``h`` are replaced), in place; the returned
    cache holds the same tensors and ``idx + 1``.  As the reference's, a
    call may take S > 1 tokens (B, S): the SSM state folds them all in, and
    attention writes S slots from ``idx`` under the causal mask; every
    token's position is then ``idx`` and ``idx`` advances by one, so only
    an attention-free (SSM) model takes a prompt in one call as a prefill
    does.  An encoder-decoder's blocks cross-attend to ``cache["enc_out"]``
    (carried as it is); a VLM's step embeds tokens only."""
    dt = _dtype(cfg)
    idx = int(cache["idx"])
    B = tokens.shape[0]
    pos = torch.full((B, 1), idx, dtype=torch.int64, device=tokens.device)
    with _gathered(params, params.embedding):
        h = L.embed_fwd(params.embedding, tokens, dt)
    enc_out = cache["enc_out"].to(dt) if cfg.is_encoder_decoder else None
    h, _ = _trunk(cfg, params, h, pos, caches=cache, cache_index=idx, enc_out=enc_out)
    with _gathered(params, params.final_norm):
        h = L.norm_fwd(params.final_norm, h)
    with _gathered(params, params.embedding):
        logits = L.unembed_fwd(params.embedding, h)
    return logits, dict(cache, idx=idx + 1)


# ---------------------------------------------------------------------------
# weights carried across from the reference
# ---------------------------------------------------------------------------

def _flatten(node, prefix: str = "") -> Dict[str, np.ndarray]:
    """Dicts and lists (``prefix_layers``) of numpy leaves by dotted path."""
    out: Dict[str, np.ndarray] = {}
    items = node.items() if isinstance(node, dict) else enumerate(node)
    for key, val in items:
        if isinstance(val, (dict, list, tuple)):
            out.update(_flatten(val, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(val)
    return out


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a tensor of its own type; a bf16 leaf (``ml_dtypes``)
    goes across by its bits."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(tree: Params, cfg: ArchConfig, device=None, mesh=None,
                    rank: Optional[int] = None, fsdp: Optional[bool] = True) -> DecoderLM:
    """The reference's ``init_params`` pytree (numpy leaves, the scanned
    layers stacked on a leading axis, an MoE model's ``prefix_layers`` a
    list) as a ``DecoderLM`` on ``device`` (None: the card): each stacked
    leaf ``layers/<path>`` becomes ``layers.<i>.<path>`` (an encoder-decoder's
    ``enc_layers/<path>`` ``enc_layers.<i>.<path>``), each
    ``prefix_layers[i]/<path>`` ``prefix_layers.<i>.<path>``, a hybrid's
    ``shared_attn/<path>`` ``shared_attn.<path>`` (its ``layers`` stay
    stacked over all ``n_layers``: group g is layers g * every ..).  Every leaf
    keeps its type (bf16 stays bf16), and every leaf of either side must
    find its counterpart.  On a mesh with ``model`` > 1 model rank ``rank``
    keeps its blocks (``cut_model_``), and on a grid its data rank its FSDP
    blocks (``shard_data_``, as ``init_params``)."""
    dev = resolve_device(device)
    L.check_family(cfg)
    stacks = {"layers": cfg.n_layers - _n_prefix(cfg)}
    if cfg.is_encoder_decoder:
        stacks["enc_layers"] = cfg.n_enc_layers
    state = _flatten({k: v for k, v in tree.items() if k not in stacks})
    for name, n_stacked in stacks.items():
        for path, arr in _flatten(tree[name]).items():
            if arr.shape[0] != n_stacked:
                raise ValueError(f"{name}/{path} has {arr.shape[0]} layers, expected "
                                 f"{n_stacked}")
            for i in range(n_stacked):
                state[f"{name}.{i}.{path}"] = arr[i]
    model = DecoderLM(cfg, torch.Generator(device="cpu").manual_seed(0), "cpu")
    want = model.state_dict()
    for k, v in state.items():
        if k in want and v.dtype.name != str(want[k].dtype).removeprefix("torch."):
            raise ValueError(f"{k}: a {v.dtype.name} leaf for a {want[k].dtype} parameter")
    model.load_state_dict({k: _tensor(v) for k, v in state.items()}, strict=True)
    with torch.no_grad():
        return shard_data_(cfg, cut_model_(cfg, model.to(dev), mesh, rank), mesh, blocks=fsdp)
