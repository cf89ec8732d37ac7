"""Architecture + run configuration schema (the port's own copy of
``repro.configs.base``, verbatim).

One frozen dataclass describes every assigned architecture family:
dense / MoE / MLA / SSM (Mamba-1/2) / hybrid / encoder-decoder / VLM /
audio.  Configs are hashable so they can be jit static arguments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity ------------------------------------------------------------
    name: str = "arch"
    family: str = "dense"          # dense | moe | ssm | hybrid | encdec | vlm | audio | cnn
    source: str = ""               # citation (paper / model card)

    # trunk ---------------------------------------------------------------
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab_size: int = 1024
    head_dim: Optional[int] = None
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    norm_eps: float = 1e-5
    tie_embeddings: bool = False

    # attention -----------------------------------------------------------
    qkv_bias: bool = False         # qwen1.5 style
    rope_theta: float = 10000.0
    pad_heads_to: int = 0          # pad the activation head axis to this
                                   # multiple-of-TP count (sharding layout
                                   # only — padded heads are zeros, dropped
                                   # before the output projection)
    sliding_window: Optional[int] = None   # ring-buffer KV window (long-context decode variant)

    # MLA (deepseek-v2) -----------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    qk_rope_dim: int = 64

    # MoE -------------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_dense_residual: bool = False      # arctic: dense FFN in parallel with MoE
    dense_residual_ff: int = 0            # width of that dense residual FFN
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    first_dense_layers: int = 1           # leading layers use dense FFN (deepseek/moonlight style)

    # SSM (mamba) -----------------------------------------------------------
    ssm_state: int = 0
    ssm_variant: str = ""                 # mamba1 | mamba2
    d_inner: int = 0                      # default 2*d_model
    ssm_conv: int = 4
    ssm_head_dim: int = 64                # mamba2 head size
    dt_rank: int = 0                      # mamba1 dt projection rank (default d_model/16)

    # hybrid (zamba2): shared attention block every k scanned layers --------
    shared_attn_every: int = 0

    # encoder-decoder (seamless) ---------------------------------------------
    is_encoder_decoder: bool = False
    n_enc_layers: int = 0

    # modality frontend stubs -------------------------------------------------
    modality: str = "text"                # text | vision | audio
    n_modal_tokens: int = 0               # precomputed patch/frame embeddings prepended

    # numerics / execution -----------------------------------------------------
    dtype: str = "bfloat16"               # activation/compute dtype
    param_dtype: str = "float32"
    remat: bool = True
    loss_chunk: int = 0                   # chunked cross-entropy (0 = off)
    optimizer: str = "adamw"              # sgd | adamw | adafactor

    # derived ----------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner_(self) -> int:
        return self.d_inner if self.d_inner else 2 * self.d_model

    @property
    def dt_rank_(self) -> int:
        return self.dt_rank if self.dt_rank else max(1, self.d_model // 16)

    @property
    def n_ssm_heads(self) -> int:
        return max(1, self.d_inner_ // self.ssm_head_dim)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic long decode: native for ssm/hybrid, via sliding
        window for attention archs."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS and memory checks)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        hd, H, Hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        total = V * d  # embedding
        if not self.tie_embeddings:
            total += V * d
        def attn_params() -> int:
            if self.use_mla:
                r = self.kv_lora_rank
                return (
                    d * H * hd                 # q
                    + d * r + d * self.qk_rope_dim   # kv down + rope key
                    + r * H * hd * 2           # k/v up
                    + H * hd * d               # out
                )
            return d * H * hd + 2 * d * Hkv * hd + H * hd * d + (
                (H * hd + 2 * Hkv * hd) if self.qkv_bias else 0
            )
        def dense_ffn(width: int) -> int:
            return 3 * d * width
        def moe_ffn() -> int:
            total = self.n_experts * 3 * d * ff + d * self.n_experts  # experts + router
            total += self.n_shared_experts * 3 * d * ff
            if self.moe_dense_residual:
                total += dense_ffn(self.dense_residual_ff or ff)
            return total
        def mamba_params() -> int:
            di, n = self.d_inner_, self.ssm_state
            if self.ssm_variant == "mamba2":
                Hm = self.n_ssm_heads
                return d * 2 * di + di * self.ssm_conv + di * d + Hm + Hm + (
                    di * 2 * n + di  # B,C proj + dt proj (head-wise)
                )
            dtr = self.dt_rank_
            return (
                d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * n) + dtr * di
                + di * n + di + di * d
            )
        per_layer = 2 * d  # norms
        if self.family == "ssm":
            per_layer += mamba_params()
            total += self.n_layers * per_layer
        elif self.family == "hybrid":
            total += self.n_layers * (mamba_params() + 2 * d)
            # shared attention block (params shared across invocations)
            total += 2 * d * d + attn_params() + dense_ffn(ff) + 4 * d
        else:
            layers = self.n_layers + (self.n_enc_layers if self.is_encoder_decoder else 0)
            moe_layers = 0
            if self.n_experts:
                moe_layers = max(0, self.n_layers - self.first_dense_layers)
            dense_layers = layers - moe_layers
            total += layers * (attn_params() + 2 * d)
            if self.is_encoder_decoder:
                total += self.n_layers * attn_params()  # cross attention
            total += moe_layers * moe_ffn() + dense_layers * dense_ffn(ff)
        return int(total)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: routed top-k + shared only)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        moe_layers = max(0, self.n_layers - self.first_dense_layers)
        inactive = moe_layers * (self.n_experts - self.top_k) * 3 * d * ff
        return int(self.param_count() - inactive)

    def reduced(self) -> "ArchConfig":
        """Smoke-test variant of the same family: <=2 layers, d_model<=512,
        <=4 experts — runnable in seconds on one CPU."""
        d = min(self.d_model, 256)
        H = min(self.n_heads, 4)
        kwargs = dict(
            name=self.name + "-smoke",
            n_layers=2,
            d_model=d,
            n_heads=H,
            n_kv_heads=min(self.n_kv_heads, H),
            d_ff=min(self.d_ff, 512),
            vocab_size=min(self.vocab_size, 512),
            head_dim=d // H,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            kv_lora_rank=min(self.kv_lora_rank, 32) if self.use_mla else 0,
            qk_rope_dim=min(self.qk_rope_dim, 16) if self.use_mla else 64,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.n_experts else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            dense_residual_ff=min(self.dense_residual_ff, 256) if self.dense_residual_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            d_inner=2 * d if self.family in ("ssm", "hybrid") else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.family in ("ssm", "hybrid") else 64,
            shared_attn_every=2 if self.shared_attn_every else 0,
            n_enc_layers=2 if self.is_encoder_decoder else 0,
            n_modal_tokens=min(self.n_modal_tokens, 16) if self.n_modal_tokens else 0,
            dtype="float32",
            param_dtype="float32",
            remat=False,
            loss_chunk=0,
            optimizer="sgd",
        )
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned workload shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"
