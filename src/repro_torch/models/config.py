"""Model configuration shared by every assigned architecture (port of
``repro.models.config``; ROADMAP item 18a).

One dataclass covers the whole LM family (dense / MoE / SSM / hybrid /
VLM / audio); family-specific fields are zero/empty when unused.  Configs
are pure data: shapes and counts, no weights.  The dtype fields stay
strings, as in the reference; the model code (item 18b) maps them to torch
dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // n_heads

    # --- attention features -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_window: int = 0            # sliding-window size; 0 = full attention
    global_layers: Tuple[int, ...] = ()   # layers forced to full attention
    rope_theta: float = 10_000.0
    pos_embedding: str = "rope"     # rope | sinusoidal
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    mlp: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_experts_padded: int = 0       # pad expert tables for EP divisibility
                                    # (padding experts are never routed)
    moe_d_ff: int = 0               # per-expert FFN width
    shared_d_ff: int = 0            # shared-expert width (0 = none)
    norm_topk: bool = False
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.001
    router_z_weight: float = 0.0001

    # --- SSM (mamba2 / hybrid) ----------------------------------------------
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    d_conv: int = 4
    ssd_chunk: int = 256

    # --- VLM (cross-attention) ----------------------------------------------
    cross_attn_layers: Tuple[int, ...] = ()
    n_vis_tokens: int = 0
    vis_dim: int = 0

    # --- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"         # activation/compute dtype
    param_dtype: str = "float32"    # master parameter dtype

    # -------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def experts_alloc(self) -> int:
        """Allocated expert count (≥ n_experts; padded for EP)."""
        return max(self.n_experts, self.n_experts_padded)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic decode: SSM or sliding-window/hybrid archs."""
        return self.family == "ssm" or (self.family == "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS)."""
        d, v, L = self.d_model, self.vocab_size, self.n_layers
        hd = self.resolved_head_dim if self.n_heads else 0
        n = v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.has_attention:
            q = d * self.n_heads * hd
            kv = 2 * d * self.n_kv_heads * hd
            o = self.n_heads * hd * d
            per_layer += q + kv + o
        if self.family == "vlm":
            # cross-attn layers replace self-attn: q/o from d_model, k/v
            # from vis_dim; their FFN is already in per_layer below
            n_cross = len(self.cross_attn_layers)
            self_attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                         + self.n_heads * hd * d)
            cross = (d * self.n_heads * hd + 2 * self.vis_dim * self.n_kv_heads * hd
                     + self.n_heads * hd * d)
            n += n_cross * (cross - self_attn)
        if self.has_ssm:
            di, ns, g = self.d_inner, self.ssm_state, self.ssm_groups
            heads = self.ssm_heads
            in_proj = d * (2 * di + 2 * g * ns + heads)
            conv = (di + 2 * g * ns) * self.d_conv
            out = di * d
            per_layer += in_proj + conv + out + 3 * heads  # A, D, dt_bias
        if self.is_moe:
            per_layer += d * self.n_experts                       # router
            per_layer += self.n_experts * 3 * d * self.moe_d_ff   # experts
            if self.shared_d_ff:
                per_layer += 3 * d * self.shared_d_ff + d         # + gate
        elif self.d_ff:
            mult = 3 if self.mlp == "swiglu" else 2
            per_layer += mult * d * self.d_ff
        n += L * per_layer
        n += L * 2 * d + d  # norms (approx)
        return n

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k experts)."""
        if not self.is_moe:
            return self.param_count()
        full = self.param_count()
        inactive = (self.n_experts - self.n_experts_per_tok) * 3 * self.d_model \
            * self.moe_d_ff * self.n_layers
        return full - inactive
