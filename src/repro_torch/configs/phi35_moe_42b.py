"""phi3.5-moe-42b-a6.6b — [moe] 32L d4096 32H (GQA kv=8) expert d_ff 6400
vocab 32064, 16 experts top-2 (Mixtral-style, LayerNorm, attn bias).
[hf:microsoft/Phi-3.5-MoE-instruct; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab_size=32064,
    qkv_bias=True,
    norm="layernorm",
    n_experts=16,
    n_experts_per_tok=2,
    moe_d_ff=6400,
    norm_topk=True,
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="phi3.5-moe-42b-a6.6b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=96,
    vocab_size=256,
    qkv_bias=True,
    norm="layernorm",
    n_experts=4,
    n_experts_per_tok=2,
    moe_d_ff=96,
    norm_topk=True,
)
