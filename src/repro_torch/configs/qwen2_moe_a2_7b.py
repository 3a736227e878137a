"""qwen2-moe-a2.7b — [moe] 24L d2048 16H (kv=16) expert d_ff 1408
vocab 151936, 60 routed experts top-4 + 4 shared (5632 fused width).
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    qkv_bias=True,
    n_experts=60,
    n_experts_per_tok=4,
    n_experts_padded=64,     # EP divisibility on model=16 (padding never routed)
    moe_d_ff=1408,
    shared_d_ff=5632,        # 4 shared experts fused
    norm_topk=False,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=48,
    vocab_size=256,
    qkv_bias=True,
    n_experts=8,
    n_experts_per_tok=2,
    moe_d_ff=48,
    shared_d_ff=96,
    norm_topk=False,
)
