"""qwen3-0.6b — [dense] 28L d1024 16H (GQA kv=8) d_ff 3072 vocab 151936,
qk_norm + decoupled head_dim 128, tied embeddings.  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen3-0.6b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
