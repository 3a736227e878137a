"""qwen2-1.5b — [dense] 28L d1536 12H (GQA kv=2) d_ff 8960 vocab 151936,
GQA + QKV bias, tied embeddings.  [arXiv:2407.10671; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen2-1.5b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    d_ff=192,
    vocab_size=512,
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
)
