"""musicgen-medium — [audio] 48L d1536 24H (kv=24, MHA) d_ff 6144
vocab 2048; decoder-only over EnCodec tokens, sinusoidal positions,
LayerNorm + GELU MLP.  [arXiv:2306.05284; hf]

The EnCodec frontend is a stub per the brief: ``input_specs()`` provides
precomputed frame embeddings (B, S, d_model); training targets are the
next-step codebook tokens (vocab 2048).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    pos_embedding="sinusoidal",
    norm="layernorm",
    mlp="gelu",
)

SMOKE = ModelConfig(
    name="musicgen-medium-smoke",
    family="audio",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab_size=128,
    pos_embedding="sinusoidal",
    norm="layernorm",
    mlp="gelu",
)
