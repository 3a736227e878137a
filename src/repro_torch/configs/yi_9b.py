"""yi-9b — [dense] 48L d4096 32H (GQA kv=4) d_ff 11008 vocab 64000,
llama-arch GQA.  [arXiv:2403.04652; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    rope_theta=5_000_000.0,
)

SMOKE = ModelConfig(
    name="yi-9b-smoke",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=2,
    d_ff=160,
    vocab_size=512,
    rope_theta=5_000_000.0,
)
