"""qwen1.5-32b — [dense] 64L d5120 40H (kv=40, i.e. MHA) d_ff 27392
vocab 152064, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=40,
    d_ff=27392,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)

SMOKE = ModelConfig(
    name="qwen1.5-32b-smoke",
    family="dense",
    n_layers=3,
    d_model=96,
    n_heads=4,
    n_kv_heads=4,
    d_ff=192,
    vocab_size=256,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
