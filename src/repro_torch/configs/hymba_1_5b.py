"""hymba-1.5b — [hybrid] 32L d1600 25H (GQA kv=5) d_ff 5504 vocab 32001,
ssm_state=16; parallel attention + mamba heads per layer, sliding-window
attention except 3 global layers.  [arXiv:2411.13676; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    attn_window=1024,
    global_layers=(0, 15, 31),
    ssm_state=16,
    ssm_head_dim=64,
    ssm_expand=2,            # d_inner 3200 → 50 mamba heads
    rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="hymba-1.5b-smoke",
    family="hybrid",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    attn_window=16,
    global_layers=(0, 4),
    ssm_state=8,
    ssm_head_dim=16,         # d_inner 128 → 8 mamba heads
    ssm_expand=2,
    ssd_chunk=8,
)
