"""mamba2-1.3b — [ssm] 48L d2048 attn-free, vocab 50280, ssm_state=128,
SSD (state-space duality), tied embeddings.  [arXiv:2405.21060; unverified]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,            # d_inner 4096 → 64 heads
    ssm_groups=1,
    d_conv=4,
    ssd_chunk=256,
)

SMOKE = ModelConfig(
    name="mamba2-1.3b-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=256,
    tie_embeddings=True,
    ssm_state=16,
    ssm_head_dim=16,         # d_inner 128 → 8 heads
    ssm_expand=2,
    d_conv=4,
    ssd_chunk=8,
)
