"""granite-4.0-h-micro — [interleaved] 40L d2048, 36 Mamba-2 layers and 4
NoPE attention layers (5, 15, 25, 35; GQA 32 over 8, head 64), each layer
followed by a SwiGLU MLP 2048 → 8192, vocab 100352, tied embeddings; μP
multipliers: embeddings × 12, branches × 0.22, logits / 8, softmax scale
0.015625.  Mamba-2: 64 heads of 64, d_state 128, one group, conv 4 with
bias, chunk 256.  [https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json]
"""
from repro_torch.models.config import InterleavedConfig

_PERIOD = ("mamba",) * 5 + ("attention",) + ("mamba",) * 4

CONFIG = InterleavedConfig(
    name="granite-4.0-h-micro",
    family="interleaved",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv_heads=8,
    head_dim=64,             # 2048 / 32; the config does not state it
    d_ff=8192,               # shared_intermediate_size (no routed experts)
    vocab_size=100352,
    pos_embedding="none",    # position_embedding_type "nope"
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,            # d_inner 4096 → 64 mamba heads
    ssm_groups=1,
    d_conv=4,
    ssd_chunk=256,
    layer_types=_PERIOD * 4,
    embedding_multiplier=12.0,
    attention_multiplier=0.015625,
    residual_multiplier=0.22,
    logits_scaling=8.0,
)

SMOKE = InterleavedConfig(
    name="granite-4.0-h-micro-smoke",
    family="interleaved",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=256,
    pos_embedding="none",
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm_state=16,
    ssm_head_dim=16,         # d_inner 128 → 8 mamba heads
    ssm_expand=2,
    ssm_groups=1,
    d_conv=4,
    ssd_chunk=8,
    layer_types=("mamba", "mamba", "attention", "mamba"),
    embedding_multiplier=12.0,
    attention_multiplier=0.0625,
    residual_multiplier=0.22,
    logits_scaling=8.0,
)
