"""llama-3.2-vision-11b — [vlm] 40L d4096 32H (GQA kv=8) d_ff 14336
vocab 128256, cross-attn image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]

The vision frontend is a stub per the brief: ``input_specs()`` supplies
precomputed patch embeddings (B, 1601, 7680); the backbone projects them to
K/V inside each gated cross-attention layer (q/k-norm + tanh gate, as in
the HF reference).  Structurally we group layers into 8 periods of
(4 self + 1 cross), matching HF's cross layers {3,8,…,38} in count and
spacing.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    rope_theta=500_000.0,
    cross_attn_layers=(3, 8, 13, 18, 23, 28, 33, 38),
    n_vis_tokens=1601,
    vis_dim=7680,
)

SMOKE = ModelConfig(
    name="llama-3.2-vision-11b-smoke",
    family="vlm",
    n_layers=10,             # 2 periods of (4 self + 1 cross)
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=256,
    rope_theta=500_000.0,
    cross_attn_layers=(3, 8),
    n_vis_tokens=17,
    vis_dim=48,
)
