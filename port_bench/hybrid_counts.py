"""Operations and bytes of the hybrid family's training step (an
interleaved Mamba-2/attention stack), counted from the configuration file's
shapes (Hugging Face keys) whatever implements them, and frozen here so
that no change to the program can change the yardstick.  The peaks are
``counts.py``'s.

The SSD scan, per token and Mamba layer, with H heads of P, G groups of
d_state N and the chunk Q:

  * bytes: x (H·P) and y (H·P), B and C (G·N each) in the compute dtype,
    and Δ (H) in float32, each read or written once (the dual form's
    inputs and output);
  * operations of the chunked form at Q, its intra-chunk terms over the
    causal half: Q·G·N (C·Bᵀ) + Q·H·P (the weighted sum) + 4·H·N·P (the
    carried state's read and update).
"""
from __future__ import annotations

from port_bench.counts import BF16_OPS_PER_S, HBM_BYTES_PER_S

DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def _kinds(cfg: dict) -> tuple[int, int]:
    """(Mamba layers, attention layers)."""
    return cfg["layer_types"].count("mamba"), cfg["layer_types"].count("attention")


def scan_bytes_per_token(cfg: dict) -> int:
    H, P = cfg["mamba_n_heads"], cfg["mamba_d_head"]
    GN = cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    return DTYPE_BYTES[cfg["assumed"]["compute_dtype"]] * (2 * H * P + 2 * GN) + 4 * H


def scan_ops_per_token(cfg: dict) -> int:
    H, P, N = cfg["mamba_n_heads"], cfg["mamba_d_head"], cfg["mamba_d_state"]
    Q, G = cfg["mamba_chunk_size"], cfg["mamba_n_groups"]
    return Q * G * N + Q * H * P + 4 * H * N * P


def scan_bound_s(cfg: dict, traffic: dict) -> float:
    """Least time in s of one scan call over a batch (one layer): the larger
    of its bytes over 3.35 TB/s and its operations over the dense bf16
    tensor-core peak."""
    tokens = traffic["batch"] * traffic["seq"]
    return max(tokens * scan_bytes_per_token(cfg) / HBM_BYTES_PER_S,
               tokens * scan_ops_per_token(cfg) / BF16_OPS_PER_S)


def matrix_params(cfg: dict) -> int:
    """Weights that enter a matrix product for each token: each Mamba
    layer's z, xBC, dt and out projections, each attention layer's q, k, v
    and o, every layer's SwiGLU, and the tied unembedding once."""
    D, F = cfg["hidden_size"], cfg["shared_intermediate_size"]
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["assumed"]["head_dim"]
    di = cfg["mamba_expand"] * D
    conv = di + 2 * cfg["mamba_n_groups"] * cfg["mamba_d_state"]
    mamba = D * (di + conv + cfg["mamba_n_heads"]) + di * D
    attention = D * H * hd + 2 * D * K * hd + H * hd * D
    n_m, n_a = _kinds(cfg)
    return (n_m * mamba + n_a * attention + cfg["num_hidden_layers"] * 3 * D * F
            + cfg["vocab_size"] * D)


def flops_per_token(cfg: dict, seq: int) -> int:
    """Model FLOPs of one token's forward and backward: 6 per matrix weight,
    causal attention's 6 · seq · heads · head_dim per attention layer, and
    3× the scan's operations per Mamba layer; no recompute."""
    n_m, n_a = _kinds(cfg)
    attention = 6 * n_a * seq * cfg["num_attention_heads"] * cfg["assumed"]["head_dim"]
    return 6 * matrix_params(cfg) + attention + 3 * n_m * scan_ops_per_token(cfg)


def step_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one training step of ``batch`` sequences of ``seq``."""
    return traffic["batch"] * traffic["seq"] * flops_per_token(cfg, traffic["seq"])
