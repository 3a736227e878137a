"""Operations and bytes of a step, counted from shapes, and the card's peaks.

The SNN's counts come first; the LM section (:func:`lm_step_flops`) counts
a decoder's training step.

Frozen here so that no change to the program can change the yardstick.
The peaks and ``WINDOW_OPS`` are copied from ``chip_smoke.py``;
:func:`delta_bound` is its ``_conv_bound``, which also serves an fc layer
(one position per sample).  ``chip_smoke.py``'s ``_bound`` and
``_counter_bound`` count a per-lane read and write of ``w``, the engine's
kernel; the training delta's output is one batch-summed ``(K, C)`` array,
which :func:`delta_bound` counts.
"""
from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989.4e12      # H100 SXM bfloat16 on the tensor cores, dense
# float32 operations of one window evaluation (the exp counted as one)
WINDOW_OPS = {"exact": 4, "linear": 6, "imstdp": 1}
HISTORY_RULES = ("itp", "itp_nocomp")


def delta_bound(m: int, k: int, c: int, depth: int, packed: bool,
                window: str | None = None) -> tuple[float, str]:
    """Least time in ms for one batch-summed delta over ``m`` patch rows:
    the inputs read once (float32 spikes, one history or counter byte per
    element or 4·depth bytes of bitplanes, the (2, depth) po2 vectors or
    window table) and the (K, C) float32 delta written once, over the HBM
    rate, against the two contractions' multiply and add per term (plus a
    counter ``window``'s evaluation per element) over the float32 peak."""
    hist = (m * k + m * c) * (1 if packed else 4 * depth)
    nbytes = 4 * (m * k + m * c) + hist + 2 * 4 * depth + 4 * k * c
    ops = 4 * m * k * c + (WINDOW_OPS[window] * m * (k + c) if window else 0)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def layer_dims(cfg: dict, batch: int) -> list[tuple[int, int, int]]:
    """``(M, K, C)`` of each learnable layer: M = batch × output positions,
    K the fan-in, C the output channels."""
    dims = []
    shape = tuple(cfg["input_shape"])
    for spec in cfg["layers"]:
        kind = spec["kind"]
        if kind == "fc":
            dims.append((batch, math.prod(shape), spec["out_features"]))
            shape = (spec["out_features"],)
        elif kind == "conv2d":
            h, w, c_in = shape
            k, s = spec["kernel"], spec["stride"]
            shape = ((h - k) // s + 1, (w - k) // s + 1, spec["out_features"])
            dims.append((batch * shape[0] * shape[1], k * k * c_in, spec["out_features"]))
        elif kind == "pool2d":
            h, w, c_in = shape
            shape = (h // spec["pool"], w // spec["pool"], c_in)
        else:
            raise ValueError(f"no count for layer kind {kind!r}")
    return dims


def window_of(rule: str) -> str | None:
    return None if rule in HISTORY_RULES else rule


def product_ops(cfg: dict, batch: int) -> int:
    """float32 operations of one step's synaptic products: 2·M·K·C a layer."""
    return sum(2 * m * k * c for m, k, c in layer_dims(cfg, batch))


def update_ops(cfg: dict, batch: int, rule: str) -> int:
    """float32 operations of one step's gated Δw contractions: 4·M·K·C a
    layer, plus a counter rule's window evaluated once per element,
    ``WINDOW_OPS``·M·(K + C), as :func:`delta_bound` counts it (each pre and
    each post counter has one magnitude; a kernel that evaluates the window
    per pair does work the update does not need)."""
    window = window_of(rule)
    return sum(4 * m * k * c + (WINDOW_OPS[window] * m * (k + c) if window else 0)
               for m, k, c in layer_dims(cfg, batch))


def step_ops(cfg: dict, traffic: dict) -> int:
    """Counted float32 operations of one simulation step of the cell."""
    ops = product_ops(cfg, traffic["batch"])
    if traffic["mode"] == "train":
        ops += update_ops(cfg, traffic["batch"], traffic["rule"])
    return ops


def update_bound_s(cfg: dict, traffic: dict) -> float:
    """Least time in s of one step's update over every learnable layer."""
    window = window_of(traffic["rule"])
    packed = window is not None or cfg["packed_history"]
    return sum(delta_bound(m, k, c, cfg["depth"], packed, window)[0]
               for m, k, c in layer_dims(cfg, traffic["batch"])) / 1e3


# ---------------------------------------------------------------------------
# LM training step (configuration files in Hugging Face keys)
# ---------------------------------------------------------------------------

def lm_matrix_params(cfg: dict) -> int:
    """Weights that enter a matrix product for each token: every layer's
    q, k, v and o projections and its SwiGLU, and the unembedding once (the
    tied token table or the output matrix); the embedding lookup is none."""
    D, F = cfg["hidden_size"], cfg["intermediate_size"]
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    per_layer = D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * F
    return cfg["num_hidden_layers"] * per_layer + cfg["vocab_size"] * D


def lm_flops_per_token(cfg: dict, seq: int) -> int:
    """Model FLOPs of one token's forward and backward: 6 per matrix weight,
    plus causal attention's 6 · layers · seq · heads · head_dim (its two
    products, half of the seq × seq scores each, three passes); no recompute."""
    attention = 6 * cfg["num_hidden_layers"] * seq * cfg["num_attention_heads"] * cfg["head_dim"]
    return 6 * lm_matrix_params(cfg) + attention


def lm_step_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one training step of ``batch`` sequences of ``seq``."""
    return traffic["batch"] * traffic["seq"] * lm_flops_per_token(cfg, traffic["seq"])
