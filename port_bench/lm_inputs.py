"""The LM family's inputs, made on the device from ``--seed``: the parameter
tree of a dense decoder and a pool of token batches.

The tree is laid out as the port's ``models/transformer.py`` keeps it and as
the plain reference (``reference/lm.py``) reads it: every block leaf stacked
over the layers, each matrix ``(fan_in, fan_out)``.  The draws follow the
port's initialisation law (``models/layers.py``: matrices truncated normal in
[-2, 2] times 1/sqrt(fan_in), the token table normal times 0.02, norm scales
1), made here in two large calls on a ``torch.Generator`` on the device, so
that both the program and the reference are handed the same float32 master
weights and no change to the program changes them.  The tokens are a frozen
copy of ``repro_torch/data/synthetic.py:zipf_tokens``'s law: id ``r`` with
probability proportional to ``(r + 1)^-alpha`` over the whole vocabulary, by
inverse CDF, the CDF summed on the host in float64.
"""
from __future__ import annotations

import math

import torch

from port_bench.inputs import generator
from port_bench.reference.lm import unflatten

WEIGHT_STREAM = 3
TOKEN_STREAM = 4


def leaf_shapes(cfg: dict) -> dict:
    """The parameter tree's shapes for a configuration file (Hugging Face
    keys); raises on a feature the reference does not compute."""
    if (cfg["attention_bias"] or cfg["hidden_act"] != "silu"
            or not cfg["tie_word_embeddings"]):
        raise ValueError("the LM reference computes a bias-free SwiGLU decoder with a "
                         "tied token table")
    L, D, F = cfg["num_hidden_layers"], cfg["hidden_size"], cfg["intermediate_size"]
    H, K, hd, V = (cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"],
                   cfg["vocab_size"])
    return {"embed": {"tok": (V, D)},
            "final_norm": {"scale": (D,)},
            "blocks": {"norm1": {"scale": (L, D)},
                       "attn": {"wq": (L, D, H * hd), "wk": (L, D, K * hd),
                                "wv": (L, D, K * hd), "wo": (L, H * hd, D),
                                "q_norm": (L, hd), "k_norm": (L, hd)},
                       "norm2": {"scale": (L, D)},
                       "mlp": {"gate": (L, D, F), "up": (L, D, F), "down": (L, F, D)}}}


def paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``[(dotted path, leaf)]`` in sorted key order (the order in which
    JAX, the port and the reference's optimizer walk a tree)."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in paths(tree[k], f"{prefix}{k}.")]
    return [(prefix[:-1], tree)]


def _is_matrix(path: str) -> bool:
    return path.split(".")[-1] in ("wq", "wk", "wv", "wo", "gate", "up", "down")


def initial_params(cfg: dict, seed: int, device: torch.device) -> dict:
    """The float32 master weights from ``seed``: every matrix from one
    truncated-normal draw, the token table from one normal draw."""
    gen = generator(seed, WEIGHT_STREAM, device)
    shapes = paths(leaf_shapes(cfg))
    matrices = [(p, s) for p, s in shapes if _is_matrix(p)]
    flat = torch.empty(sum(math.prod(s) for _, s in matrices), device=device)
    torch.nn.init.trunc_normal_(flat, a=-2.0, b=2.0, generator=gen)
    drawn = dict(zip([p for p, _ in matrices],
                     flat.split([math.prod(s) for _, s in matrices])))
    tok_shape = dict(shapes)["embed.tok"]
    tok = torch.empty(tok_shape, device=device).normal_(generator=gen).mul_(0.02)
    leaves = []
    for path, shape in shapes:
        if path == "embed.tok":
            leaves.append(tok)
        elif path in drawn:
            leaves.append(drawn[path].view(shape).mul_(1.0 / math.sqrt(shape[-2])))
        else:
            leaves.append(torch.ones(shape, device=device))
    return unflatten(leaf_shapes(cfg), leaves)


def zipf_alpha(traffic: dict) -> float:
    law, alpha = traffic["tokens"].split("-", 1)
    if law != "zipf":
        raise ValueError(f"no token law {law!r}")
    return float(alpha)


def token_pool(cfg: dict, traffic: dict, n: int, seed: int,
               device: torch.device) -> list[dict]:
    """``n`` batches ``{"tokens", "labels"}``, each ``(batch, seq)`` int32 on
    ``device``: Zipf ids, the labels the tokens shifted left with the last
    position ignored (-1), as the port's ``lm_batches`` makes them."""
    V = cfg["vocab_size"]
    B, S = traffic["batch"], traffic["seq"]
    ranks = torch.arange(1, V + 1, dtype=torch.float64)
    cdf = torch.cumsum(torch.exp(-zipf_alpha(traffic) * torch.log(ranks)), 0)
    cdf = (cdf / cdf[-1]).to(device)
    gen = generator(seed, TOKEN_STREAM, device)
    u = torch.rand(n * B * S, generator=gen, dtype=torch.float64, device=device)
    ids = torch.searchsorted(cdf, u, right=True).clamp_(max=V - 1)
    tokens = ids.reshape(n, B, S).to(torch.int32)
    labels = torch.cat([tokens[:, :, 1:], tokens.new_full((n, B, 1), -1)], dim=2)
    return [{"tokens": t.contiguous(), "labels": lab.contiguous()}
            for t, lab in zip(tokens, labels)]
