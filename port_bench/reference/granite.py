"""Plain float32 reference of a Granite-4.0-H training step: a stack of
Mamba-2 and NoPE attention layers in the order ``layer_types`` gives, each
followed by a SwiGLU MLP, with μP multipliers
(https://huggingface.co/ibm-granite/granite-4.0-h-micro, Hugging Face's
``GraniteMoeHybrid`` with no routed experts).  Plain ``torch`` only, no
kernel, no cache, no batching; it imports nothing of the program, and from
``reference/lm.py`` only its generic helpers (tree walks, RMSNorm, the
float32 and float8 products).

On a residual stream ``x`` of width ``hidden_size``, from
``x = embedding_multiplier · tok[ids]``, each layer is

    h = RMSNorm(x)                       x · rsqrt(mean(x²) + eps) · scale
    x = x + residual_multiplier · mixer(h)
    h = RMSNorm(x)
    x = x + residual_multiplier · (silu(h Wgate) · h Wup) Wdown

then the final RMSNorm and the logits ``(x tokᵀ) / logits_scaling`` against
the tied token table.  The mixers:

  * attention: q, k, v = h Wq, h Wk, h Wv in heads of ``hidden_size /
    num_attention_heads``, no bias, no positional encoding at all
    (``position_embedding_type`` "nope"); ``softmax(q kᵀ ·
    attention_multiplier + causal) v``, q head j reading kv head
    j // (H/K); then ``o Wo``;
  * Mamba-2, from the published equations: z = h Wz, xBC = h Wxbc, dt = h
    Wdt (the three column blocks of ``in_proj``, no bias); xBC through the
    causal depthwise conv of width ``mamba_d_conv`` with its bias, then
    silu, split into x (heads × head dim), B and C (groups × d_state);
    Δ = softplus(dt + dt_bias), A = −exp(A_log); the selective recurrence

        h_t = exp(Δ_t A) h_{t−1} + Δ_t B_t x_tᵀ,   y_t = C_t h_t + D x_t

    computed as its full-sequence masked quadratic form,
    ``y_t = Σ_{s≤t} (C_t·B_s) exp(Σ_{k=s+1..t} Δ_k A) Δ_s x_s + D x_t``,
    the decays' running sums in float64, a block of heads at a time (each
    block recomputed in the backward, so that a 4,096-token sequence fits);
    then RMSNorm(y · silu(z)) over all of d_inner (one group) times its
    scale, then ``out_proj``.

The loss, its z-loss and the gradients are :mod:`reference.lm`'s: the mean
over the labelled positions of log-sum-exp less the gold logit, plus
``z_loss`` times the mean squared log-sum-exp, autograd one sequence at a
time.  Every matrix product runs in float32 with TF32 off; ``low=True`` is
the control, each product's operands (the scan's ``C Bᵀ`` and its weighted
sum too) rounded to float8 as in :mod:`reference.lm`.

Departures from Hugging Face, none of which changes the mathematics:

  * no ``time_step_limit`` clamp of Δ: the config's (0, ∞) is none;
  * ``in_proj`` as three matrices (z, xBC, dt) and every matrix stored
    (fan_in, fan_out); the conv's weight (d_conv, channels), tap ``i``
    multiplying position ``t − (d_conv − 1) + i``;
  * the head size is ``hidden_size / num_attention_heads`` (64), as Hugging
    Face derives it; the config does not state it;
  * float32 throughout, where the published model computes in bfloat16;
  * the parameter tree is the program's: ``mamba_blocks`` and
    ``attn_blocks``, each leaf stacked over the layers of its kind, walked
    in ``layer_types`` order.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from port_bench.reference.lm import _mm, _rms, float32_products, leaves, unflatten

HEAD_BLOCK = 8       # Mamba heads whose (S, S) decay matrices exist at once


def dims(cfg: dict) -> dict:
    """The sizes the reference reads from a configuration file (Hugging
    Face keys); raises on a feature it does not compute."""
    if (cfg["attention_bias"] or cfg["mamba_proj_bias"] or not cfg["mamba_conv_bias"]
            or cfg["hidden_act"] != "silu" or not cfg["tie_word_embeddings"]
            or cfg["position_embedding_type"] != "nope" or cfg["num_local_experts"]):
        raise ValueError("the Granite reference computes a dense, bias-free, NoPE stack with "
                         "a conv bias and a tied token table")
    D, H = cfg["hidden_size"], cfg["num_attention_heads"]
    di = cfg["mamba_expand"] * D
    if di != cfg["mamba_n_heads"] * cfg["mamba_d_head"]:
        raise ValueError(f"mamba_expand · hidden_size = {di} is not mamba_n_heads · "
                         f"mamba_d_head")
    if len(cfg["layer_types"]) != cfg["num_hidden_layers"]:
        raise ValueError("layer_types must name every layer")
    return {"D": D, "F": cfg["shared_intermediate_size"],
            "H": H, "K": cfg["num_key_value_heads"], "hd": D // H, "V": cfg["vocab_size"],
            "di": di, "mh": cfg["mamba_n_heads"], "P": cfg["mamba_d_head"],
            "N": cfg["mamba_d_state"], "G": cfg["mamba_n_groups"], "W": cfg["mamba_d_conv"],
            "eps": cfg["rms_norm_eps"], "kinds": tuple(cfg["layer_types"])}


def leaf_shapes(cfg: dict) -> dict:
    """The parameter tree's shapes: the program's layout."""
    d = dims(cfg)
    D, F_, hd, di, mh, G, N = d["D"], d["F"], d["hd"], d["di"], d["mh"], d["G"], d["N"]
    n_m, n_a = d["kinds"].count("mamba"), d["kinds"].count("attention")
    conv = di + 2 * G * N

    def block(n: int, mixer: dict) -> dict:
        return {"norm1": {"scale": (n, D)}, "norm2": {"scale": (n, D)},
                "mlp": {"gate": (n, D, F_), "up": (n, D, F_), "down": (n, F_, D)},
                **{k: {name: (n, *s) for name, s in v.items()} for k, v in mixer.items()}}

    ssm = {"wz": (D, di), "wxbc": (D, conv), "wdt": (D, mh), "conv_w": (d["W"], conv),
           "conv_b": (conv,), "a_log": (mh,), "d_skip": (mh,), "dt_bias": (mh,),
           "norm_scale": (di,), "out_proj": (di, D)}
    attn = {"wq": (D, d["H"] * hd), "wk": (D, d["K"] * hd), "wv": (D, d["K"] * hd),
            "wo": (d["H"] * hd, D)}
    return {"embed": {"tok": (d["V"], D)}, "final_norm": {"scale": (D,)},
            "mamba_blocks": block(n_m, {"ssm": ssm}), "attn_blocks": block(n_a, {"attn": attn})}


# ---------------------------------------------------------------------------
# The mixers
# ---------------------------------------------------------------------------

def _attention(d: dict, w: dict, h: torch.Tensor, mult: float, low: bool) -> torch.Tensor:
    S, H, K, hd = h.shape[0], d["H"], d["K"], d["hd"]
    q = _mm(h, w["wq"], low).view(S, H, hd).transpose(0, 1)              # (H, S, hd)
    k = _mm(h, w["wk"], low).view(S, K, hd).repeat_interleave(H // K, dim=1).transpose(0, 1)
    v = _mm(h, w["wv"], low).view(S, K, hd).repeat_interleave(H // K, dim=1).transpose(0, 1)
    scores = _mm(q, k.transpose(1, 2), low) * mult
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm(p, v, low).transpose(0, 1).reshape(S, H * hd)
    return _mm(o, w["wo"], low)


def _quadratic_heads(cum: torch.Tensor, cb: torch.Tensor, group: torch.Tensor,
                     xdt: torch.Tensor, low: bool) -> torch.Tensor:
    """One block of heads of the masked quadratic form: ``cum`` (h, S) the
    float64 running sums of Δ·A, ``cb`` (G, S, S) each group's ``C_t ·
    B_s``, ``group`` (h,) each head's group, ``xdt`` (h, S, P) the inputs
    times Δ; → (h, S, P)."""
    S = cum.shape[1]
    causal = torch.ones(S, S, dtype=torch.bool, device=cum.device).tril()
    seg = cum[:, :, None] - cum[:, None, :]                 # Σ_{k=s+1..t} Δ_k A
    decay = torch.exp(torch.where(causal, seg, -torch.inf)).to(torch.float32)
    return _mm(cb[group] * decay, xdt, low)


def _mamba(d: dict, w: dict, h: torch.Tensor, low: bool) -> torch.Tensor:
    S, di, mh, P, G, N = h.shape[0], d["di"], d["mh"], d["P"], d["G"], d["N"]
    z = _mm(h, w["wz"], low)
    xbc = _mm(h, w["wxbc"], low)
    dt = _mm(h, w["wdt"], low)
    conv_dim = xbc.shape[1]
    # causal depthwise conv: channel c, tap i on position t − (W − 1) + i
    xbc = F.conv1d(xbc.T[None], w["conv_w"].T[:, None, :], w["conv_b"],
                   padding=d["W"] - 1, groups=conv_dim)[0, :, :S].T
    xbc = F.silu(xbc)
    x = xbc[:, :di].reshape(S, mh, P)
    b_in = xbc[:, di:di + G * N].reshape(S, G, N)
    c_in = xbc[:, di + G * N:].reshape(S, G, N)
    delta = F.softplus(dt + w["dt_bias"])                    # (S, heads)
    a = -torch.exp(w["a_log"])
    cum = torch.cumsum(delta.double() * a.double(), dim=0).T   # (heads, S) float64
    cb = _mm(c_in.transpose(0, 1), b_in.permute(1, 2, 0), low)  # (G, S_t, S_s)
    group = torch.arange(mh, device=h.device) // (mh // G)
    xdt = (x * delta[..., None]).transpose(0, 1)              # (heads, S, P)
    ys = []
    for lo in range(0, mh, HEAD_BLOCK):
        hs = slice(lo, min(lo + HEAD_BLOCK, mh))
        ys.append(checkpoint(_quadratic_heads, cum[hs], cb, group[hs], xdt[hs], low,
                             use_reentrant=False))
    y = torch.cat(ys).transpose(0, 1) + w["d_skip"][None, :, None] * x   # (S, heads, P)
    g = y.reshape(S, di) * F.silu(z)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + d["eps"]) * w["norm_scale"]
    return _mm(g, w["out_proj"], low)


# ---------------------------------------------------------------------------
# The stack and its loss
# ---------------------------------------------------------------------------

def _per_layer(stack: dict) -> list[dict]:
    """Each layer's weights of one stack, as views of the stacked leaves,
    every group flattened into one dict."""
    named = {"norm1": stack["norm1"]["scale"], "norm2": stack["norm2"]["scale"],
             **stack["mlp"], **stack.get("ssm", {}), **stack.get("attn", {})}
    per = {k: v.unbind(0) for k, v in named.items()}
    n = len(per["norm1"])
    return [{k: per[k][i] for k in per} for i in range(n)]


def forward(params: dict, cfg: dict, tokens: torch.Tensor, low: bool = False) -> torch.Tensor:
    """One sequence's (S, V) float32 logits."""
    d = dims(cfg)
    res = cfg["residual_multiplier"]
    stacks = {"mamba": iter(_per_layer(params["mamba_blocks"])),
              "attention": iter(_per_layer(params["attn_blocks"]))}
    x = params["embed"]["tok"][tokens.long()] * cfg["embedding_multiplier"]
    for kind in d["kinds"]:
        w = next(stacks[kind])
        h = _rms(x, w["norm1"], d["eps"])
        m = (_mamba(d, w, h, low) if kind == "mamba"
             else _attention(d, w, h, cfg["attention_multiplier"], low))
        x = x + res * m
        h = _rms(x, w["norm2"], d["eps"])
        x = x + res * _mm(F.silu(_mm(h, w["gate"], low)) * _mm(h, w["up"], low), w["down"], low)
    x = _rms(x, params["final_norm"]["scale"], d["eps"])
    return _mm(x, params["embed"]["tok"].T, low) / cfg["logits_scaling"]


def sequence_loss(params: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor,
                  n_tok: float, z_loss: float, low: bool = False) -> torch.Tensor:
    """One sequence's share of the batch's loss (``reference.lm``'s): its
    sums of the log-likelihood loss and of the squared log-sum-exp over its
    labelled positions, each over the batch's ``n_tok``."""
    logits = forward(params, cfg, tokens, low)
    mask = (labels >= 0).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0).long()[:, None])[:, 0]
    return (torch.sum((lse - gold) * mask) + z_loss * torch.sum(lse.square() * mask)) / n_tok


def loss(params: dict, cfg: dict, batch: dict, z_loss: float, low: bool = False) -> float:
    """The batch's loss alone, one sequence at a time."""
    n_tok = max(float((batch["labels"] >= 0).sum()), 1.0)
    with float32_products(), torch.no_grad():
        return sum(float(sequence_loss(params, cfg, tokens, labels, n_tok, z_loss, low))
                   for tokens, labels in zip(batch["tokens"], batch["labels"]))


def loss_and_grads(params: dict, cfg: dict, batch: dict, z_loss: float,
                   low: bool = False) -> tuple[float, dict]:
    """The batch's loss and the gradient tree (float32, like ``params``),
    one sequence at a time."""
    flat = leaves(params)
    grads = [torch.zeros_like(p) for p in flat]
    n_tok = max(float((batch["labels"] >= 0).sum()), 1.0)
    total = 0.0
    with float32_products():
        for tokens, labels in zip(batch["tokens"], batch["labels"]):
            diff = [p.detach().requires_grad_(True) for p in flat]
            with torch.enable_grad():
                seq_loss = sequence_loss(unflatten(params, diff), cfg, tokens, labels, n_tok,
                                         z_loss, low)
                got = torch.autograd.grad(seq_loss, diff)
            for g, dg in zip(grads, got):
                g += dg
            total += float(seq_loss.detach())
            del seq_loss, got, diff
    return total, unflatten(params, grads)
