"""Plain float32 reference of a dense decoder's training step, in the
Qwen3 layout (https://huggingface.co/Qwen/Qwen3-0.6B): plain ``torch`` only,
no kernel, no cache, no batching; it imports nothing of the program.

Per layer, on a residual stream ``x`` of width ``hidden_size``:

    h = RMSNorm(x)                         x · rsqrt(mean(x²) + eps) · scale
    q, k, v = h Wq, h Wk, h Wv             no bias; q in heads of head_dim,
                                           k and v in the kv heads
    q, k = RMSNorm(q), RMSNorm(k)          each head, its own scale
    q, k = RoPE(q), RoPE(k)                rotate-half, angles pos · θ^(-2i/hd)
    o = softmax(q kᵀ / sqrt(hd) + causal) v    q head j reads kv head j // (H/K)
    x = x + o Wo
    x = x + (silu(h Wgate) · h Wup) Wdown  with h = RMSNorm(x)

then the final RMSNorm and the logits against the (tied) token table.  The
loss is the port's ``train_step.lm_loss`` for a dense
model: the mean over the labelled positions (label ≥ 0) of the
log-sum-exp of the logits less the gold logit, plus ``z_loss`` times the
mean of the squared log-sum-exp.  Gradients by autograd, one sequence at a
time, summed (the loss's means are over the whole batch's labelled
positions), so that a step at full width fits beside nothing.

:func:`itp_adamw` is the port's ITP-AdamW (``train/optimizer.py``) written
out op for op in float32: the warm-up-then-cosine learning rate, the clip by
the global norm (each leaf's sum of squares added in the trees' sorted key
order), the moments with their bias corrections, decoupled weight decay, and
ITP's snap of the update to sign · 2^round(log2|u|) (:func:`po2`, exact
integer arithmetic on the float's bits: a mantissa at or above the smallest
one over sqrt(2) rounds the exponent up, the exponent clipped to [-63, 63],
zero, subnormals and NaN to +0).  Written so, it gives the program's bits
for the program's own gradients and state on the same device.

Every matrix product runs in float32 with TF32 off (:func:`float32_products`).
``low=True`` is the control: each product's operands rounded to
``float8_e4m3fn`` with one scale per operand (its largest magnitude onto
448), the precision below the configuration's bfloat16 that a later change
might take.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0   # the largest finite float8_e4m3fn


@contextlib.contextmanager
def float32_products():
    """Full float32 matrix products (TF32 off for cuBLAS and cuDNN), then the
    previous settings."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was[:2]
        torch.set_float32_matmul_precision(was[2])


def leaves(tree) -> list:
    """The leaves in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in leaves(tree[k])]
    return [tree]


def unflatten(like, flat: list):
    it = iter(flat)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


# ---------------------------------------------------------------------------
# The decoder and its loss
# ---------------------------------------------------------------------------

def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn under one scale, its largest magnitude
    onto 448; the gradient passes straight through."""
    with torch.no_grad():
        scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
        r = (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (r - x).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    return _fp8(a) @ _fp8(b) if low else a @ b


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE of ``x`` (S, heads, hd) at positions 0..S-1, the
    angles in float64."""
    S, hd = x.shape[0], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang).float()[:, None], torch.sin(ang).float()[:, None]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _layer(cfg: dict, w: dict, x: torch.Tensor, low: bool) -> torch.Tensor:
    S = x.shape[0]
    H, K, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps = cfg["rms_norm_eps"]
    h = _rms(x, w["norm1"], eps)
    q = _rms(_mm(h, w["wq"], low).view(S, H, hd), w["q_norm"], eps)
    k = _rms(_mm(h, w["wk"], low).view(S, K, hd), w["k_norm"], eps)
    v = _mm(h, w["wv"], low).view(S, K, hd)
    q, k = _rope(q, cfg["rope_theta"]), _rope(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // K, dim=1).transpose(0, 1)        # (H, S, hd)
    v = v.repeat_interleave(H // K, dim=1).transpose(0, 1)
    scores = _mm(q.transpose(0, 1), k.transpose(1, 2), low) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = _mm(p, v, low).transpose(0, 1).reshape(S, H * hd)
    x = x + _mm(o, w["wo"], low)
    h = _rms(x, w["norm2"], eps)
    return x + _mm(F.silu(_mm(h, w["gate"], low)) * _mm(h, w["up"], low), w["down"], low)


def _layer_weights(params: dict) -> list[dict]:
    """Each layer's weights, as views of the stacked leaves."""
    b = params["blocks"]
    named = {"norm1": b["norm1"]["scale"], "norm2": b["norm2"]["scale"],
             **b["attn"], **b["mlp"]}
    per = {k: v.unbind(0) for k, v in named.items()}
    return [{k: per[k][i] for k in per} for i in range(len(per["wq"]))]


def sequence_loss(params: dict, cfg: dict, tokens: torch.Tensor, labels: torch.Tensor,
                  n_tok: float, z_loss: float, low: bool = False) -> torch.Tensor:
    """One sequence's share of the batch's loss: its sums of the
    log-likelihood loss and of the squared log-sum-exp over its labelled
    positions, each over the batch's ``n_tok``."""
    x = params["embed"]["tok"][tokens.long()]
    for w in _layer_weights(params):
        x = _layer(cfg, w, x, low)
    x = _rms(x, params["final_norm"]["scale"], cfg["rms_norm_eps"])
    logits = _mm(x, params["embed"]["tok"].T, low)
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
                loss = sequence_loss(unflatten(params, diff), cfg, tokens, labels, n_tok,
                                     z_loss, low)
                got = torch.autograd.grad(loss, diff)
            for g, d in zip(grads, got):
                g += d
            total += float(loss.detach())
            del loss, got, diff
    return total, unflatten(params, grads)


# ---------------------------------------------------------------------------
# ITP-AdamW
# ---------------------------------------------------------------------------

SQRT2_MANTISSA = 0x3504F4    # the smallest float32 mantissa above sqrt(2)


def po2(x: torch.Tensor) -> torch.Tensor:
    """sign · 2^round(log2|x|) of float32 ``x``, from the float's bits."""
    bits = x.contiguous().view(torch.int32)
    field = (bits >> 23) & 0xFF
    mant = bits & 0x7FFFFF
    e = torch.clamp(field - 127 + (mant >= SQRT2_MANTISSA).to(torch.int32), -63, 63)
    out = (bits & torch.iinfo(torch.int32).min) | ((e + 127) << 23)
    zero = (field == 0) | ((field == 0xFF) & (mant != 0))
    return torch.where(zero, 0.0, out.view(torch.float32))


def lr_at(opt: dict, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio`` · lr."""
    step = step.to(torch.float32)
    warm = step / max(opt["warmup_steps"], 1)
    frac = torch.clamp((step - opt["warmup_steps"])
                       / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0, 1.0)
    cos = opt["min_lr_ratio"] + (1 - opt["min_lr_ratio"]) * 0.5 * (1 + torch.cos(math.pi * frac))
    return opt["lr"] * torch.where(step < opt["warmup_steps"], warm, cos)


def fresh_state(params: dict, device) -> dict:
    """Step 0 and zero moments."""
    zeros = [torch.zeros_like(p, dtype=torch.float32) for p in leaves(params)]
    return {"step": torch.zeros((), dtype=torch.int32, device=device),
            "mu": unflatten(params, zeros),
            "nu": unflatten(params, [z.clone() for z in zeros])}


def itp_adamw(opt: dict, params: dict, grads: dict, state: dict) -> tuple[dict, dict]:
    """One update: ``(params', state')``; ``state`` is ``{"step", "mu", "nu"}``."""
    g = [x.to(torch.float32) for x in leaves(grads)]
    if opt["grad_clip"] > 0:
        norm = torch.sqrt(sum(torch.sum(torch.square(x)) for x in g))
        numer = torch.full_like(norm, opt["grad_clip"])
        scale = torch.clamp(numer / torch.clamp(norm, min=1e-12), max=1.0)
        g = [x * scale for x in g]
    step = state["step"] + 1
    lr = lr_at(opt, step)
    b1, b2 = opt["beta1"], opt["beta2"]
    bc1 = 1 - torch.pow(b1, step.to(torch.float32))
    bc2 = 1 - torch.pow(b2, step.to(torch.float32))
    new_p, new_m, new_v = [], [], []
    for p, gi, m, v in zip(leaves(params), g, leaves(state["mu"]), leaves(state["nu"])):
        m = b1 * m + (1 - b1) * gi
        v = b2 * v + (1 - b2) * torch.square(gi)
        u = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
        u = po2(u + opt["weight_decay"] * p.to(torch.float32))
        new_p.append((p.to(torch.float32) - lr * u).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return unflatten(params, new_p), {"step": step, "mu": unflatten(params, new_m),
                                      "nu": unflatten(params, new_v)}
