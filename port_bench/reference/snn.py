"""Plain PyTorch reference of the paper's spiking nets as the benchmark runs them.

It imports no kernel, no ``jax`` and nothing of the program: it reads the
configuration's JSON dictionary and works out, from the same inputs, what
one simulation step of the net gives.  Its state is a plain dictionary:

  ``{"w": [W (fan_in, out) float32, ...],
     "layers": [None for a pool layer, or {"v", "u" (Izhikevich),
                "pre", "post", "theta"}]}``

where ``pre`` / ``post`` are the timing state of a layer's inputs and
outputs, flat over batch × neurons: for the history rules (``itp``,
``itp_nocomp``) ``(depth, B·n)`` uint8 registers with row 0 the newest
step, for the counter rule ``exact`` ``(B·n,)`` int32 last-spike counters
saturating at ``depth``.

What each part computes (the layers the benchmark's comparison covers):

  * the synaptic product ``patches @ W`` with the activity normalisation
    ``gain / max(mean active inputs per patch, 1)``; the product is summed
    in float64 and rounded once (``precision="exact"``), or, for the
    control, with both operands rounded to TF32 and float32 accumulation
    (``precision="tf32"``);
  * soft inhibition from the previous step's spikes;
  * the LIF or Izhikevich step, each operation in the port's order, and
    spike OR-pooling;
  * the batch-summed Δw: the XOR pair gate (LTP where only the post neuron
    fired, LTD where only the pre neuron did) times the nearest-spike po2
    magnitude ``A·2^(-k/(τ·ln2))`` or the exact window ``A·exp(-t/τ)``,
    contracted over batch and positions in float64 and rounded once;
  * the clip to [0, 1] and the 8-bit quantisation;
  * the history shift and the counters' ageing.
"""
from __future__ import annotations

import math

import torch

HISTORY_RULES = {"itp": True, "itp_nocomp": False}   # rule → compensated
COUNTER_RULES = ("exact",)


def check_rule(rule: str) -> None:
    if rule not in HISTORY_RULES and rule not in COUNTER_RULES:
        raise ValueError(f"the reference has no rule {rule!r}")


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------

def layer_shapes(cfg: dict) -> list[tuple]:
    """Output feature shape of each layer, batch excluded."""
    shape = tuple(cfg["input_shape"])
    out = []
    for spec in cfg["layers"]:
        kind = spec["kind"]
        if kind == "fc":
            shape = (spec["out_features"],)
        elif kind == "conv2d":
            h, w, _ = shape
            k, s = spec["kernel"], spec["stride"]
            shape = ((h - k) // s + 1, (w - k) // s + 1, spec["out_features"])
        elif kind == "pool2d":
            h, w, c = shape
            shape = (h // spec["pool"], w // spec["pool"], c)
        else:
            raise ValueError(f"the reference has no layer kind {kind!r}")
        out.append(shape)
    return out


def in_shapes(cfg: dict) -> list[tuple]:
    return [tuple(cfg["input_shape"])] + layer_shapes(cfg)[:-1]


def weight_shapes(cfg: dict) -> list[tuple[int, int]]:
    """``(fan_in, out)`` of each learnable layer."""
    shapes = []
    for spec, ins in zip(cfg["layers"], in_shapes(cfg)):
        if spec["kind"] == "fc":
            shapes.append((math.prod(ins), spec["out_features"]))
        elif spec["kind"] == "conv2d":
            shapes.append((spec["kernel"] ** 2 * ins[-1], spec["out_features"]))
    return shapes


def patches_of(spec: dict, s_in: torch.Tensor) -> torch.Tensor:
    """``(B, *in_shape)`` float32 → ``(B, P, K)`` patches; a conv patch lists
    its window row by row, each pixel's channels together."""
    B = s_in.shape[0]
    if spec["kind"] == "fc":
        return s_in.reshape(B, 1, -1)
    k, st = spec["kernel"], spec["stride"]
    p = s_in.unfold(1, k, st).unfold(2, k, st)            # (B, Ho, Wo, C, kh, kw)
    p = p.permute(0, 1, 2, 4, 5, 3)                        # (B, Ho, Wo, kh, kw, C)
    return p.reshape(B, p.shape[1] * p.shape[2], -1)


def or_pool(spec: dict, s: torch.Tensor) -> torch.Tensor:
    """Spike OR-pooling of ``(B, H, W, C)`` spikes; bool."""
    p = spec["pool"]
    B, H, W, C = s.shape
    s = s[:, :H // p * p, :W // p * p].to(torch.bool)
    return s.reshape(B, H // p, p, W // p, p, C).any(dim=4).any(dim=2)


# ---------------------------------------------------------------------------
# Precision of the synaptic product
# ---------------------------------------------------------------------------

def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 stored mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


def product(patches: torch.Tensor, w: torch.Tensor, precision: str,
            block: int = 1 << 22) -> torch.Tensor:
    """``(B, P, K) @ (K, C)`` → ``(B, P, C)`` float32, in row blocks."""
    B, P, K = patches.shape
    rows = patches.reshape(B * P, K)
    step = max(1, block // max(1, w.shape[1]))
    out = []
    if precision == "exact":
        w64 = w.to(torch.float64)
        for r in rows.split(step):
            out.append((r.to(torch.float64) @ w64).to(torch.float32))
    elif precision == "tf32":
        wt = to_tf32(w)
        for r in rows.split(step):
            out.append(to_tf32(r) @ wt)
    else:
        raise ValueError(f"precision must be 'exact' or 'tf32', got {precision!r}")
    return torch.cat(out).reshape(B, P, -1)


# ---------------------------------------------------------------------------
# Timing state
# ---------------------------------------------------------------------------

def fresh_timing(rule: str, n: int, depth: int, device) -> torch.Tensor:
    if rule in HISTORY_RULES:
        return torch.zeros((depth, n), dtype=torch.uint8, device=device)
    return torch.full((n,), depth, dtype=torch.int32, device=device)


def newest(rule: str, timing: torch.Tensor) -> torch.Tensor:
    """The spikes of the step most recently recorded, ``(B·n,)`` bool."""
    if rule in HISTORY_RULES:
        return timing[0] != 0
    return timing == 0


def record(rule: str, timing: torch.Tensor, spikes: torch.Tensor, depth: int) -> torch.Tensor:
    """The timing state after this step's spikes ``(B·n,)`` are recorded."""
    spikes = spikes.reshape(-1).to(torch.bool)
    if rule in HISTORY_RULES:
        return torch.cat([spikes.to(torch.uint8)[None], timing[:-1]])
    return torch.where(spikes, 0, torch.clamp(timing + 1, max=depth)).to(torch.int32)


def magnitudes(rule: str, timing: torch.Tensor, amplitude: float, tau: float,
               depth: int) -> torch.Tensor:
    """Per-neuron Δw magnitude ``(B·n,)`` float32 read from the timing state
    before this step: the newest spike's po2 weight, or the exact window."""
    if rule in HISTORY_RULES:
        tau_eff = tau * math.log(2.0) if HISTORY_RULES[rule] else tau
        table = torch.tensor([amplitude * 2.0 ** (-k / tau_eff) for k in range(depth)]
                             + [0.0], dtype=torch.float64, device=timing.device)
        fired = timing != 0
        k = torch.where(fired.any(dim=0), fired.to(torch.uint8).argmax(dim=0), depth)
        return table[k].to(torch.float32)
    t = timing.to(torch.float64)
    mag = amplitude * torch.exp(-t / tau)
    return torch.where(timing <= depth - 1, mag, 0.0).to(torch.float32)


# ---------------------------------------------------------------------------
# Neurons
# ---------------------------------------------------------------------------

def fresh_neurons(cfg: dict, shape: tuple, device) -> dict:
    if cfg["neuron"] == "izhikevich":
        v = torch.full(shape, cfg["izhi"]["c"], dtype=torch.float32, device=device)
        return {"v": v, "u": cfg["izhi"]["b"] * v}
    return {"v": torch.full(shape, cfg["lif"]["e_rest"], dtype=torch.float32, device=device)}


def threshold_scale(cfg: dict) -> float:
    """The span from reset to threshold: the unit of the membrane gap."""
    if cfg["neuron"] == "izhikevich":
        return cfg["izhi"]["v_th"] - cfg["izhi"]["c"]
    return cfg["lif"]["v_th"] - cfg["lif"]["e_rest"]


def neuron_step(cfg: dict, neurons: dict, i_flat: torch.Tensor, theta: torch.Tensor) -> dict:
    """One step; returns the new state, the spikes, the membrane before the
    threshold test and the threshold it was tested against."""
    if cfg["neuron"] == "izhikevich":
        p = cfg["izhi"]
        v, u = neurons["v"], neurons["u"]
        i_in = cfg["izhi_gain"] * i_flat
        dv = 0.04 * v * v + 5.0 * v + 140.0 - u + i_in
        du = p["a"] * (p["b"] * v - u)
        v = v + p["dt"] * dv
        u = u + p["dt"] * du
        v_th = p["v_th"] + theta
        spikes = v >= v_th
        v_pre = v
        v = torch.where(spikes, p["c"], v)
        u = torch.where(spikes, u + p["d"], u)
        v = torch.clamp(v, min=-120.0)
        v = torch.minimum(v, v_th)
        return {"state": {"v": v, "u": u}, "spikes": spikes, "v_pre": v_pre, "v_th": v_th}
    p = cfg["lif"]
    alpha = math.exp(-1.0 / p["tau"])
    v = alpha * (neurons["v"] - p["e_rest"]) + p["e_rest"] + i_flat
    v_th = p["v_th"] + theta
    spikes = v > v_th
    return {"state": {"v": torch.where(spikes, p["e_rest"], v)}, "spikes": spikes,
            "v_pre": v, "v_th": v_th}


# ---------------------------------------------------------------------------
# One learnable layer
# ---------------------------------------------------------------------------

def layer_forward(cfg: dict, rule: str, spec: dict, w: torch.Tensor, lst: dict,
                  s_in: torch.Tensor, *, precision: str = "exact",
                  act_mean: torch.Tensor | None = None) -> dict:
    """The layer's currents and neuron step for ``(B, *in_shape)`` input
    spikes.  ``act_mean`` overrides the batch's mean active inputs per patch
    (a check on a subset of the batch's rows passes the whole batch's)."""
    B = s_in.shape[0]
    patches = patches_of(spec, s_in.to(torch.float32))
    if act_mean is None:
        act_mean = patches.to(torch.float64).sum(dim=-1).mean().to(torch.float32)
    i_in = cfg["gain"] * product(patches, w, precision) / torch.clamp(act_mean, min=1.0)
    if cfg["inhibition"] > 0.0:
        prev = newest(rule, lst["post"]).to(torch.float32).reshape(i_in.shape)
        total = torch.sum(prev, dim=-1, keepdim=True)
        i_in = i_in - cfg["inhibition"] * (total - prev)
    if spec["kind"] == "conv2d":
        k, st = spec["kernel"], spec["stride"]
        out_shape = (B, (s_in.shape[1] - k) // st + 1, (s_in.shape[2] - k) // st + 1,
                     w.shape[1])
    else:
        out_shape = (B, w.shape[1])
    res = neuron_step(cfg, {k: lst[k] for k in ("v", "u") if k in lst},
                      i_in.reshape(out_shape), lst["theta"])
    res["patches"] = patches
    return res


def delta(cfg: dict, rule: str, spec: dict, lst: dict, patches: torch.Tensor,
          post_spikes: torch.Tensor, in_shape: tuple) -> torch.Tensor:
    """Raw batch- and position-summed ``(K, C)`` Δw of one layer, from the
    timing state before the step, the patches, the step's output spikes and
    the layer's ``in_shape`` (batch excluded)."""
    p, depth = cfg["stdp"], cfg["depth"]
    B, P, K = patches.shape
    C = post_spikes.shape[-1]
    ltp = magnitudes(rule, lst["pre"], p["a_plus"], p["tau_plus"], depth)
    ltd = magnitudes(rule, lst["post"], p["a_minus"], p["tau_minus"], depth)
    if spec["kind"] == "fc":
        ltp = ltp.reshape(B, 1, K)
    else:
        ltp = patches_of(spec, ltp.reshape(B, *in_shape))
    pre = patches.reshape(B * P, K).to(torch.float64)
    post = post_spikes.reshape(B * P, C).to(torch.float64)
    ltp = ltp.reshape(B * P, K).to(torch.float64)
    ltd = ltd.reshape(B * P, C).to(torch.float64)
    dw = ((1.0 - pre) * ltp).T @ post - pre.T @ ((1.0 - post) * ltd)
    return dw.to(torch.float32)


def apply_delta(cfg: dict, w: torch.Tensor, dw: torch.Tensor, denom: float) -> torch.Tensor:
    """``w + eta·Δw / (B·P)``, clipped to [0, 1] and snapped to the
    ``w_bits``-bit grid, each operation in the port's order."""
    w = torch.clamp(w + cfg["eta"] * dw / denom, 0.0, 1.0)
    if not cfg["quantise"]:
        return w
    levels = (1 << (cfg["w_bits"] - 1)) - 1
    return torch.round(w * levels) * (1.0 / levels)


# ---------------------------------------------------------------------------
# The whole net (the control puts this in the program's place)
# ---------------------------------------------------------------------------

def fresh_layers(cfg: dict, rule: str, batch: int, device) -> list:
    layers = []
    for spec, ins, outs in zip(cfg["layers"], in_shapes(cfg), layer_shapes(cfg)):
        if spec["kind"].startswith("pool"):
            layers.append(None)
            continue
        lst = fresh_neurons(cfg, (batch, *outs), device)
        lst["pre"] = fresh_timing(rule, batch * math.prod(ins), cfg["depth"], device)
        lst["post"] = fresh_timing(rule, batch * math.prod(outs), cfg["depth"], device)
        lst["theta"] = torch.zeros((spec["out_features"],), dtype=torch.float32, device=device)
        layers.append(lst)
    return layers


def fresh_state(cfg: dict, rule: str, batch: int, weights: list) -> dict:
    check_rule(rule)
    return {"w": [w.clone() for w in weights],
            "layers": fresh_layers(cfg, rule, batch, weights[0].device)}


def reset(cfg: dict, rule: str, state: dict, batch: int) -> dict:
    """Fresh dynamics between samples; the weights and θ are kept."""
    layers = fresh_layers(cfg, rule, batch, state["w"][0].device)
    for new, old in zip(layers, state["layers"]):
        if new is not None:
            new["theta"] = old["theta"]
    return {"w": state["w"], "layers": layers}


def step(cfg: dict, rule: str, state: dict, x: torch.Tensor, *, train: bool,
         precision: str = "exact") -> tuple[dict, torch.Tensor, list]:
    """One simulation step of the whole net on ``(B, features)`` input spikes.
    Returns ``(state', last layer's spikes (B, ...), [Δw per learnable layer])``."""
    B = x.shape[0]
    s = x.reshape(B, *cfg["input_shape"])
    new_w, new_layers, dws = [], [], []
    wi = 0
    for spec, lst in zip(cfg["layers"], state["layers"]):
        if spec["kind"].startswith("pool"):
            s = or_pool(spec, s)
            new_layers.append(None)
            continue
        w = state["w"][wi]
        res = layer_forward(cfg, rule, spec, w, lst, s, precision=precision)
        spikes = res["spikes"]
        if train:
            dw = delta(cfg, rule, spec, lst, res["patches"], spikes, tuple(s.shape[1:]))
            dws.append(dw)
            w = apply_delta(cfg, w, dw, float(res["patches"].shape[0] * res["patches"].shape[1]))
        new = dict(res["state"])
        new["pre"] = record(rule, lst["pre"], s, cfg["depth"])
        new["post"] = record(rule, lst["post"], spikes, cfg["depth"])
        new["theta"] = lst["theta"]
        new_w.append(w)
        new_layers.append(new)
        s = spikes
        wi += 1
    return {"w": new_w, "layers": new_layers}, s, dws
