"""The paper's three validation networks (port of ``repro.models.snn``;
§IV-C, Table II):

  * 2-layer SNN   — LIF neurons, fully connected, MNIST-class data
  * 6-layer DCSNN — Izhikevich neurons, conv stack, Fashion-MNIST-class data
  * 5-layer CSNN  — LIF neurons, 1-D conv stack, motor-fault time series

Every learnable layer learns with a rule of the ``repro_torch.plasticity``
registry through one update plan (``plasticity.make_plan``): conv layers
through ``UpdatePlan.conv_delta`` (the im2col conv kernel on
``backend="fused"``), fc layers through ``UpdatePlan.fc_delta`` (the dense
kernel, one launch for the whole batch).  Readout is a ridge regression on
spike counts.

The state is functional, as in the reference: ``run_snn`` returns a new
``SNNState`` and leaves its input untouched.  Histories are flat over
batch × neurons, ``(depth, B·N)``; the reference's ``lax.scan`` over time is
a Python loop.  Weights come from a ``torch.Generator`` on the host, or from
``w_init`` (a list of arrays, one per learnable layer) so that a test can
start both packages from one state.

Under a running ``torch.profiler`` the calls mark their layers
(``repro_torch.spans``): ``repro_torch.snn.run``, ``reset`` and ``step``
around ``run_snn``, ``reset_dynamics`` and each ``snn_step``, and in each
learnable layer's step ``product`` (patches, synaptic product, inhibition),
``neurons`` (the neuron step, WTA), ``update`` (the plan's Δw, training
only) and ``timing`` (the two history pushes).  With no profiler they cost
a flag check.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch import plasticity
from repro_torch.core.lif import (IzhikevichParams, LIFParams, izhikevich_init,
                                  izhikevich_step, lif_init, lif_step)
from repro_torch.core.stdp import STDPParams
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import im2col_1d, im2col_2d, resolve_packed
from repro_torch.spans import span


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SNNLayerSpec:
    kind: str                      # "fc" | "conv2d" | "conv1d" | "pool2d" | "pool1d"
    out_features: int = 0          # fc width / conv out-channels
    kernel: int = 3
    stride: int = 1
    pool: int = 2


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    name: str
    input_shape: tuple            # (H, W, C) images / (L, C) series / (N,) flat
    layers: tuple                 # tuple[SNNLayerSpec, ...]
    neuron: str = "lif"           # lif | izhikevich
    rule: str = "itp"             # plasticity.rule_names()
    depth: int = 7                # spike-history depth (§IV-B)
    pairing: str = "nearest"
    eta: float = 1.0 / 64.0
    gain: float = 4.0             # synaptic gain / fan-in normalisation
    izhi_gain: float = 20.0       # current scale into the Izhikevich model
    w_bits: int = 8
    quantise: bool = True
    backend: str = "reference"    # reference | fused | fused_interpret | sparse
    max_events: int | None = None  # sparse backend's event-list cap (None: uncapped)
    packed_history: bool = True   # fused* datapaths read packed uint8 words;
                                  # False keeps the unpacked bitplane operands
    inhibition: float = 0.0       # soft lateral inhibition (2-layer SNN)
    hard_wta: bool = False        # per sample (and position) only the most-
                                  # driven super-threshold neuron fires
    theta_plus: float = 0.0       # adaptive-threshold increment per spike
                                  # (0 disables; θ is per output channel and
                                  # persists across sample resets)
    theta_tau: float = 200.0      # θ decay time constant (steps)
    stdp: STDPParams = dataclasses.field(default_factory=STDPParams)
    lif: LIFParams = dataclasses.field(
        default_factory=lambda: LIFParams(tau=2.0, v_th=0.6))
    izhi: IzhikevichParams = dataclasses.field(default_factory=IzhikevichParams)

    def __post_init__(self):
        plasticity.validate_update_config(rule=self.rule, backend=self.backend,
                                          pairing=self.pairing,
                                          max_events=self.max_events)
        if self.theta_plus < 0.0:
            raise ValueError(f"theta_plus must be >= 0 (0 disables homeostasis), "
                             f"got {self.theta_plus}")
        if self.theta_tau <= 0.0:
            raise ValueError(f"theta_tau must be a positive decay time constant "
                             f"(steps), got {self.theta_tau}")

    def learning_rule(self) -> plasticity.LearningRule:
        return plasticity.get_rule(self.rule)

    @property
    def compensate(self) -> bool:
        """The rule's compensation override, else compensated (eq. 18)."""
        rc = self.learning_rule().compensate
        return True if rc is None else rc

    def use_packed_history(self) -> bool:
        """Whether the fused datapaths read packed uint8 register words."""
        return resolve_packed(self.packed_history, depth=self.depth)

    @property
    def theta_decay(self) -> float:
        """θ's per-step decay factor ``exp(-1/theta_tau)``, computed once in
        float64 and rounded to float32 where it multiplies θ."""
        return math.exp(-1.0 / self.theta_tau)


# The paper's three networks -------------------------------------------------

# Each maker's settings are defaults that keyword arguments override (the
# reference passes them beside **kw, so e.g. its mnist_2layer(inhibition=0.2)
# raises a duplicate-keyword TypeError).

def mnist_2layer(rule: str = "itp", n_hidden: int = 100, **kw) -> SNNConfig:
    """2-layer fully connected SNN (LIF) for MNIST-class images."""
    return SNNConfig(**{
        "name": "2layer-snn", "input_shape": (28, 28, 1),
        "layers": (SNNLayerSpec("fc", out_features=n_hidden),),
        "neuron": "lif", "rule": rule, "inhibition": 0.1, "gain": 1.2, **kw})


def fmnist_dcsnn(rule: str = "itp", **kw) -> SNNConfig:
    """6-layer deep convolutional SNN (Izhikevich) for Fashion-MNIST-class
    images: conv-pool-conv-pool-fc-readout (readout is external)."""
    return SNNConfig(**{
        "name": "6layer-dcsnn", "input_shape": (28, 28, 1),
        "layers": (
            SNNLayerSpec("conv2d", out_features=12, kernel=5),
            SNNLayerSpec("pool2d", pool=2),
            SNNLayerSpec("conv2d", out_features=24, kernel=3),
            SNNLayerSpec("pool2d", pool=2),
            SNNLayerSpec("fc", out_features=128),
        ),
        "neuron": "izhikevich", "rule": rule, "gain": 1.2,
        "izhi": IzhikevichParams(dt=0.5), **kw})


def fault_csnn(rule: str = "itp", length: int = 512, channels: int = 2,
               **kw) -> SNNConfig:
    """5-layer 1-D convolutional SNN (LIF) for motor-fault time series."""
    return SNNConfig(**{
        "name": "5layer-csnn", "input_shape": (length, channels),
        "layers": (
            SNNLayerSpec("conv1d", out_features=8, kernel=7, stride=2),
            SNNLayerSpec("pool1d", pool=2),
            SNNLayerSpec("conv1d", out_features=16, kernel=5, stride=2),
            SNNLayerSpec("pool1d", pool=2),
            SNNLayerSpec("fc", out_features=64),
        ),
        "neuron": "lif", "rule": rule, "gain": 1.2,
        "lif": LIFParams(tau=2.0, v_th=0.8), **kw})


PAPER_NETWORKS = {
    "2layer-snn": mnist_2layer,
    "6layer-dcsnn": fmnist_dcsnn,
    "5layer-csnn": fault_csnn,
}


# ---------------------------------------------------------------------------
# Layer shape inference
# ---------------------------------------------------------------------------

def _layer_shapes(cfg: SNNConfig) -> list[tuple]:
    """Output feature shape after each layer (excluding batch)."""
    shape = tuple(cfg.input_shape)
    out = []
    for spec in cfg.layers:
        if spec.kind == "fc":
            shape = (spec.out_features,)
        elif spec.kind == "conv2d":
            h, w, _ = shape
            shape = ((h - spec.kernel) // spec.stride + 1,
                     (w - spec.kernel) // spec.stride + 1, spec.out_features)
        elif spec.kind == "conv1d":
            length, _ = shape
            shape = ((length - spec.kernel) // spec.stride + 1, spec.out_features)
        elif spec.kind == "pool2d":
            h, w, c = shape
            shape = (h // spec.pool, w // spec.pool, c)
        elif spec.kind == "pool1d":
            length, c = shape
            shape = (length // spec.pool, c)
        else:
            raise ValueError(spec.kind)
        out.append(shape)
    return out


def feature_size(cfg: SNNConfig) -> int:
    return math.prod(_layer_shapes(cfg)[-1])


def _fan_in(spec: SNNLayerSpec, in_shape: tuple) -> int:
    if spec.kind == "fc":
        return math.prod(in_shape)
    if spec.kind == "conv2d":
        return spec.kernel * spec.kernel * in_shape[-1]
    if spec.kind == "conv1d":
        return spec.kernel * in_shape[-1]
    return 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

class LayerState(NamedTuple):
    neurons: Any                 # LIFState | IzhikevichState | None (pool)
    pre_hist: Any                # rule timing state, flat over batch × neurons
    post_hist: Any
    theta: Any = None            # (out_features,) f32 adaptive threshold, per
                                 # output channel (None for pool layers); it
                                 # persists across reset_dynamics


class SNNState(NamedTuple):
    weights: tuple               # per learnable layer: (fan_in, out) f32
    layers: tuple                # per layer: LayerState


def _neuron_init(cfg: SNNConfig, shape, device) -> Any:
    if cfg.neuron == "izhikevich":
        return izhikevich_init(shape, cfg.izhi, device=device)
    return lif_init(shape, cfg.lif, device=device)


def _fresh_layers(cfg: SNNConfig, batch: int, device: torch.device) -> list[LayerState]:
    """Rest-state neurons, empty histories and zero θ; draws nothing."""
    rule = cfg.learning_rule()
    layers = []
    in_shape = tuple(cfg.input_shape)
    for spec, out_shape in zip(cfg.layers, _layer_shapes(cfg)):
        if spec.kind.startswith("pool"):
            layers.append(LayerState(None, None, None))
        else:
            layers.append(LayerState(
                neurons=_neuron_init(cfg, (batch,) + out_shape, device),
                pre_hist=rule.init_state(batch * math.prod(in_shape), cfg.depth,
                                         device=device),
                post_hist=rule.init_state(batch * math.prod(out_shape), cfg.depth,
                                          device=device),
                theta=torch.zeros((spec.out_features,), dtype=torch.float32,
                                  device=device)))
        in_shape = out_shape
    return layers


def init_snn(cfg: SNNConfig, batch: int, *, generator: torch.Generator | None = None,
             w_init=None, device: torch.device | str = "cuda") -> SNNState:
    """Fresh network on ``device``.  Weights are ``w_init`` (one array-like
    per learnable layer) or uniform on [0.2, 0.8), drawn on the host from
    ``generator``."""
    dev = resolve_device(device)
    learnable = [(spec, in_shape) for spec, in_shape in
                 zip(cfg.layers, [tuple(cfg.input_shape)] + _layer_shapes(cfg))
                 if not spec.kind.startswith("pool")]
    if w_init is None:
        w_init = [0.2 + 0.6 * torch.rand((_fan_in(spec, in_shape), spec.out_features),
                                         generator=generator)
                  for spec, in_shape in learnable]
    if len(w_init) != len(learnable):
        raise ValueError(f"w_init has {len(w_init)} arrays, the net has "
                         f"{len(learnable)} learnable layers")
    weights = []
    for w, (spec, in_shape) in zip(w_init, learnable):
        w = torch.as_tensor(w, dtype=torch.float32).to(dev, copy=True)
        want = (_fan_in(spec, in_shape), spec.out_features)
        if tuple(w.shape) != want:
            raise ValueError(f"w_init array has shape {tuple(w.shape)}, expected {want}")
        weights.append(w)
    return SNNState(weights=tuple(weights), layers=tuple(_fresh_layers(cfg, batch, dev)))


def _quantise(w: torch.Tensor, cfg: SNNConfig) -> torch.Tensor:
    """Snap to the (w_bits-1)-bit grid on [0, 1]: ``round(w·L)`` times the
    float32 grid step ``1/L``.  That is the arithmetic the reference's
    compiled step runs (XLA turns its ``/ L`` into a multiply by the
    reciprocal), so the two packages' grids agree bit for bit."""
    if not cfg.quantise:
        return w
    levels = (1 << (cfg.w_bits - 1)) - 1
    return torch.round(w * levels) * (1.0 / levels)


# ---------------------------------------------------------------------------
# Layer steps
# ---------------------------------------------------------------------------

def synaptic_product(patches: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``(B, P, K) @ (K, C)``: a plain full-float32 product, as the reference
    leaves it to XLA.  The two libraries sum K in different orders, so the
    currents differ in the last bits; a parity test that must follow a long
    hard-WTA trajectory bit for bit substitutes the reference's product here."""
    return torch.matmul(patches, w)


def _learnable_step(spec: SNNLayerSpec, cfg: SNNConfig, w: torch.Tensor,
                    st: LayerState, spikes_in: torch.Tensor,
                    train: bool) -> tuple[torch.Tensor, LayerState, torch.Tensor]:
    """One step of an fc/conv STDP layer.

    ``spikes_in``: ``(B, *in_shape)`` {0,1}.  Returns ``(w', state', spikes_out)``.
    """
    B = spikes_in.shape[0]
    with span("repro_torch.snn.product"):
        s_in = spikes_in.to(torch.float32)

        # --- patches + synaptic accumulation ----------------------------
        if spec.kind == "fc":
            patches = s_in.reshape(B, 1, -1)                   # (B, P=1, fan_in)
            out_shape = (B, w.shape[1])
        elif spec.kind == "conv2d":
            p = im2col_2d(s_in, spec.kernel, spec.stride)      # (B, Ho, Wo, K)
            patches = p.reshape(B, -1, p.shape[-1])
            out_shape = (B, *p.shape[1:3], w.shape[1])
        else:                                                   # conv1d
            p = im2col_1d(s_in, spec.kernel, spec.stride)
            patches = p.reshape(B, -1, p.shape[-1])
            out_shape = (B, p.shape[1], w.shape[1])
        # activity-normalised accumulation: the population-mean active-synapse
        # count (a per-step scalar) keeps the operating point invariant to
        # width and sparsity
        act_mean = torch.mean(torch.sum(patches, dim=-1))
        i_in = cfg.gain * synaptic_product(patches, w) / torch.clamp(act_mean, min=1.0)

        # --- lateral inhibition (2-layer SNN soft WTA) -------------------
        if cfg.inhibition > 0.0 and st.post_hist is not None:
            prev = cfg.learning_rule().last_spikes(st.post_hist).reshape(i_in.shape)
            total = torch.sum(prev, dim=-1, keepdim=True)
            i_in = i_in - cfg.inhibition * (total - prev)

    # --- neuron dynamics --------------------------------------------------
    with span("repro_torch.snn.neurons"):
        i_flat = i_in.reshape(out_shape)
        theta = st.theta if st.theta is not None else 0.0
        if cfg.neuron == "izhikevich":
            neurons, spikes_out = izhikevich_step(st.neurons, cfg.izhi_gain * i_flat,
                                                  cfg.izhi, v_th_offset=theta)
        else:
            neurons, spikes_out = lif_step(st.neurons, i_flat, cfg.lif, v_th_offset=theta)
        if cfg.hard_wta:
            # per sample (and position) only the most-driven super-threshold
            # neuron keeps its spike; the first index wins a tie, as jnp.argmax
            drive = torch.where(spikes_out, i_flat, float("-inf"))
            winner = torch.argmax(drive, dim=-1, keepdim=True)
            cols = torch.arange(i_flat.shape[-1], device=i_flat.device)
            spikes_out = spikes_out & (cols == winner)
        s_out = spikes_out.to(torch.float32)

    # --- STDP update through the plan ------------------------------------
    rule = cfg.learning_rule()
    if train:
        with span("repro_torch.snn.update"):
            plan = plasticity.make_plan(cfg, w.device)
            if spec.kind != "fc":
                dw = plan.conv_delta(st.pre_hist, st.post_hist, patches, s_out,
                                     in_shape=tuple(spikes_in.shape[1:]), kind=spec.kind,
                                     kernel=spec.kernel, stride=spec.stride)
            else:
                dw = plan.fc_delta(st.pre_hist, st.post_hist, s_in, s_out)
        denom = float(B * patches.shape[1])            # P = 1 for fc
        w = torch.clamp(w + cfg.eta * dw / denom, 0.0, 1.0)
        w = _quantise(w, cfg)

    # --- homeostasis θ (training only; frozen during eval) ----------------
    theta_new = st.theta
    if train and cfg.theta_plus > 0.0 and st.theta is not None:
        rate = s_out.reshape(-1, s_out.shape[-1]).mean(dim=0)
        theta_new = st.theta * cfg.theta_decay + cfg.theta_plus * rate

    # --- record the new spikes (history shift-in) -------------------------
    with span("repro_torch.snn.timing"):
        pre_hist = rule.step(st.pre_hist, s_in.reshape(-1), depth=cfg.depth)
        post_hist = rule.step(st.post_hist, s_out.reshape(-1), depth=cfg.depth)
    st = LayerState(neurons=neurons, pre_hist=pre_hist, post_hist=post_hist,
                    theta=theta_new)
    return w, st, spikes_out


def _pool_step(spec: SNNLayerSpec, spikes_in: torch.Tensor) -> torch.Tensor:
    """Spike OR-pooling (any spike in the window fires the pooled unit)."""
    s = spikes_in.to(torch.float32)
    p = spec.pool
    if spec.kind == "pool2d":
        B, H, W, C = s.shape
        s = s[:, :H // p * p, :W // p * p]
        s = s.reshape(B, H // p, p, W // p, p, C).amax(dim=(2, 4))
    else:
        B, L, C = s.shape
        s = s[:, :L // p * p]
        s = s.reshape(B, L // p, p, C).amax(dim=2)
    return s > 0.5


# ---------------------------------------------------------------------------
# Network step / run
# ---------------------------------------------------------------------------

def snn_step(state: SNNState, spikes_in: torch.Tensor, cfg: SNNConfig,
             *, train: bool = True) -> tuple[SNNState, torch.Tensor]:
    """One simulation step through the whole stack; returns last-layer spikes."""
    new_w, new_l = [], []
    wi = 0
    s = spikes_in
    with span("repro_torch.snn.step"):
        for spec, lst in zip(cfg.layers, state.layers):
            if spec.kind.startswith("pool"):
                s = _pool_step(spec, s)
                new_l.append(lst)
            else:
                w, lst2, s = _learnable_step(spec, cfg, state.weights[wi], lst, s, train)
                new_w.append(w)
                new_l.append(lst2)
                wi += 1
    return SNNState(weights=tuple(new_w), layers=tuple(new_l)), s


def run_snn(state: SNNState, raster: torch.Tensor, cfg: SNNConfig,
            *, train: bool = True) -> tuple[SNNState, torch.Tensor]:
    """Step over a ``(T, B, *input_shape)`` raster (features may be flat).

    Returns ``(state', spike counts of the last layer (B, feature_size))``.
    """
    with span("repro_torch.snn.run"):
        raster = torch.as_tensor(raster, device=state.weights[0].device)
        T, B = raster.shape[:2]
        x = raster.reshape((T, B) + tuple(cfg.input_shape))
        counts = torch.zeros((B, feature_size(cfg)), dtype=torch.float32,
                             device=raster.device)
        for t in range(T):
            # through the module's name, so that a caller may wrap the step
            state, s_out = snn_step(state, x[t], cfg, train=train)
            counts = counts + s_out.reshape(B, -1).to(torch.float32)
    return state, counts


def reset_dynamics(state: SNNState, cfg: SNNConfig, batch: int) -> SNNState:
    """Zero neuron states and histories between samples; keep the learned
    weights AND the adaptive thresholds θ (the slow homeostatic variable).
    Draws no weights and advances no generator."""
    with span("repro_torch.snn.reset"):
        fresh = _fresh_layers(cfg, batch, state.weights[0].device)
        layers = tuple(f._replace(theta=old.theta) if old.theta is not None else f
                       for f, old in zip(fresh, state.layers))
    return SNNState(weights=state.weights, layers=layers)


# ---------------------------------------------------------------------------
# Readout: ridge regression on spike counts (shared protocol, Table II)
# ---------------------------------------------------------------------------

def _design(features: torch.Tensor) -> torch.Tensor:
    X = torch.as_tensor(features, dtype=torch.float32)
    X = X / torch.clamp(X.max(), min=1.0)
    return torch.cat([X, torch.ones((X.shape[0], 1), dtype=X.dtype, device=X.device)], dim=1)


def fit_readout(features: torch.Tensor, labels: torch.Tensor, n_classes: int,
                l2: float = 1e-3) -> torch.Tensor:
    """Closed-form ridge readout ``W``: features ``(N, F)`` → one-hot labels."""
    X = _design(features)
    labels = torch.as_tensor(labels, device=X.device).long()
    Y = torch.nn.functional.one_hot(labels, n_classes).to(torch.float32)
    A = X.T @ X + l2 * torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    return torch.linalg.solve(A, X.T @ Y)


def readout_accuracy(W: torch.Tensor, features: torch.Tensor,
                     labels: torch.Tensor) -> float:
    pred = torch.argmax(_design(features) @ W, dim=-1)
    labels = torch.as_tensor(labels, device=pred.device)
    return float(torch.mean((pred == labels).to(torch.float32)))
