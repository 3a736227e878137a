"""ITP-STDP learning engine (port of ``repro.core.engine``).

Per step (paper Fig. 9): (1) synaptic accumulation ``pre @ w``, (2) a LIF
step, (3) the weight update through the plasticity plan — the fused CUDA
kernel on ``backend="fused"`` — unless ``learn=False`` freezes plasticity,
(4) the history shift-in.  The reference's ``lax.scan`` is a Python loop
here, and its ``vmap`` over replicas a leading lane axis on every state
tensor: ``w`` ``(*lanes, n_pre, n_post)``, histories ``(*lanes, depth, n)``,
membrane ``(*lanes, n_post)``.  Lanes never interact.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch import plasticity
from repro_torch.core.lif import LIFParams, LIFState, lif_init, lif_step
from repro_torch.core.stdp import STDPParams
from repro_torch.device import resolve_device
from repro_torch.kernels.dispatch import resolve_packed


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    n_pre: int = 4
    n_post: int = 4
    depth: int = 7                       # spike-history depth (§IV-B)
    pairing: str = "nearest"             # engine hardware uses NN (§II-B)
    compensate: bool = True
    eta: float = 1.0 / 16.0              # po2 learning rate (shift by 4)
    w_min: float = 0.0
    w_max: float = 1.0
    w_bits: int = 8                      # weight word width incl. sign
    quantise: bool = False               # round weights to the 8-bit grid
    rule: str = "itp"                    # plasticity.rule_names()
    backend: str = "reference"           # reference | fused | fused_interpret | sparse
    max_events: int | None = None        # sparse backend's event-list cap (None: uncapped)
    packed_history: bool = True          # fused* datapaths read packed uint8
                                         # words; depth > 8 falls back to the
                                         # unpacked bitplanes
    stdp: STDPParams = dataclasses.field(default_factory=STDPParams)
    lif: LIFParams = dataclasses.field(default_factory=LIFParams)

    def __post_init__(self):
        plasticity.validate_update_config(rule=self.rule, backend=self.backend,
                                          pairing=self.pairing,
                                          max_events=self.max_events)

    def learning_rule(self) -> plasticity.LearningRule:
        return plasticity.get_rule(self.rule)

    def effective_compensate(self) -> bool:
        """The rule's compensation override, or this config's flag."""
        rc = self.learning_rule().compensate
        return self.compensate if rc is None else rc

    def use_packed_history(self) -> bool:
        """Whether the fused datapaths read packed uint8 register words."""
        return resolve_packed(self.packed_history, depth=self.depth)


class EngineState(NamedTuple):
    w: torch.Tensor              # float32[*lanes, n_pre, n_post]
    pre_hist: Any                # rule timing state
    post_hist: Any
    neurons: LIFState            # membrane, float32[*lanes, n_post]


def _init(cfg: EngineConfig, batch: tuple[int, ...], w_init, generator,
          device) -> EngineState:
    dev = resolve_device(device)
    if w_init is None:
        w_init = 0.2 + 0.6 * torch.rand((*batch, cfg.n_pre, cfg.n_post),
                                        generator=generator)
    rule = cfg.learning_rule()
    return EngineState(
        w=torch.as_tensor(w_init, dtype=torch.float32).to(dev, copy=True),
        pre_hist=rule.init_state(cfg.n_pre, cfg.depth, batch=batch, device=dev),
        post_hist=rule.init_state(cfg.n_post, cfg.depth, batch=batch, device=dev),
        neurons=lif_init((*batch, cfg.n_post), cfg.lif, device=dev),
    )


def init_engine(cfg: EngineConfig, w_init=None, *,
                generator: torch.Generator | None = None,
                device: torch.device | str = "cuda") -> EngineState:
    """Fresh engine on ``device``; weights are ``w_init`` (array-like) or
    uniform on [0.2, 0.8) drawn on the host from ``generator``."""
    return _init(cfg, (), w_init, generator, device)


def prototype_engine(w_init=None, *, generator: torch.Generator | None = None,
                     device: torch.device | str = "cuda"
                     ) -> tuple[EngineConfig, EngineState]:
    """The paper's 4×4 fully connected prototype (§III-B / Table V row 1),
    initialised as :func:`init_engine` does."""
    cfg = EngineConfig(n_pre=4, n_post=4)
    return cfg, init_engine(cfg, w_init, generator=generator, device=device)


def _quantise(w: torch.Tensor, cfg: EngineConfig) -> torch.Tensor:
    """Snap to the (w_bits-1)-bit magnitude grid on [w_min, w_max]."""
    levels = (1 << (cfg.w_bits - 1)) - 1
    scale = (cfg.w_max - cfg.w_min) / levels
    return cfg.w_min + torch.round((w - cfg.w_min) / scale) * scale


def engine_step(state: EngineState, pre_spikes: torch.Tensor, cfg: EngineConfig,
                *, learn: bool = True, v_th_offset: torch.Tensor | float = 0.0
                ) -> tuple[EngineState, torch.Tensor]:
    """One engine cycle; returns ``(state', post_spikes)`` (spikes bool).

    ``learn=False`` skips step 3 (frozen plasticity, the serving layer's
    eval traffic); ``v_th_offset`` is the per-neuron threshold term θ.
    """
    pre_spikes = torch.as_tensor(pre_spikes, device=state.w.device)

    # 1. synaptic accumulation, gated by presynaptic activity (§V-B); a plain
    #    full-float32 product, as the reference leaves it to XLA
    i_in = torch.matmul(pre_spikes.to(torch.float32).unsqueeze(-2), state.w).squeeze(-2)

    # 2. LIF integrate-and-fire
    neurons, post_spikes = lif_step(state.neurons, i_in, cfg.lif,
                                    v_th_offset=v_th_offset)

    # 3. weight update from the stored timing state, through the plan
    rule = cfg.learning_rule()
    w = state.w
    if learn:
        w = plasticity.apply_update(cfg, w, pre_spikes, post_spikes,
                                    state.pre_hist, state.post_hist)
        if cfg.quantise:
            w = _quantise(w, cfg)

    # 4. record the new spikes (history shift-in)
    pre_hist = rule.step(state.pre_hist, pre_spikes, depth=cfg.depth)
    post_hist = rule.step(state.post_hist, post_spikes, depth=cfg.depth)
    return EngineState(w, pre_hist, post_hist, neurons), post_spikes


def run_engine(state: EngineState, spike_train: torch.Tensor, cfg: EngineConfig,
               *, learn: bool = True) -> tuple[EngineState, torch.Tensor]:
    """Step over a ``(*lanes, T, n_pre)`` raster; returns the post raster."""
    spike_train = torch.as_tensor(spike_train, device=state.w.device)
    posts = []
    for x in spike_train.unbind(-2):
        state, post = engine_step(state, x, cfg, learn=learn)
        posts.append(post)
    return state, torch.stack(posts, dim=-2)


def init_engine_population(cfg: EngineConfig, n_replicas: int, *,
                           generator: torch.Generator | None = None,
                           device: torch.device | str = "cuda") -> EngineState:
    """``n_replicas`` independent engines on one leading lane axis."""
    return _init(cfg, (n_replicas,), None, generator, device)


def run_engine_population(states: EngineState, spike_trains: torch.Tensor,
                          cfg: EngineConfig, *, learn: bool = True
                          ) -> tuple[EngineState, torch.Tensor]:
    """Every replica over its own raster: ``spike_trains`` ``(R, T, n_pre)``
    → (states', post rasters ``(R, T, n_post)``)."""
    return run_engine(states, spike_trains, cfg, learn=learn)
