"""Deprecated shim: the counter-based exact-STDP baseline engine (port of
``repro.core.baseline``).

The CounterEngine (conventional digital STDP, §I: per-neuron last-spike
counters, per-pair Δt and a base-e exponential) is the registry rule
``EngineConfig(rule="exact")`` of :mod:`repro_torch.plasticity`, so the
baseline shares the engine's LIF dynamics, loop, backends and kernels.  A
counter ``window`` of W maps to a rule ``depth`` of W+1 (valid delays
t ∈ [0, W], saturation at W+1).

These aliases keep old call sites working but emit ``DeprecationWarning``
pointing at the registry path; new code uses :mod:`repro_torch.core.engine`
with ``rule="exact"`` directly.  As the port's engine, they take a
``generator`` and a ``device`` (default ``"cuda"``) in place of the
reference's PRNG key.
"""
from __future__ import annotations

import warnings

import torch

from repro_torch.core.engine import (EngineConfig, EngineState, engine_step,
                                     init_engine, run_engine)
from repro_torch.core.lif import LIFParams
from repro_torch.core.stdp import STDPParams

CounterEngineState = EngineState


def _deprecated(alias: str, target: str) -> None:
    warnings.warn(
        f"repro_torch.core.baseline.{alias} is deprecated: the counter baseline "
        f"is the registry rule EngineConfig(rule='exact') — use "
        f"repro_torch.core.engine.{target} directly",
        DeprecationWarning, stacklevel=3)


def CounterEngineConfig(n_pre: int = 4, n_post: int = 4, window: int = 7,
                        eta: float = 1.0 / 16.0, w_min: float = 0.0,
                        w_max: float = 1.0,
                        stdp: STDPParams | None = None,
                        lif: LIFParams | None = None) -> EngineConfig:
    """Deprecated: build the equivalent ``EngineConfig(rule="exact")``."""
    _deprecated("CounterEngineConfig", "EngineConfig(rule='exact')")
    return EngineConfig(
        n_pre=n_pre, n_post=n_post, depth=window + 1, rule="exact",
        eta=eta, w_min=w_min, w_max=w_max,
        stdp=stdp if stdp is not None else STDPParams(),
        lif=lif if lif is not None else LIFParams())


def init_counter_engine(cfg, w_init=None, *, generator: torch.Generator | None = None,
                        device: torch.device | str = "cuda"):
    """Deprecated alias for :func:`repro_torch.core.engine.init_engine`."""
    _deprecated("init_counter_engine", "init_engine")
    _check_exact(cfg)
    return init_engine(cfg, w_init, generator=generator, device=device)


def counter_engine_step(state, pre_spikes, cfg):
    """Deprecated alias for :func:`repro_torch.core.engine.engine_step`."""
    _deprecated("counter_engine_step", "engine_step")
    _check_exact(cfg)
    return engine_step(state, pre_spikes, cfg)


def run_counter_engine(state, spike_train, cfg):
    """Deprecated alias for :func:`repro_torch.core.engine.run_engine`."""
    _deprecated("run_counter_engine", "run_engine")
    _check_exact(cfg)
    return run_engine(state, spike_train, cfg)


def _check_exact(cfg: EngineConfig) -> None:
    if not isinstance(cfg, EngineConfig):
        raise TypeError(
            "CounterEngineConfig now *returns* an EngineConfig(rule='exact') "
            f"— call it rather than passing {type(cfg).__name__}")
    if cfg.rule != "exact":
        raise ValueError(
            f"counter-engine aliases expect rule='exact', got {cfg.rule!r}; "
            "use repro_torch.core.engine directly for other rules")
