"""Carry engine and session state between the JAX reference and the port.

The two packages' random streams cannot match, so everything a parity
check compares goes through here (engine, serving-session and SNN state):
the reference's state, read as numpy arrays, becomes the port's on a chosen
device, and the port's state comes
back as numpy arrays in the reference's field order, ready to wrap in its
NamedTuples.  Nothing here imports JAX: the ``*_from_arrays`` functions
take any object with the reference's attribute names whose leaves
``numpy.asarray`` accepts.

The history ring's ``head`` is int64 in the port and int32 in the
reference; the words, planes, weights and membranes keep their dtypes.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import EngineState
from repro_torch.core.history import SpikeHistory
from repro_torch.core.lif import IzhikevichState, LIFState
from repro_torch.models.snn import LayerState, SNNState
from repro_torch.serve.session import SessionState


def _to(x, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype).to(device)


def _np(x: torch.Tensor, dtype=None) -> np.ndarray:
    out = x.detach().cpu().numpy()
    return out if dtype is None else out.astype(dtype)


def _history(h, device) -> SpikeHistory:
    return SpikeHistory(planes=_to(h.planes, torch.uint8, device),
                        head=_to(h.head, torch.int64, device))


def engine_state_from_arrays(state, *, device: torch.device | str) -> EngineState:
    """``EngineState`` from the reference's (``w``, ``pre_hist``,
    ``post_hist``, ``neurons.v``); histories are ``SpikeHistory`` rings."""
    return EngineState(w=_to(state.w, torch.float32, device),
                       pre_hist=_history(state.pre_hist, device),
                       post_hist=_history(state.post_hist, device),
                       neurons=LIFState(v=_to(state.neurons.v, torch.float32, device)))


def engine_state_to_numpy(state: EngineState) -> tuple:
    """``(w, (planes, head), (planes, head), (v,))`` — the reference's
    ``EngineState(w, SpikeHistory, SpikeHistory, LIFState)`` field order."""
    return (_np(state.w),
            (_np(state.pre_hist.planes), _np(state.pre_hist.head, np.int32)),
            (_np(state.post_hist.planes), _np(state.post_hist.head, np.int32)),
            (_np(state.neurons.v),))


def session_state_from_arrays(state, *, device: torch.device | str) -> SessionState:
    """``SessionState`` from the reference's (``w``, word tuples, ``v``,
    ``theta``, ``t``)."""
    return SessionState(
        w=_to(state.w, torch.float32, device),
        pre_words=tuple(_to(x, torch.uint8, device) for x in state.pre_words),
        post_words=tuple(_to(x, torch.uint8, device) for x in state.post_words),
        v=_to(state.v, torch.float32, device),
        theta=_to(state.theta, torch.float32, device),
        t=int(np.asarray(state.t)))


def session_state_to_numpy(state: SessionState) -> tuple:
    """``(w, pre_words, post_words, v, theta, t)`` in the reference's
    ``SessionState`` field order; ``t`` as an int32 scalar."""
    return (_np(state.w), tuple(_np(x) for x in state.pre_words),
            tuple(_np(x) for x in state.post_words), _np(state.v),
            _np(state.theta), np.int32(state.t))


def _neurons(n, device):
    if n is None:
        return None
    if hasattr(n, "u"):
        return IzhikevichState(v=_to(n.v, torch.float32, device),
                               u=_to(n.u, torch.float32, device))
    return LIFState(v=_to(n.v, torch.float32, device))


def snn_state_from_arrays(state, *, device: torch.device | str) -> SNNState:
    """``SNNState`` from the reference's (``weights``, ``layers``): every
    layer's neuron state (LIF ``v`` or Izhikevich ``v, u``), its two
    ``SpikeHistory`` rings and θ; pool layers stay all-``None``."""
    layers = []
    for lst in state.layers:
        if lst.neurons is None:
            layers.append(LayerState(None, None, None))
            continue
        layers.append(LayerState(
            neurons=_neurons(lst.neurons, device),
            pre_hist=_history(lst.pre_hist, device),
            post_hist=_history(lst.post_hist, device),
            theta=None if lst.theta is None else _to(lst.theta, torch.float32, device)))
    return SNNState(weights=tuple(_to(w, torch.float32, device) for w in state.weights),
                    layers=tuple(layers))


def snn_state_to_numpy(state: SNNState) -> tuple:
    """``(weights, layers)`` in the reference's field order: each layer is
    ``(neurons, (planes, head), (planes, head), theta)``, neurons ``(v,)`` or
    ``(v, u)``; a pool layer is ``(None, None, None, None)``."""
    layers = []
    for lst in state.layers:
        if lst.neurons is None:
            layers.append((None, None, None, None))
            continue
        layers.append((tuple(_np(x) for x in lst.neurons),
                       (_np(lst.pre_hist.planes), _np(lst.pre_hist.head, np.int32)),
                       (_np(lst.post_hist.planes), _np(lst.post_hist.head, np.int32)),
                       None if lst.theta is None else _np(lst.theta)))
    return tuple(_np(w) for w in state.weights), tuple(layers)
