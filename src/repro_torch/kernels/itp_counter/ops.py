"""Public wrappers of the fused counter-rule kernels (port of
``repro.kernels.itp_counter.ops``).

Bridge rule-level state — one uint8 saturating last-spike counter word per
neuron (``repro_torch.plasticity.rules.CounterRule``), ``STDPParams`` — to
the kernel wrappers of :mod:`.kernel`.  The counter word is the counter twin
of the packed history word: the same ``(*lanes, n)`` uint8 shape, whatever
the depth (up to :data:`MAX_COUNTER_DEPTH`).

``use_kernel=False`` is the reference oracle and ``interpret=True`` the
kernel's plain version (the ``fused_interpret`` backend); both run the plain
PyTorch arithmetic of ``ref.py`` on whatever device the tensors are on.
Otherwise the kernel wrapper runs: the CUDA kernel for CUDA tensors, its
plain version for CPU tensors.  Unlike the Pallas wrappers nothing is
padded: the CUDA kernels mask ragged edges themselves.

``lut`` takes the ``(2, depth)`` window table an update plan built once
(:func:`counter_lut`); when omitted it is built here, on the host, and
moved to the operands' device.
"""
from __future__ import annotations

import torch

from repro_torch.core.stdp import STDPParams
from repro_torch.kernels.itp_counter.kernel import (counter_conv_delta, counter_fc_delta,
                                                    counter_stdp_update)
from repro_torch.kernels.itp_counter.ref import (counter_conv_delta_ref, counter_fc_delta_ref,
                                                 counter_stdp_update_ref, window_lut)

# one uint8 word per neuron: the saturating counter must fit the word
MAX_COUNTER_DEPTH = 255


def _check_depth(depth: int) -> None:
    if depth > MAX_COUNTER_DEPTH:
        raise ValueError(f"counter words are uint8: depth must be <= {MAX_COUNTER_DEPTH}")


def counter_lut(params: STDPParams, depth: int,
                device: torch.device | str | None = None) -> torch.Tensor:
    """The ``(2, depth)`` float32 window table (rows LTP, LTD) the imstdp
    window reads, built on the host with the exact window's formula."""
    return torch.stack([window_lut(params.a_plus, params.tau_plus, depth),
                        window_lut(params.a_minus, params.tau_minus, depth)]).to(device)


def _window_kw(params: STDPParams, depth: int, window: str) -> dict:
    return dict(depth=depth, window=window, a_plus=params.a_plus, a_minus=params.a_minus,
                tau_plus=params.tau_plus, tau_minus=params.tau_minus)


def counter_weight_update(w: torch.Tensor,
                          pre_spike: torch.Tensor, post_spike: torch.Tensor,
                          pre_words: torch.Tensor, post_words: torch.Tensor,
                          params: STDPParams,
                          *,
                          depth: int,
                          window: str,
                          eta: float = 1.0,
                          w_min: float = 0.0,
                          w_max: float = 1.0,
                          use_kernel: bool = True,
                          interpret: bool = False,
                          lut: torch.Tensor | None = None) -> torch.Tensor:
    """Fused explicit-Δt STDP update of ``(*lanes, n_pre, n_post)`` weights
    from ``(*lanes, n)`` counter words: the reference ``CounterRule.delta``
    datapath followed by the clipped accumulate."""
    _check_depth(depth)
    if lut is None:
        lut = counter_lut(params, depth, w.device)
    kw = dict(_window_kw(params, depth, window), eta=eta, w_min=w_min, w_max=w_max)
    if use_kernel and not interpret:
        return counter_stdp_update(w, pre_spike, post_spike, pre_words, post_words, lut,
                                   **kw)
    return counter_stdp_update_ref(w, pre_spike, post_spike, pre_words, post_words,
                                   lut=lut, **kw)


def counter_synapse_delta(pre_spike: torch.Tensor, post_spike: torch.Tensor,
                          pre_words: torch.Tensor, post_words: torch.Tensor,
                          params: STDPParams,
                          *,
                          depth: int,
                          window: str,
                          use_kernel: bool = True,
                          interpret: bool = False,
                          lut: torch.Tensor | None = None) -> torch.Tensor:
    """Raw Δw ``(*lanes, n_pre, n_post)`` from counter words — no clip, no
    ``w``: the fused update with a zero weight tile, ``eta=1`` and an
    unbounded clip, every lane in one launch (the SNN fc layers' per-sample
    delta, as ``itp_stdp.ops.synapse_delta_packed``)."""
    zero_w = torch.zeros((*pre_words.shape, post_words.shape[-1]), dtype=torch.float32,
                         device=pre_words.device)
    return counter_weight_update(
        zero_w, pre_spike, post_spike, pre_words, post_words, params, depth=depth,
        window=window, eta=1.0, w_min=float("-inf"), w_max=float("inf"),
        use_kernel=use_kernel, interpret=interpret, lut=lut)


def conv_counter_synapse_delta(pre_patches: torch.Tensor, post_spikes: torch.Tensor,
                               pre_words: torch.Tensor, post_words: torch.Tensor,
                               params: STDPParams,
                               *,
                               depth: int,
                               window: str,
                               use_kernel: bool = True,
                               interpret: bool = False,
                               lut: torch.Tensor | None = None) -> torch.Tensor:
    """Raw ``(K, C)`` conv-layer delta from im2col'd counter words:
    ``pre_words`` ``(M, K)`` / ``post_words`` ``(M, C)``, gathered into the
    im2col layout by ``itp_stdp_conv.ops.im2col_words_2d/1d`` (the window
    read commutes with the gather).  Callers apply the eta / (B·P)
    normalisation, clip and quantisation."""
    return _summed_delta(counter_conv_delta, counter_conv_delta_ref, pre_patches,
                         post_spikes, pre_words, post_words, params, depth=depth,
                         window=window, use_kernel=use_kernel, interpret=interpret, lut=lut)


def fc_counter_synapse_delta(pre_spike: torch.Tensor, post_spike: torch.Tensor,
                             pre_words: torch.Tensor, post_words: torch.Tensor,
                             params: STDPParams,
                             *,
                             depth: int,
                             window: str,
                             use_kernel: bool = True,
                             interpret: bool = False,
                             lut: torch.Tensor | None = None) -> torch.Tensor:
    """Raw ``(n_pre, n_post)`` fc-layer delta from ``(B, n)`` spikes and
    counter words: :func:`counter_synapse_delta`'s per-pair lanes summed over
    the batch in float64 and rounded once, inside one kernel launch with no
    per-lane array (the plain version builds the array and sums it)."""
    return _summed_delta(counter_fc_delta, counter_fc_delta_ref, pre_spike, post_spike,
                         pre_words, post_words, params, depth=depth, window=window,
                         use_kernel=use_kernel, interpret=interpret, lut=lut)


def _summed_delta(kernel, plain, pre, post, pre_words, post_words, params, *, depth,
                  window, use_kernel, interpret, lut):
    """A summed delta (conv or fc) on its kernel or its plain version."""
    _check_depth(depth)
    if lut is None:
        lut = counter_lut(params, depth, pre.device)
    kw = _window_kw(params, depth, window)
    if use_kernel and not interpret:
        return kernel(pre, post, pre_words, post_words, lut, **kw)
    return plain(pre, post, pre_words, post_words, lut=lut, **kw)
