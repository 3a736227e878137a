"""Public wrappers of the fused ITP-STDP update (port of
``repro.kernels.itp_stdp.ops``).

Bridges ``repro_torch.core`` state (``SpikeHistory`` rings, ``STDPParams``)
to the kernel wrappers of :mod:`.kernel`.  Two operand layouts share one set
of entry points:

  * **packed**: one uint8 history word per neuron, unpacked in-register by
    the kernel — :func:`weight_update_packed` / :func:`synapse_delta_packed`;
  * **unpacked**: depth-major ``(depth, N)`` bitplanes —
    :func:`weight_update_depth_major` / :func:`synapse_delta`.

``use_kernel=False`` is the reference oracle and ``interpret=True`` the
kernel's plain version (the ``fused_interpret`` backend); both run the
plain PyTorch arithmetic on whatever device the tensors are on.  Otherwise
the kernel wrapper runs: the CUDA kernel for CUDA tensors, its plain
version for CPU tensors.  Unlike the Pallas wrappers nothing is padded to
128-lane multiples: the CUDA kernel masks ragged edges itself.

``po2`` takes the ``(po2_ltp, po2_ltd)`` pair an update plan computed once
(:func:`po2_vectors`); when omitted it is computed here, on the host, and
moved to ``w``'s device.
"""
from __future__ import annotations

import torch

from repro_torch.core.history import SpikeHistory, pack_words, registers_depth_major
from repro_torch.core.stdp import STDPParams, po2_weights
from repro_torch.kernels.dispatch import resolve_packed
from repro_torch.kernels.itp_stdp.kernel import itp_stdp_update, itp_stdp_update_packed
from repro_torch.kernels.itp_stdp.ref import (itp_stdp_update_packed_ref,
                                              itp_stdp_update_ref)

Po2Pair = tuple[torch.Tensor, torch.Tensor]


def po2_vectors(params: STDPParams, depth: int, *, compensate: bool = True,
                device: torch.device | str | None = None) -> Po2Pair:
    """``(A+·2^(-k/τ+'), A-·2^(-k/τ-'))`` in float32, built on the host."""
    ltp = params.a_plus * po2_weights(depth, params.tau_plus, compensate=compensate)
    ltd = params.a_minus * po2_weights(depth, params.tau_minus, compensate=compensate)
    return ltp.to(device), ltd.to(device)


def weight_update_depth_major(w: torch.Tensor,
                              pre_spike: torch.Tensor, post_spike: torch.Tensor,
                              pre_bits: torch.Tensor, post_bits: torch.Tensor,
                              params: STDPParams,
                              *,
                              pairing: str = "nearest",
                              compensate: bool = True,
                              eta: float = 1.0,
                              w_min: float = 0.0,
                              w_max: float = 1.0,
                              use_kernel: bool = True,
                              interpret: bool = False,
                              po2: Po2Pair | None = None) -> torch.Tensor:
    """Fused ITP-STDP update from depth-major ``(*lanes, depth, N)`` registers."""
    if po2 is None:
        po2 = po2_vectors(params, pre_bits.shape[-2], compensate=compensate,
                          device=w.device)
    kw = dict(nearest=pairing == "nearest", eta=eta, w_min=w_min, w_max=w_max)
    update = itp_stdp_update if use_kernel and not interpret else itp_stdp_update_ref
    return update(w, pre_spike, post_spike, pre_bits, post_bits, *po2, **kw)


def weight_update_packed(w: torch.Tensor,
                         pre_spike: torch.Tensor, post_spike: torch.Tensor,
                         pre_words: torch.Tensor, post_words: torch.Tensor,
                         params: STDPParams,
                         *,
                         depth: int,
                         pairing: str = "nearest",
                         compensate: bool = True,
                         eta: float = 1.0,
                         w_min: float = 0.0,
                         w_max: float = 1.0,
                         use_kernel: bool = True,
                         interpret: bool = False,
                         po2: Po2Pair | None = None) -> torch.Tensor:
    """Fused ITP-STDP update from packed ``(*lanes, N)`` uint8 history words.

    Zero words carry no history bits, so zero-padded neurons contribute
    nothing; bit-identical to :func:`weight_update_depth_major` fed the
    unpacked registers.
    """
    if po2 is None:
        po2 = po2_vectors(params, depth, compensate=compensate, device=w.device)
    kw = dict(depth=depth, nearest=pairing == "nearest", eta=eta, w_min=w_min,
              w_max=w_max)
    update = (itp_stdp_update_packed if use_kernel and not interpret
              else itp_stdp_update_packed_ref)
    return update(w, pre_spike, post_spike, pre_words, post_words, *po2, **kw)


def engine_weight_update(w: torch.Tensor,
                         pre_spike: torch.Tensor, post_spike: torch.Tensor,
                         pre_hist: SpikeHistory, post_hist: SpikeHistory,
                         params: STDPParams,
                         *,
                         pairing: str = "nearest",
                         compensate: bool = True,
                         eta: float = 1.0,
                         w_min: float = 0.0,
                         w_max: float = 1.0,
                         use_kernel: bool = True,
                         packed: bool = True,
                         interpret: bool = False,
                         po2: Po2Pair | None = None) -> torch.Tensor:
    """Update of the full synapse matrix from two ``SpikeHistory`` rings.

    ``packed=True`` feeds the kernel one uint8 word per neuron, ``False`` the
    bitplanes; the routing is ``dispatch.resolve_packed``'s.
    """
    kw = dict(pairing=pairing, compensate=compensate, eta=eta, w_min=w_min,
              w_max=w_max, use_kernel=use_kernel, interpret=interpret, po2=po2)
    if resolve_packed(packed, depth=pre_hist.depth, use_kernel=use_kernel):
        return weight_update_packed(w, pre_spike, post_spike, pack_words(pre_hist),
                                    pack_words(post_hist), params,
                                    depth=pre_hist.depth, **kw)
    return weight_update_depth_major(w, pre_spike, post_spike,
                                     registers_depth_major(pre_hist),
                                     registers_depth_major(post_hist), params, **kw)


def synapse_delta(pre_spike: torch.Tensor, post_spike: torch.Tensor,
                  pre_bits: torch.Tensor, post_bits: torch.Tensor,
                  params: STDPParams,
                  *,
                  pairing: str = "nearest",
                  compensate: bool = True,
                  use_kernel: bool = True,
                  interpret: bool = False,
                  po2: Po2Pair | None = None) -> torch.Tensor:
    """Raw Δw ``(*lanes, n_pre, n_post)`` from registers: zero ``w``,
    ``eta=1`` and an unbounded clip through the same kernel.  No program
    path calls it or :func:`synapse_delta_packed` (the SNN fc layers sum
    the batch in the conv kernel, ``itp_stdp_conv``): they are the per-lane
    reference the tests hold that sum against."""
    zero_w = pre_bits.new_zeros((*pre_bits.shape[:-2], pre_bits.shape[-1],
                                 post_bits.shape[-1]), dtype=torch.float32)
    return weight_update_depth_major(
        zero_w, pre_spike, post_spike, pre_bits, post_bits, params,
        pairing=pairing, compensate=compensate, eta=1.0, w_min=float("-inf"),
        w_max=float("inf"), use_kernel=use_kernel, interpret=interpret, po2=po2)


def synapse_delta_packed(pre_spike: torch.Tensor, post_spike: torch.Tensor,
                         pre_words: torch.Tensor, post_words: torch.Tensor,
                         params: STDPParams,
                         *,
                         depth: int,
                         pairing: str = "nearest",
                         compensate: bool = True,
                         use_kernel: bool = True,
                         interpret: bool = False,
                         po2: Po2Pair | None = None) -> torch.Tensor:
    """Raw Δw from packed words: the packed twin of :func:`synapse_delta`."""
    zero_w = torch.zeros((*pre_words.shape, post_words.shape[-1]),
                         dtype=torch.float32, device=pre_words.device)
    return weight_update_packed(
        zero_w, pre_spike, post_spike, pre_words, post_words, params,
        depth=depth, pairing=pairing, compensate=compensate, eta=1.0,
        w_min=float("-inf"), w_max=float("inf"), use_kernel=use_kernel,
        interpret=interpret, po2=po2)
