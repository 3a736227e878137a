"""One dispatch layer for the weight update (port of ``repro.plasticity.apply``).

:func:`make_plan` resolves a config (``EngineConfig`` or ``SNNConfig``
duck-type) and a device into a frozen :class:`UpdatePlan`: the rule object, the backend
flags, the packed-readout selection, the effective compensation, the po2
read vectors and the rule's own read table (the counter rules' imstdp
window) — computed once on the host and moved to the device, so the kernel
and its plain version read the same bits.  Plans are cached per
``(cfg, device)``, the port's counterpart of the reference building one
static plan per trace.

:meth:`UpdatePlan.update` is the dense engine update (fused kernel, the
kernel's plain version for ``fused_interpret``, the event-driven
gather/scatter for ``sparse``, or the reference rank-1 path plus clip); the
session-word methods are the seam the serving layer rides.
:meth:`UpdatePlan.tile_update` is the weight-sharded engine's update of one
``(pre_tile, post_tile)`` tile (the same dispatch on tile-local operands),
and :meth:`UpdatePlan.state_readout` / :meth:`UpdatePlan.readout_ndim` /
:meth:`UpdatePlan.pre_events_crossing` the replicated views it slices.
:meth:`UpdatePlan.fc_delta` / :meth:`UpdatePlan.conv_delta` are the batched
SNN layer deltas (raw Δw: the layer owns eta, the batch normalisation, the
clip and quantisation).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch

from repro_torch.core.stdp import STDPParams, pair_gate
from repro_torch.device import eager
from repro_torch.kernels.dispatch import (im2col_1d, im2col_2d, im2col_words_1d,
                                          im2col_words_2d)
from repro_torch.kernels.itp_sparse.events import spike_events
from repro_torch.kernels.itp_stdp.ops import po2_vectors
from repro_torch.kernels.itp_stdp_conv.ref import gated_contraction
from repro_torch.plasticity.base import LearningRule, lane_sum, resolve_rule_backend


@dataclasses.dataclass(frozen=True)
class UpdatePlan:
    """Static dispatch decisions for one (rule, backend, config, device) cell."""

    rule: LearningRule
    backend: str
    use_kernel: bool       # fused / fused_interpret
    interpret: bool        # fused_interpret: the kernel's plain version
    sparse: bool           # event-driven datapath
    packed: bool           # resolved packed-word selection (depth <= 8)
    depth: int
    pairing: str
    compensate: bool       # effective (rule-override-resolved) flag
    stdp: STDPParams
    eta: float
    w_min: float
    w_max: float
    max_events: int | None
    device: torch.device
    po2: tuple[torch.Tensor, torch.Tensor] = dataclasses.field(compare=False)
    table: torch.Tensor | None = dataclasses.field(default=None, compare=False)

    # -- readout views (what the sharded engine slices into tiles) ------

    def state_readout(self, state: Any) -> torch.Tensor:
        """The per-neuron view of a timing state the update reads: the rule's
        kernel view on the kernel and sparse backends (``(*lanes, n)`` uint8
        words, or ``(*lanes, rows, n)`` float32 rows), its dense float32
        readout rows on ``reference``."""
        if self.use_kernel or self.sparse:
            return self.rule.kernel_view(state, packed=self.packed)
        return self.rule.readout(state).to(torch.float32)

    def readout_ndim(self) -> int:
        """ndim of an unlaned :meth:`state_readout` (1: words, sliced along
        axis 0; 2: rows, sliced along axis 1), known before any state
        exists: read off a one-neuron state on the host."""
        return self.state_readout(self.rule.init_state(1, self.depth, device="cpu")).dim()

    def pre_events_crossing(self, pre_spikes: torch.Tensor) -> torch.Tensor:
        """The global presynaptic event list every tile translates into its
        rows (:meth:`tile_update`): on ``sparse`` the capped list of the
        replicated spikes, taken once per step; otherwise an empty vector."""
        if not self.sparse:
            return torch.zeros((0,), dtype=torch.int64, device=pre_spikes.device)
        events, _ = spike_events(pre_spikes, self.max_events)
        return events

    # -- dense engine update --------------------------------------------

    def update(self, w: torch.Tensor, pre_spikes: torch.Tensor,
               post_spikes: torch.Tensor, pre_state: Any,
               post_state: Any) -> torch.Tensor:
        """Clipped update of the ``(*lanes, n_pre, n_post)`` matrix.

        The kernel and sparse backends are :meth:`tile_update` on the whole
        matrix.  The sparse backend has no silent-step skip: the reference's
        ``lax.cond`` would need the "any event" flag on the host, a wait for
        the card every step.  A silent step's event lists are all padding,
        so its update writes ``w``'s own values and the result is the same.
        """
        if self.use_kernel or self.sparse:
            return self.tile_update(w, pre_spikes, post_spikes,
                                    self.state_readout(pre_state),
                                    self.state_readout(post_state))
        dw = self.rule.delta(pre_state, post_state, pre_spikes, post_spikes, self.stdp,
                             depth=self.depth, pairing=self.pairing,
                             compensate=self.compensate)
        return torch.clamp(w + self.eta * dw, self.w_min, self.w_max)

    # -- the sharded engine's tile update -------------------------------

    def tile_update(self, w: torch.Tensor, pre_spikes: torch.Tensor,
                    post_spikes: torch.Tensor, pre_read: torch.Tensor,
                    post_read: torch.Tensor, *, pre_events: torch.Tensor | None = None,
                    pre_start: int = 0) -> torch.Tensor:
        """Clipped update of one ``(pre_tile, post_tile)`` tile of ``w``.

        The dispatch of :meth:`update` on tile-local operands: the spikes and
        the :meth:`state_readout` views are the tile's slices (the fused
        kernels take them as they take a whole matrix).  On ``sparse``,
        ``pre_events`` is the global list of :meth:`pre_events_crossing`; the
        tile's rows start at global row ``pre_start``.  The port has no
        dropping scatter, and an out-of-range index ends the CUDA context, so
        the list is translated into the tile's rows with every out-of-tile
        event turned into the padding sentinel ``tile`` and sorted to the end
        (the in-tile events of an ascending list are one run): the sparse ops
        then point it at the last in-tile event, as they do any padding.
        The post events are taken from the tile's own post spikes.
        """
        rule = self.rule
        if self.use_kernel or self.sparse:
            kw = dict(packed=self.packed, depth=self.depth, pairing=self.pairing,
                      compensate=self.compensate, eta=self.eta, w_min=self.w_min,
                      w_max=self.w_max, po2=self.po2, table=self.table)
            if self.sparse:
                if pre_events is not None:
                    tile = w.shape[-2]
                    local = pre_events - pre_start
                    local = torch.where((local >= 0) & (local < tile), local, tile)
                    pre_events = torch.sort(local, dim=-1).values
                return rule.sparse_update(w, pre_spikes, post_spikes, pre_read, post_read,
                                          self.stdp, max_events=self.max_events,
                                          pre_events=pre_events, **kw)
            return rule.fused_update(w, pre_spikes, post_spikes, pre_read, post_read,
                                     self.stdp, interpret=self.interpret, **kw)
        mag = dict(depth=self.depth, pairing=self.pairing, compensate=self.compensate)
        p = self.stdp
        ltp = rule.read_magnitudes(pre_read, p.a_plus, p.tau_plus, **mag)
        ltd = rule.read_magnitudes(post_read, p.a_minus, p.tau_minus, **mag)
        ltp_en, ltd_en = pair_gate(pre_spikes[..., :, None], post_spikes[..., None, :])
        dw = ltp_en * ltp[..., :, None] - ltd_en * ltd[..., None, :]
        return torch.clamp(w + self.eta * dw, self.w_min, self.w_max)

    # -- batched SNN layer deltas ---------------------------------------

    def fc_delta(self, pre_state: Any, post_state: Any, s_in: torch.Tensor,
                 s_out: torch.Tensor) -> torch.Tensor:
        """Batch-summed raw ``(fan_in, n_out)`` Δw of an fc layer.

        The fc layer is the engine's dense synapse matrix replicated over the
        batch.  The reference backend contracts the pair-gated magnitudes over
        the batch (the P = 1 case of the conv patch formula); the kernel
        backends hand the rule's :meth:`~repro_torch.plasticity.base.
        LearningRule.batch_delta` the batch as lanes, which for a rule with
        per-neuron magnitudes is that contraction in one conv-kernel launch
        (the counter rules' per-pair windows go to the counter fc kernel,
        which sums the lanes in its registers); the sparse backend makes one
        batched scatter and sums the ``(B, fan_in, n_out)`` per-sample deltas.  Every per-sample term is an exact float32
        value, so all sum in float64, exactly, and round once: the backends
        give the same bits.  The kernel view's shape picks the layout:
        ``(B·n,)`` words (packed history words, counter words at any depth)
        or ``(rows, B·n)`` rows.
        """
        B = s_in.shape[0]
        pre = s_in.reshape(B, -1)                        # (B, fan_in)
        post = s_out.reshape(B, -1)                      # (B, n_out)
        rule, p = self.rule, self.stdp
        kw = dict(depth=self.depth, pairing=self.pairing, compensate=self.compensate)
        if not (self.use_kernel or self.sparse):
            ltp = rule.magnitudes(pre_state, p.a_plus, p.tau_plus, **kw).reshape(B, -1)
            ltd = rule.magnitudes(post_state, p.a_minus, p.tau_minus, **kw).reshape(B, -1)
            return gated_contraction(pre, post, ltp, ltd)
        pre_read = rule.kernel_view(pre_state, packed=self.packed)
        post_read = rule.kernel_view(post_state, packed=self.packed)
        words = pre_read.dim() == 1
        if words:          # (B·n,) words → (B, n) lanes
            pre_read, post_read = pre_read.reshape(B, -1), post_read.reshape(B, -1)
        else:              # (rows, B·n) → (rows, B, n)
            pre_read = pre_read.reshape(pre_read.shape[0], B, -1)
            post_read = post_read.reshape(post_read.shape[0], B, -1)
        kw.update(packed=words, po2=self.po2, table=self.table)
        if self.sparse:    # lanes first: (B, rows, n)
            if not words:
                pre_read, post_read = pre_read.transpose(0, 1), post_read.transpose(0, 1)
            return lane_sum(rule.sparse_delta(pre, post, pre_read, post_read, p,
                                              max_events=self.max_events, **kw))
        return rule.batch_delta(pre, post, pre_read, post_read, p, interpret=self.interpret,
                                **kw)

    def conv_delta(self, pre_state: Any, post_state: Any, patches: torch.Tensor,
                   s_out: torch.Tensor, *, in_shape: tuple, kind: str, kernel: int,
                   stride: int) -> torch.Tensor:
        """Batch- and position-summed raw ``(K, C)`` Δw of a conv layer.

        The timing views are gathered into the im2col layout of the spikes
        (each patch element carries its source pixel's state): word views
        once as ``(M, K)`` uint8, row views as ``(rows, M, K)`` float32.  The
        view's shape picks the layout: a history rule gives words only on a
        kernel backend with packed histories (the reference and sparse
        backends read the rows their oracles are defined on); a counter rule
        always gives words, a :class:`~repro_torch.plasticity.base.Rank1Rule`
        always rows.  The sparse backend gathers the active rows of these
        operands into the conv kernel.
        """
        rule = self.rule
        B = s_out.shape[0]
        pre_read = rule.kernel_view(pre_state, packed=self.use_kernel and self.packed)
        post_read = rule.kernel_view(post_state, packed=self.use_kernel and self.packed)
        packed = pre_read.dim() == 1
        if packed:
            im2col_w = im2col_words_2d if kind == "conv2d" else im2col_words_1d
            pre_read = im2col_w(pre_read.reshape(B, *in_shape), kernel, stride)
            pre_read = pre_read.reshape(-1, pre_read.shape[-1])          # (M, K)
            post_read = post_read.reshape(-1, s_out.shape[-1])           # (M, C)
        else:
            im2col = im2col_2d if kind == "conv2d" else im2col_1d
            rows = pre_read.shape[0]
            pre_read = im2col(pre_read.reshape(rows * B, *in_shape), kernel, stride)
            pre_read = pre_read.reshape(rows, -1, pre_read.shape[-1])    # (rows, M, K)
            post_read = post_read.to(torch.float32).reshape(rows, -1, s_out.shape[-1])
        pre_patches = patches.reshape(-1, patches.shape[-1])          # (M, K)
        post_spikes = s_out.reshape(-1, s_out.shape[-1])              # (M, C)
        kw = dict(depth=self.depth, pairing=self.pairing, compensate=self.compensate,
                  po2=self.po2, table=self.table)
        if self.sparse:
            return rule.sparse_patch_delta(pre_patches, post_spikes, pre_read, post_read,
                                           self.stdp, max_events=self.max_events, **kw)
        return rule.patch_delta(pre_patches, post_spikes, pre_read, post_read, self.stdp,
                                packed=packed, use_kernel=self.use_kernel,
                                interpret=self.interpret, **kw)

    # -- session serialization (the serving layer's per-user state) -----

    def words_per_neuron(self) -> int:
        """Resident uint8 words per neuron of the serialized timing state."""
        return self.rule.words_per_neuron()

    def init_words(self, n: int, *, batch: tuple[int, ...] = ()
                   ) -> tuple[torch.Tensor, ...]:
        """Serialized fresh timing state for a population of ``n``."""
        return self.session_words(
            self.rule.init_state(n, self.depth, batch=batch, device=self.device))

    def session_words(self, state: Any) -> tuple[torch.Tensor, ...]:
        """Canonical ``(*lanes, n)`` uint8 word planes of a timing state."""
        return self.rule.to_words(state)

    def session_state(self, words: tuple[torch.Tensor, ...]) -> Any:
        """Rebuild a timing state whose continued trajectory bit-matches the
        state :meth:`session_words` serialized."""
        return self.rule.from_words_state(words, depth=self.depth)


def make_plan(cfg: Any, device: torch.device | str | None = None) -> UpdatePlan:
    """Resolve a config into an :class:`UpdatePlan` on ``device``.

    Duck-typed over ``EngineConfig`` and ``SNNConfig``: compensation resolves
    through ``effective_compensate()`` where the config has it, else its
    ``compensate`` property, and the clip window (``w_min``/``w_max``)
    defaults to the SNN's fixed [0, 1].  Cached per (config, the rule
    registered under its name now, device): a config is a frozen dataclass,
    a plan (its po2 tensors included) is never mutated, so every caller may
    share it, and a rule re-registered with other fields (mstdp's
    ``reward``) gets a plan of its own.
    """
    return _plan(cfg, cfg.learning_rule(), torch.device("cpu" if device is None else device))


@functools.lru_cache(maxsize=64)
@eager
def _plan(cfg: Any, rule: LearningRule, device: torch.device) -> UpdatePlan:
    use_kernel, interpret = resolve_rule_backend(rule, cfg.backend)
    if hasattr(cfg, "effective_compensate"):
        compensate = cfg.effective_compensate()
    else:
        compensate = cfg.compensate
    return UpdatePlan(
        rule=rule,
        backend=cfg.backend,
        use_kernel=use_kernel,
        interpret=interpret,
        sparse=cfg.backend == "sparse",
        packed=cfg.use_packed_history(),
        depth=cfg.depth,
        pairing=cfg.pairing,
        compensate=compensate,
        stdp=cfg.stdp,
        eta=cfg.eta,
        w_min=getattr(cfg, "w_min", 0.0),
        w_max=getattr(cfg, "w_max", 1.0),
        max_events=cfg.max_events,
        device=device,
        po2=po2_vectors(cfg.stdp, cfg.depth, compensate=compensate, device=device),
        table=rule.read_table(cfg.stdp, cfg.depth, device=device),
    )


def apply_update(cfg: Any, w: torch.Tensor, pre_spikes: torch.Tensor,
                 post_spikes: torch.Tensor, pre_state: Any,
                 post_state: Any) -> torch.Tensor:
    """One-shot convenience: :func:`make_plan` + :meth:`UpdatePlan.update`."""
    return make_plan(cfg, w.device).update(w, pre_spikes, post_spikes,
                                           pre_state, post_state)
