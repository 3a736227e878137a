"""Faults planted in the program's timed path, to show that the comparison
catches them (``tests/test_port_bench_faults.py``) and to read the upper
limits of its numbers on the card (``readings.py``).

  * ``unchanged``: a step that returns its state unchanged;
  * ``half_batch``: half of the batch left out, the rest counted double: in
    training the plan's batch-summed Δw, frozen the synaptic currents;
  * ``altered``: an answer altered where it is produced: in training one
    weight moved one grid step as it is quantised, frozen one spike count.

Each is a context manager that patches the program and puts it back.
"""
from __future__ import annotations

import contextlib

import torch


def _half_timing(t, batch: int):
    """The first half of the batch's rows of a flat timing state."""
    if isinstance(t, torch.Tensor):
        return t[: t.shape[-1] // batch * (batch // 2)]
    n = t.planes.shape[-1] // batch
    return t._replace(planes=t.planes[..., : n * (batch // 2)])


@contextlib.contextmanager
def unchanged():
    from repro_torch.models import snn

    step = snn.snn_step

    def stale(state, spikes_in, cfg, *, train=True):
        _, s = step(state, spikes_in, cfg, train=train)
        return state, s

    snn.snn_step = stale
    try:
        yield
    finally:
        snn.snn_step = step


@contextlib.contextmanager
def half_batch(train: bool):
    from repro_torch.models import snn
    from repro_torch.plasticity.apply import UpdatePlan

    fc, conv, product = UpdatePlan.fc_delta, UpdatePlan.conv_delta, snn.synaptic_product

    def half_fc(self, pre_state, post_state, s_in, s_out):
        B = s_in.shape[0]
        return 2.0 * fc(self, _half_timing(pre_state, B), _half_timing(post_state, B),
                        s_in[: B // 2], s_out[: B // 2])

    def half_conv(self, pre_state, post_state, patches, s_out, **kw):
        B = s_out.shape[0]
        return 2.0 * conv(self, _half_timing(pre_state, B), _half_timing(post_state, B),
                          patches[: B // 2], s_out[: B // 2], **kw)

    def half_product(patches, w):
        B = patches.shape[0]
        top = product(patches[: B // 2], w)
        return torch.cat([top, top[: B - B // 2]])

    if train:
        UpdatePlan.fc_delta, UpdatePlan.conv_delta = half_fc, half_conv
    else:
        snn.synaptic_product = half_product
    try:
        yield
    finally:
        UpdatePlan.fc_delta, UpdatePlan.conv_delta = fc, conv
        snn.synaptic_product = product


@contextlib.contextmanager
def altered(train: bool):
    from repro_torch.models import snn

    quantise, run = snn._quantise, snn.run_snn

    def moved(w, cfg):
        w = quantise(w, cfg).clone()
        w[0, 0] += 1.0 / ((1 << (cfg.w_bits - 1)) - 1)
        return w

    def miscounted(*args, **kwargs):
        state, counts = run(*args, **kwargs)
        counts = counts.clone()
        counts[0, 0] += 1.0
        return state, counts

    if train:
        snn._quantise = moved
    else:
        snn.run_snn = miscounted
    try:
        yield
    finally:
        snn._quantise, snn.run_snn = quantise, run


def plant(name: str, train: bool):
    """The fault ``name`` for a training (``train``) or a frozen cell."""
    if name == "unchanged":
        return unchanged()
    if name == "half_batch":
        return half_batch(train)
    if name == "altered":
        return altered(train)
    raise ValueError(f"no fault {name!r}")


FAULTS = ("unchanged", "half_batch", "altered")
