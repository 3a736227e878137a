"""The system under test, as the benchmark drives it: the port's SNN
(``repro_torch.models.snn``) built from a configuration file, and the
recorder that copies its state around chosen simulation steps for the
comparison with the reference.

The window's call is the trainer's per-batch loop
(``repro_torch/train/stdp_trainer.py``): for training ``run_snn(train=True)``
then ``reset_dynamics``; frozen, ``reset_dynamics`` then
``run_snn(train=False)``, as ``_collect_counts`` runs it.

:class:`ReferenceNet` is the control: the plain reference put in the
program's place, with the same call and the same recorder.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from port_bench.reference import snn as ref


def program_config(cfg: dict, rule: str):
    """The program's ``SNNConfig`` for a configuration file and a rule."""
    from repro_torch.core.lif import IzhikevichParams, LIFParams
    from repro_torch.core.stdp import STDPParams
    from repro_torch.models.snn import SNNConfig, SNNLayerSpec

    return SNNConfig(
        name=cfg["net"], input_shape=tuple(cfg["input_shape"]),
        layers=tuple(SNNLayerSpec(**spec) for spec in cfg["layers"]),
        neuron=cfg["neuron"], rule=rule, depth=cfg["depth"], pairing=cfg["pairing"],
        eta=cfg["eta"], gain=cfg["gain"], izhi_gain=cfg["izhi_gain"],
        w_bits=cfg["w_bits"], quantise=cfg["quantise"], backend=cfg["backend"],
        packed_history=cfg["packed_history"], inhibition=cfg["inhibition"],
        hard_wta=cfg["hard_wta"], theta_plus=cfg["theta_plus"],
        theta_tau=cfg["theta_tau"], stdp=STDPParams(**cfg["stdp"]),
        lif=LIFParams(**cfg["lif"]), izhi=IzhikevichParams(**cfg["izhi"]))


@dataclasses.dataclass
class Recorder:
    """Which steps to copy: ``{batch index: set of step indices}``; a step
    is copied before and after, with the Δw the update returned.  Every step
    of a recorded batch also keeps the last layer's newest spikes."""

    wanted: dict
    batches: list = dataclasses.field(default_factory=list)
    seconds: float = 0.0             # time spent copying, left out of set-up

    def start_batch(self, raster_index: int, follows: bool) -> None:
        """A new recorded batch on pool raster ``raster_index``; ``follows``
        when it runs straight after the one recorded before it."""
        self.batches.append({"raster": raster_index, "follows": follows, "steps": {},
                             "last": [], "counts": None})
        self._t = 0

    def armed(self) -> bool:
        return self._t in self.wanted.get(len(self.batches) - 1, ())

    def timed(self, fn, *args):
        """``fn(*args)``, its time (after the device's queue) added to
        :attr:`seconds`."""
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds += time.perf_counter() - t0
        return out


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class ProgramNet:
    """The port's net on ``device``, stepped through the window's call."""

    def __init__(self, cfg: dict, traffic: dict, weights: list, device: torch.device):
        from repro_torch.models import snn

        self.snn = snn
        self.rule = traffic["rule"]
        self.train = traffic["mode"] == "train"
        self.batch = traffic["batch"]
        self.pcfg = program_config(cfg, self.rule)
        self.state = snn.init_snn(self.pcfg, self.batch, w_init=weights, device=device)
        if not self.train:
            self.state = snn.reset_dynamics(self.state, self.pcfg, self.batch)

    def run_batch(self, raster: torch.Tensor) -> torch.Tensor:
        """One batch through the window's call; returns the spike counts."""
        snn = self.snn
        if self.train:
            self.state, counts = snn.run_snn(self.state, raster, self.pcfg, train=True)
            self.state = snn.reset_dynamics(self.state, self.pcfg, self.batch)
        else:
            self.state = snn.reset_dynamics(self.state, self.pcfg, self.batch)
            self.state, counts = snn.run_snn(self.state, raster, self.pcfg, train=False)
        return counts

    # -- the recorder's view of the program's state ----------------------

    def _timing(self, t) -> torch.Tensor:
        """A timing state in the reference's layout, on the host: history
        rings as ``(depth, B·n)`` registers with row 0 the newest, counters
        as they are."""
        if isinstance(t, torch.Tensor):
            return _host(t)
        planes, head = t.planes, t.head
        depth = planes.shape[-2]
        slots = (head - torch.arange(depth, device=planes.device)) % depth
        return _host(planes[slots])

    def snapshot(self, state) -> dict:
        layers = []
        for lst in state.layers:
            if lst.neurons is None:
                layers.append(None)
                continue
            d = {name: _host(getattr(lst.neurons, name)) for name in lst.neurons._fields}
            d.update(pre=self._timing(lst.pre_hist), post=self._timing(lst.post_hist),
                     theta=_host(lst.theta))
            layers.append(d)
        return {"w": [_host(w) for w in state.weights], "layers": layers}

    def _last_spikes(self, state) -> torch.Tensor:
        last = [lst for lst in state.layers if lst.neurons is not None][-1]
        return ref.newest(self.rule, self._timing(last.post_hist))

    @contextlib.contextmanager
    def recording(self, recorder: Recorder):
        """Copy the chosen steps while the window's call runs: the program's
        ``snn_step`` and the plan's two Δw entry points are wrapped, and put
        back on exit."""
        from repro_torch.plasticity.apply import UpdatePlan

        snn = self.snn
        step, fc, conv = snn.snn_step, UpdatePlan.fc_delta, UpdatePlan.conv_delta
        dws: list = []

        def keep(fn):
            def kept(*args, **kwargs):
                dw = fn(*args, **kwargs)
                if recorder.armed():
                    dws.append(recorder.timed(_host, dw))
                return dw
            return kept

        def recorded_step(state, spikes_in, cfg, *, train=True):
            armed = recorder.armed()
            if armed:
                before = recorder.timed(self.snapshot, state)
                dws.clear()
            new, s = step(state, spikes_in, cfg, train=train)
            batch = recorder.batches[-1]
            if armed:
                batch["steps"][recorder._t] = (before, recorder.timed(self.snapshot, new),
                                               list(dws))
            batch["last"].append(recorder.timed(self._last_spikes, new))
            recorder._t += 1
            return new, s

        snn.snn_step = recorded_step
        UpdatePlan.fc_delta, UpdatePlan.conv_delta = keep(fc), keep(conv)
        try:
            yield
        finally:
            snn.snn_step = step
            UpdatePlan.fc_delta, UpdatePlan.conv_delta = fc, conv


class ReferenceNet:
    """The control: the plain reference in the program's place, its synaptic
    product at ``precision``, driven and recorded as :class:`ProgramNet` is."""

    def __init__(self, cfg: dict, traffic: dict, weights: list, device: torch.device,
                 precision: str = "tf32"):
        self.cfg, self.rule = cfg, traffic["rule"]
        self.train = traffic["mode"] == "train"
        self.batch = traffic["batch"]
        self.precision = precision
        self.state = ref.fresh_state(cfg, self.rule, self.batch, weights)
        self.recorder: Recorder | None = None

    def run_batch(self, raster: torch.Tensor) -> torch.Tensor:
        if not self.train:
            self.state = ref.reset(self.cfg, self.rule, self.state, self.batch)
        counts = None
        rec = self.recorder
        for t in range(raster.shape[0]):
            armed = rec is not None and rec.armed()
            before = _snapshot(self.state) if armed else None
            self.state, s, dws = ref.step(self.cfg, self.rule, self.state, raster[t],
                                          train=self.train, precision=self.precision)
            s = s.reshape(self.batch, -1).to(torch.float32)
            counts = s if counts is None else counts + s
            if rec is not None:
                batch = rec.batches[-1]
                if armed:
                    batch["steps"][rec._t] = (before, _snapshot(self.state),
                                              [_host(d) for d in dws])
                last = [lst for lst in self.state["layers"] if lst is not None][-1]
                batch["last"].append(_host(ref.newest(self.rule, last["post"])))
                rec._t += 1
        if self.train:
            self.state = ref.reset(self.cfg, self.rule, self.state, self.batch)
        return counts

    @contextlib.contextmanager
    def recording(self, recorder: Recorder):
        self.recorder = recorder
        try:
            yield
        finally:
            self.recorder = None


def _snapshot(state: dict) -> dict:
    return {"w": [_host(w) for w in state["w"]],
            "layers": [None if lst is None else {k: _host(v) for k, v in lst.items()}
                       for lst in state["layers"]]}
