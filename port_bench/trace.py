"""The traced run: a steady stretch of whole batches under ``torch.profiler``,
reduced to what the per-layer metrics read.

The benchmark places its own spans around the calls into the program's
layers (the program has none yet): ``port_bench.run_snn`` around each
``run_snn`` call, ``port_bench.update`` around the plan's ``fc_delta`` and
``conv_delta``, and ``port_bench.window`` around the whole stretch, which
ends on a synchronisation.  It also reads the launch counters
(``<wrapper>.launches``) of the kernel wrappers over the stretch.  The LM
family (``families/lm.py``) profiles whole training steps into the same
:class:`Trace` through :func:`events`, with no spans or counters of its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib

import torch

# the update kernels' wrapper modules, whose ``<wrapper>.launches`` are read
KERNEL_MODULES = ("repro_torch.kernels.itp_stdp.kernel",
                  "repro_torch.kernels.itp_stdp_conv.kernel",
                  "repro_torch.kernels.itp_counter.kernel")
# a CUDA runtime call that lasts longer waits for the device (a full launch
# queue or a synchronisation); a launch alone takes a few microseconds
BLOCKED_CALL_US = 50.0


def launch_counters() -> dict:
    """``{"module.wrapper": launches}`` of every kernel wrapper."""
    out = {}
    for name in KERNEL_MODULES:
        mod = importlib.import_module(name)
        for attr in dir(mod):
            launches = getattr(getattr(mod, attr), "launches", None)
            if isinstance(launches, int):
                out[f"{name.rsplit('.', 2)[-2]}.{attr}"] = launches
    return out


@dataclasses.dataclass
class Trace:
    """What the per-layer metrics read from one traced stretch."""

    cfg: dict
    traffic: dict
    batches: int
    steps: int                       # simulation steps in the stretch
    window: tuple[float, float]      # host µs, start and end of the stretch
    device: list                     # [(start µs, end µs, name)] device events
    run_spans: list                  # [(start µs, end µs)] port_bench.run_snn
    update_device_us: float          # device time launched inside port_bench.update
    runtime: list                    # [(start µs, end µs, name)] CUDA runtime calls
    host_ops: list                   # [(start µs, end µs, name)] other host events
    launches: dict                   # launches of each wrapper over the stretch

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device events' intervals inside the stretch."""
        lo, hi = self.window
        merged: list[list[float]] = []
        for s, e, _ in sorted(self.device):
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def breakdown(self, n: int = 10) -> dict:
        """The ``n`` device operations that took most time, and the ``n``
        longest idle gaps, each named by the innermost host event open when
        it began."""
        per_op: dict[str, float] = {}
        for s, e, name in self.device:
            per_op[name] = per_op.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:n]
        lo, hi = self.window
        edges = [lo] + [x for iv in self.busy_intervals() for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges) - 1, 2)), reverse=True)[:n]
        idle = [[self._host_at(start), dur / 1e6] for dur, start in gaps if dur > 0]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle}

    def _host_at(self, t: float) -> str:
        """The innermost host event open at ``t``, else the last one that
        ended before it (the host then runs Python between operations)."""
        inside, before = None, None
        for s, e, name in self.host_ops + self.runtime:
            if s <= t < e and (inside is None or s >= inside[0]):
                inside = (s, name)
            elif e <= t and (before is None or e > before[0]):
                before = (e, name)
        if inside:
            return inside[1]
        return f"python after {before[1]}" if before else "python before the first event"


def _launched_in_update(prof) -> float:
    """Device µs of the kernels launched inside a ``port_bench.update`` span:
    each device event names, by its linked correlation id, the host
    operation that launched it, and that operation's start must lie inside
    a span (read from the profiler's raw events, which every PyTorch 2
    release keeps)."""
    import bisect

    DeviceType = torch.autograd.DeviceType
    raw = prof.profiler.kineto_results.events()
    started, spans = {}, []
    for k in raw:
        # host operations (runtime calls carry a link of their own)
        if k.device_type() == DeviceType.CPU and k.linked_correlation_id() == 0:
            started[k.correlation_id()] = k.start_ns()
            if k.name() == "port_bench.update":
                spans.append((k.start_ns(), k.start_ns() + k.duration_ns()))
    spans.sort()
    starts = [s for s, _ in spans]
    total_ns = 0
    for k in raw:
        if k.device_type() != DeviceType.CUDA or k.name().startswith("port_bench."):
            continue
        t = started.get(k.linked_correlation_id())
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= spans[i][1]:
            total_ns += k.duration_ns()
    return total_ns / 1e3


@contextlib.contextmanager
def _spans():
    """The benchmark's spans around the program's run and update calls."""
    from repro_torch.models import snn
    from repro_torch.plasticity.apply import UpdatePlan

    run, fc, conv = snn.run_snn, UpdatePlan.fc_delta, UpdatePlan.conv_delta

    def spanned(name, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return call

    snn.run_snn = spanned("port_bench.run_snn", run)
    UpdatePlan.fc_delta = spanned("port_bench.update", fc)
    UpdatePlan.conv_delta = spanned("port_bench.update", conv)
    try:
        yield
    finally:
        snn.run_snn, UpdatePlan.fc_delta, UpdatePlan.conv_delta = run, fc, conv


def capture(net, pool: list, first: int, batches: int, cfg: dict, traffic: dict,
            keep: dict, device: torch.device) -> Trace:
    """Profile ``batches`` whole batches from pool index ``first`` on; the
    counts of the batches named in ``keep`` are kept there."""
    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    before = launch_counters()
    with _spans(), profile(activities=activities) as prof:
        with torch.profiler.record_function("port_bench.window"):
            for i in range(batches):
                counts = net.run_batch(pool[(first + i) % len(pool)])
                if i in keep:
                    keep[i] = counts
            if cuda:
                torch.cuda.synchronize(device)
    after = launch_counters()
    update_launched = _launched_in_update(prof)
    split = events(prof)
    return Trace(cfg=cfg, traffic=traffic, batches=batches,
                 steps=batches * traffic["t_steps"], update_device_us=update_launched,
                 launches={k: after[k] - before.get(k, 0) for k in after}, **split)


def events(prof) -> dict:
    """A profiled stretch's events as :class:`Trace` keeps them: the
    ``port_bench.window`` span, the device operations (user annotations and
    the benchmark's own spans left out), the benchmark's ``run_snn`` spans,
    the CUDA runtime calls and the other host events."""
    DeviceType = torch.autograd.DeviceType
    device, runtime, host_ops, run_spans = [], [], [], []
    window = None
    for evt in prof.events():
        s, e = evt.time_range.start, evt.time_range.end
        if evt.device_type == DeviceType.CUDA:
            if not (getattr(evt, "is_user_annotation", False)
                    or evt.name.startswith("port_bench.")):
                device.append((s, e, evt.name))
            continue
        if evt.name == "port_bench.window":
            window = (s, e)
        elif evt.name == "port_bench.run_snn":
            run_spans.append((s, e))
        elif evt.name.startswith("cuda"):
            runtime.append((s, e, evt.name))
        elif evt.name != "port_bench.update":
            host_ops.append((s, e, evt.name))
    return {"window": window, "device": device, "run_spans": run_spans,
            "runtime": runtime, "host_ops": host_ops}
