"""The program's own spans in a traced stretch.

The port marks its layers with ``repro_torch.`` ranges while a profiler
runs (``src/repro_torch/spans.py``; the SNN's are ``repro_torch.snn.run``,
``reset``, ``step``, ``product``, ``neurons``, ``update`` and ``timing``).
:func:`read` gives ``{span name: {"calls", "device_us", "device_ops"}}``:
how often each ran, and the device time and the number of device operations
(kernels, memsets, copies) launched inside it, those of the spans it
encloses included.

``trace.Trace`` keeps the device operations and the host's calls, but not
the ids that link them.  So each operation is paired with the host call that
launched it by order: the program runs on one stream, which starts its
operations in the order they were launched, and an operation is put down to
the spans open when its call began, on the host's clock alone (the device's
clock, as the profiler maps it, can lie milliseconds off the host's: 2.75
ms on an H100).  The pairing runs back from the stretch's end, which a
synchronisation closes: the profiler can miss the device records of the
first launches after it starts (two of 5,865 on an H100), and those calls
are left unpaired.  A stretch with fewer launching calls than device
operations gives None.
"""
from __future__ import annotations

import bisect
import itertools

PREFIX = "repro_torch."
# host calls that put one operation on a stream: the runtime's, and the
# driver's that a Triton kernel launches through
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cudaLaunchKernelExC", "cudaMemsetAsync",
                          "cudaMemcpyAsync", "cuLaunchKernel", "cuLaunchKernelEx"})


def launches(tr) -> list[tuple[float, float]] | None:
    """``[(host µs at which the launching call began, device µs)]`` of every
    device operation, or None where the stretch holds fewer launching calls
    than device operations."""
    calls = sorted(s for s, _, name in tr.runtime + tr.host_ops if name in LAUNCH_CALLS)
    ops = sorted((s, e) for s, e, _ in tr.device)
    if len(calls) < len(ops):
        return None
    return [(c, e - s) for c, (s, e) in zip(calls[len(calls) - len(ops):], ops)]


def attribute(spans, launched) -> dict:
    """``{name: {"calls", "device_us", "device_ops"}}`` over ``spans``
    (``[(start µs, end µs, name)]``, nested or not) from ``launched``
    (``[(host µs, device µs)]``): a launch at a span's start or end counts
    in it.  Prefix sums over the launches in time order, two searches a
    span."""
    launched = sorted(launched)
    times = [t for t, _ in launched]
    total = [0.0, *itertools.accumulate(d for _, d in launched)]
    out: dict = {}
    for s, e, name in spans:
        lo, hi = bisect.bisect_left(times, s), bisect.bisect_right(times, e)
        row = out.setdefault(name, {"calls": 0, "device_us": 0.0, "device_ops": 0})
        row["calls"] += 1
        row["device_us"] += total[hi] - total[lo]
        row["device_ops"] += hi - lo
    return out


def read(tr) -> dict:
    """The program's spans of the stretch ``tr`` (``trace.Trace``); empty for
    a program without spans."""
    spans = [x for x in tr.host_ops if x[2].startswith(PREFIX)]
    launched = launches(tr)
    out = attribute(spans, launched or [])
    if launched is None:
        for row in out.values():
            row.update(device_us=None, device_ops=None)
    return out


def per_step(tr, name: str, field: str = "device_us") -> float | None:
    """Span ``name``'s ``field`` a simulation step of the stretch, or None
    where the stretch holds no device operations or no such span."""
    if not tr.device or not tr.steps:
        return None
    value = read(tr).get(name, {}).get(field)
    return None if value is None else value / tr.steps
