"""Host milliseconds a simulation step: the benchmark's span around each
``run_snn`` call, less the time the host spent blocked in CUDA runtime calls
(a call longer than ``trace.BLOCKED_CALL_US`` waits for the device), over the
stretch's steps."""
from port_bench.trace import BLOCKED_CALL_US


def read(tr):
    if not tr.run_spans or not tr.steps:
        return None
    waits = [(s, e) for s, e, _ in tr.runtime if e - s > BLOCKED_CALL_US]
    host_us = 0.0
    for s, e in tr.run_spans:
        blocked = sum(min(we, e) - max(ws, s) for ws, we in waits if ws < e and we > s)
        host_us += (e - s) - blocked
    return host_us / 1e3 / tr.steps
