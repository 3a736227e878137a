"""Per-layer metrics, one module each, found by the metric's name in
``BENCHMARK.json``.  Each has ``read(trace) -> float | None``: the value
from a traced stretch (``port_bench.trace.Trace``), or None where the
stretch holds nothing to read, and the harness then leaves it out."""
