"""Device milliseconds a simulation step launched inside the program's
``repro_torch.snn.timing`` spans (each learnable layer's two pushes of its
timing state, the rule's ``step``; ``port_bench/program_spans.py``)."""
from port_bench import program_spans


def read(tr):
    us = program_spans.per_step(tr, "repro_torch.snn.timing")
    return None if us is None else us / 1e3
