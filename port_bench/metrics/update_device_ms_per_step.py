"""Device milliseconds a simulation step launched inside the program's
``repro_torch.snn.update`` spans (each learnable layer's plan and its
``fc_delta`` / ``conv_delta``, training only; ``port_bench/program_spans.py``)."""
from port_bench import program_spans


def read(tr):
    us = program_spans.per_step(tr, "repro_torch.snn.update")
    return None if us is None else us / 1e3
