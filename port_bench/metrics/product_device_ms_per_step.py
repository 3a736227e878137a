"""Device milliseconds a simulation step launched inside the program's
``repro_torch.snn.product`` spans (each learnable layer's patches, activity
mean, synaptic product, gain and lateral inhibition;
``port_bench/program_spans.py``)."""
from port_bench import program_spans


def read(tr):
    us = program_spans.per_step(tr, "repro_torch.snn.product")
    return None if us is None else us / 1e3
