"""Device milliseconds a simulation step launched inside the program's
``repro_torch.snn.neurons`` spans (each learnable layer's LIF or Izhikevich
step, hard WTA and the spikes' cast; ``port_bench/program_spans.py``)."""
from port_bench import program_spans


def read(tr):
    us = program_spans.per_step(tr, "repro_torch.snn.neurons")
    return None if us is None else us / 1e3
