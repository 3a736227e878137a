"""Device operations (kernels, memsets, copies) a simulation step launched
inside the program's ``repro_torch.snn.step`` spans, the whole net's step
(``port_bench/program_spans.py``)."""
from port_bench import program_spans


def read(tr):
    return program_spans.per_step(tr, "repro_torch.snn.step", "device_ops")
