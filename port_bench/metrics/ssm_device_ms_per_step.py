"""Device milliseconds a training step launched inside the program's
``repro_torch.lm.ssm`` spans (each Mamba-2 mixer: its projections, conv,
SSD scan, gated norm and out projection; ``port_bench/program_spans.py``).
Under ``remat="full"`` that is each mixer's forward and its recompute in
the backward: autograd's backward kernels run outside the spans."""
from port_bench import program_spans


def read(tr):
    us = program_spans.per_step(tr, "repro_torch.lm.ssm")
    return None if us is None else us / 1e3
