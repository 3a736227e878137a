"""The whole step's share of the card's float32 peak: the step's counted
operations (``counts.step_ops``: synaptic products and, in training, the Δw
contractions, counted from shapes whatever implements them) over the traced
stretch's time a step × 67 TFLOP/s, in %."""
from port_bench import counts


def read(tr):
    if not tr.steps or tr.window_s <= 0:
        return None
    step_s = tr.window_s / tr.steps
    return 100.0 * counts.step_ops(tr.cfg, tr.traffic) / step_s / counts.FP32_OPS_PER_S
