"""The LM training step's share of the card's bfloat16 peak: the step's model
FLOPs (``counts.lm_step_flops``: 6 per matrix weight and token, plus causal
attention, counted from the configuration's shapes whatever implements
them) over the traced stretch's time a step × 989.4 TFLOP/s, in %; nothing
for a stretch with no device operations (a run off the card)."""
from port_bench import counts


def read(tr):
    if not tr.device or not tr.steps or tr.window_s <= 0:
        return None
    step_s = tr.window_s / tr.steps
    return 100.0 * counts.lm_step_flops(tr.cfg, tr.traffic) / step_s / counts.BF16_OPS_PER_S
