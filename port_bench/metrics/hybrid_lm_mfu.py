"""The hybrid stack's training step's share of the card's bfloat16 peak:
the step's model FLOPs (``hybrid_counts.step_flops``: 6 per matrix weight
and token, the tied head once, causal attention's 6·S·H·hd per token and
attention layer, 3× the SSD scan's operations per token and Mamba layer,
counted from the configuration's shapes) over the traced stretch's time a
step × 989.4 TFLOP/s, in %; nothing for a stretch with no device
operations."""
from port_bench import counts, hybrid_counts


def read(tr):
    if not tr.device or not tr.steps or tr.window_s <= 0:
        return None
    step_s = tr.window_s / tr.steps
    return 100.0 * hybrid_counts.step_flops(tr.cfg, tr.traffic) / step_s / counts.BF16_OPS_PER_S
