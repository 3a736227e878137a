"""The update's share of its roofline: the least time of the update's
required work (``counts.update_bound_s``: each input read once, the
batch-summed ``(K, C)`` Δw written once, 4·M·K·C operations plus a counter
rule's windows, over 3.35 TB/s and 67 TFLOP/s) over the device time of the
kernels launched inside the benchmark's span around the plan's
``fc_delta`` / ``conv_delta``, in %."""
from port_bench import counts


def read(tr):
    if tr.traffic["mode"] != "train" or tr.update_device_us <= 0:
        return None
    bound_s = counts.update_bound_s(tr.cfg, tr.traffic) * tr.steps
    return 100.0 * bound_s / (tr.update_device_us / 1e6)
