"""The SSD scan's share of its roofline: the least time of the scan's
required work (``hybrid_counts.scan_bound_s``: its inputs read and its
output written once over 3.35 TB/s, against the chunked form's operations
over the 989.4 TFLOP/s dense bf16 peak, the larger of the two) times the
calls of the program's ``repro_torch.lm.ssd_scan`` span, over the device
time launched inside those calls, in %; nothing where the stretch has no
device operations or no such span."""
from port_bench import hybrid_counts, program_spans


def read(tr):
    if not tr.device:
        return None
    row = program_spans.read(tr).get("repro_torch.lm.ssd_scan")
    if not row or not row["device_us"]:
        return None
    bound_s = hybrid_counts.scan_bound_s(tr.cfg, tr.traffic) * row["calls"]
    return 100.0 * bound_s / (row["device_us"] / 1e6)
