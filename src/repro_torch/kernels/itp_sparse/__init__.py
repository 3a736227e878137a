"""Event-driven sparse weight-update datapath (``backend="sparse"``; port of
``repro.kernels.itp_sparse``).

Static-shape spike-event lists (``events``) gate gather/scatter updates of
only the touched weight slices (``ops``).  The reference has no Pallas
kernel here (its datapath is XLA gather/scatter), so the port is torch index
ops; the conv delta runs the conv kernel (kernel 4) on the gathered rows.
"""

from repro_torch.kernels.itp_sparse.events import event_cap, spike_events, word_events
from repro_torch.kernels.itp_sparse.ops import (sparse_conv_delta, sparse_synapse_delta,
                                                sparse_weight_update)
