"""Data front end of the port: synthetic datasets and the spike pipeline."""
from repro_torch.data.pipeline import Prefetcher, encode_batch, spike_stream
from repro_torch.data.synthetic import synthetic_digits, synthetic_fashion, synthetic_fault

__all__ = ["Prefetcher", "encode_batch", "spike_stream", "synthetic_digits",
           "synthetic_fashion", "synthetic_fault"]
