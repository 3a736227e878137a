"""Data front end of the port: synthetic datasets, LM token streams and the
spike pipeline."""
from repro_torch.data.pipeline import Prefetcher, encode_batch, spike_stream
from repro_torch.data.synthetic import (LMBatchSpec, host_shard, lm_batches, synthetic_digits,
                                        synthetic_fashion, synthetic_fault, zipf_tokens)

__all__ = ["LMBatchSpec", "Prefetcher", "encode_batch", "host_shard", "lm_batches",
           "spike_stream", "synthetic_digits", "synthetic_fashion", "synthetic_fault",
           "zipf_tokens"]
