"""Distributed-training pieces of the port (``repro_torch.distributed``)."""
