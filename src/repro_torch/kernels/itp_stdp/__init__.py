"""Fused ITP-STDP dense update: CUDA kernel, plain version, ops wrappers."""
