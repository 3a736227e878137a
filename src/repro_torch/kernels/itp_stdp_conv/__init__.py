"""Patch-level (im2col) ITP-STDP conv delta: CUDA kernel, plain version, ops wrappers."""
