"""LLSMU approximate multiplier: CUDA kernel, plain version, ops wrapper."""
