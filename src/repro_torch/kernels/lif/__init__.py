"""Fused LIF neuron update: CUDA kernel, plain version, ops wrapper."""
