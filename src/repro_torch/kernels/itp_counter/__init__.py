"""Fused counter-rule (explicit-Δt STDP) update and conv delta: CUDA kernels,
plain versions, ops wrappers."""
