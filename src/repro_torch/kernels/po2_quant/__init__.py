"""Power-of-two (de)quantisation: CUDA encode/decode kernels, plain versions,
shape-generic ops."""
