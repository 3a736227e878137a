"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): the harness
(``run.py``), its inputs, the plain reference, the comparison that decides
``correct``, the frozen counts and the per-layer metric readers.  Nothing
here imports ``jax`` or the JAX package."""
