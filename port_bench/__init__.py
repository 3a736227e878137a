"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``): the harness
(``run.py``), which runs each cell through the driver of its
configuration's family (``families/``: the SNNs, the LM training step),
their inputs, plain references and comparisons that decide ``correct``,
the frozen counts and the per-layer metric readers.  Nothing here imports
``jax`` or the JAX package."""
