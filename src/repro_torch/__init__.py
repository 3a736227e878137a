"""PyTorch/CUDA port of the ITP-STDP learning engine (``repro`` is the JAX
reference it is held against).

The package mirrors ``repro`` module for module: ``repro_torch.core.history``
is the counterpart of ``repro.core.history`` and so on.  It imports
``torch`` only — never ``jax`` and nothing of ``repro`` — and its entry
points (:class:`repro_torch.serve.Server`, :class:`~repro_torch.serve.
SessionStore`, :func:`repro_torch.core.engine.init_engine`, ``python -m
repro_torch.launch.serve``) run on ``cuda`` unless the caller passes
``device="cpu"``.  The dense fused ITP-STDP update is a CUDA C++ kernel for
``sm_90a`` (``csrc/itp_stdp.cu``), built at first use by
:mod:`repro_torch.kernels._build`.
"""
