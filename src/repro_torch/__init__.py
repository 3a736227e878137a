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

Importing the package sets ``CUBLAS_WORKSPACE_CONFIG`` to ``:4096:8`` unless
the environment already sets it.  cuBLAS reads the setting at the process's
first cuBLAS call, and PyTorch's deterministic mode, which the LM training
step runs under (:func:`repro_torch.device.deterministic`), refuses cuBLAS
without it.  ``:4096:8`` is PyTorch's own default workspace on ``sm_90``, so
on the H100 nothing else changes.
"""
import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
