"""Online-plasticity serving: per-user SNNs whose resident state is the
paper's packed uint8 register word (port of ``repro.serve``).

Entry point: ``python -m repro_torch.launch.serve``.
"""

from repro_torch.serve.serving import Request, Result, ServeConfig, Server, serve_step
from repro_torch.serve.session import SessionState, SessionStore
