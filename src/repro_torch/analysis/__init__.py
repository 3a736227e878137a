"""Static analysis of the port (port of ``repro.analysis``'s traced layer).

:mod:`repro_torch.analysis.graph_audit` traces every valid rule × backend ×
layer-kind cell of the matrix and checks the graphs against the paper's
dataflow contracts, as ``repro.analysis.jaxpr_audit`` does for the JAX
package.  The lint rules (``repro.analysis.astlint``, ``importgraph``,
``doclint``) scan the whole repository and stay with the JAX package.
"""
from repro_torch.analysis.graph_audit import (FLOAT64_ALLOWLIST, KINDS, audit_cell,
                                              run_audit, valid_cells)

__all__ = ["FLOAT64_ALLOWLIST", "KINDS", "audit_cell", "run_audit", "valid_cells"]
