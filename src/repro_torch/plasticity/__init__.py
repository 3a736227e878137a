"""Pluggable learning rules and the update dispatch layer (port of
``repro.plasticity``): ``make_plan`` / ``UpdatePlan`` / ``apply_update``
own backend resolution and packed-readout selection; rules register by
name.  Ported: ``itp`` and ``itp_nocomp``."""

from repro_torch.plasticity.apply import UpdatePlan, apply_update, make_plan
from repro_torch.plasticity.base import (
    BACKENDS,
    RULES,
    UNPORTED_BACKENDS,
    UNPORTED_RULES,
    LearningRule,
    get_rule,
    kernel_rule_names,
    register_rule,
    resolve_rule_backend,
    rule_names,
    validate_update_config,
)
from repro_torch.plasticity.rules import ITP, ITP_NOCOMP, HistoryRule
