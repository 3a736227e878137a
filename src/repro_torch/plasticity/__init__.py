"""Pluggable learning rules and the update dispatch layer (port of
``repro.plasticity``): ``make_plan`` / ``UpdatePlan`` / ``apply_update``
own backend resolution and packed-readout selection; rules register by
name.  Registered: ``itp``, ``itp_nocomp`` (intrinsic timing), ``exact``,
``linear``, ``imstdp`` (the counter baselines) and ``mstdp`` (reward
modulated).  A new rule subclasses :class:`Rank1Rule` (five slim methods,
every backend inherited) or :class:`LearningRule` and calls
:func:`register_rule`."""

from repro_torch.plasticity.apply import UpdatePlan, apply_update, make_plan
from repro_torch.plasticity.base import (
    BACKENDS,
    RULES,
    LearningRule,
    Rank1Rule,
    get_rule,
    kernel_rule_names,
    register_rule,
    resolve_rule_backend,
    rule_names,
    sparse_rule_names,
    validate_update_config,
)
from repro_torch.plasticity.mstdp import MSTDP, MSTDPRule, MSTDPState
from repro_torch.plasticity.rules import (EXACT, IMSTDP, ITP, ITP_NOCOMP, LINEAR,
                                         CounterRule, HistoryRule)
