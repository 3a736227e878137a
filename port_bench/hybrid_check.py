"""The hybrid family's comparison that decides ``correct``: the LM family's
(``lm_check.py``: the same four numbers, the same two parts, the same
rules), with the Granite reference (``reference/granite.py``) for the loss
and the gradients and the hybrid family's weights from the seed.  A "unit"
is one layer's slice of a leaf of either stack (``mamba_blocks``,
``attn_blocks``), or a leaf outside them.
"""
from __future__ import annotations

import statistics

import torch

from port_bench import hybrid_inputs, lm_inputs
from port_bench.lm_check import FOLLOWED, NUMBERS, QUIET, _on, _rel, mismatches, norm_gap
from port_bench.reference import granite as ref
from port_bench.reference import lm as ref_lm

STACKS = ("mamba_blocks.", "attn_blocks.")


def unit_norms(tree, device, minus=None) -> list[float]:
    """The float32 norm of each unit of ``tree`` (less ``minus``, a tree
    alike), in sorted key order, each leaf moved to ``device`` in turn."""
    others = ref_lm.leaves(minus) if minus is not None else None
    out = []
    for i, (path, leaf) in enumerate(lm_inputs.paths(tree)):
        x = leaf.to(device, torch.float32)
        if others is not None:
            x = x - others[i].to(device, torch.float32)
        rows = x.reshape(x.shape[0], -1) if path.startswith(STACKS) else x.reshape(1, -1)
        out.extend(torch.linalg.vector_norm(rows, dim=1).tolist())
    return out


def check(cfg: dict, traffic: dict, records: dict, pool: list, seed: int,
          device: torch.device) -> dict:
    """The numbers of one run from the recorder's ``records``
    (``families/hybrid.py``)."""
    opt = cfg["assumed"]["optimizer"]
    z = cfg["assumed"]["z_loss"]
    out = dict.fromkeys(NUMBERS, 0.0)
    out["update_mismatches"] = 0
    out["steps_checked"] = 0

    # ---- the step after the window, from the program's own state ---------
    post = records.pop("post")
    before = post["before"]
    out["update_mismatches"] += int(int(before["step"]) != post["steps_before"])
    out["loss_gap"] = _rel(post["loss"],
                           ref.loss(before["params"], cfg, pool[post["index"]], z))
    if post["called"]:
        params, state = ref_lm.itp_adamw(opt, before["params"], post["grads"],
                                         {k: before[k] for k in ("step", "mu", "nu")})
        out["update_mismatches"] += mismatches(post["after"], {"params": params, **state},
                                               device)
        del params, state
    else:
        out["update_mismatches"] += 1
    moved = unit_norms(before["params"], device, minus=records["params3"])
    out["steps_checked"] += 1
    del post, before
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the first three steps, followed from the seed --------------------
    p0 = hybrid_inputs.initial_params(cfg, seed, device)
    params, state = p0, ref_lm.fresh_state(p0, device)
    keep = None
    for k, rec in enumerate(records["setup"][:FOLLOWED]):
        loss_ref, g = ref.loss_and_grads(params, cfg, pool[k], z)
        if not rec["called"]:
            out["update_mismatches"] += 1
        out["loss_gap"] = max(out["loss_gap"], _rel(rec["loss"], loss_ref))
        if k == 0:
            g_norms = unit_norms(g, device)
            floor = statistics.median(g_norms)
            keep = [n >= QUIET * floor for n in g_norms]
            # the window moved every unit that the gradient moves
            out["update_mismatches"] += sum(1 for m, q in zip(moved, keep) if q and m == 0)
            # the start and the first update: the reference's ITP-AdamW from
            # the seed's state on the program's own first gradient
            if records["grads1"] is not None:
                p1, s1 = ref_lm.itp_adamw(opt, p0, _on(records["grads1"], device),
                                          ref_lm.fresh_state(p0, device))
                out["update_mismatches"] += mismatches(records["after1"],
                                                       {"params": p1, **s1}, device)
                del p1, s1
        params, state = ref_lm.itp_adamw(opt, params, g, state)
        del g
        if k == 0:
            out["grad_gap"] = norm_gap(unit_norms(records["after1"]["mu"], device),
                                       unit_norms(state["mu"], device))
        out["steps_checked"] += 1
    out["change_gap"] = norm_gap(unit_norms(records["params3"], device, minus=p0),
                                 unit_norms(params, device, minus=p0), keep)
    return out
