"""The LM family's comparison that decides ``correct``: what the timed
training step produced, against the plain reference (``reference/lm.py``).

Two parts (``PERF.md`` §2 says why):

  * the first three steps, which set-up runs through the window's call from
    the seed's weights, are followed by the reference from the same weights
    on the same batches, on its own trajectory;
  * the step recorded after the window is checked from the program's own
    state: the reference's loss at the program's parameters, and the
    reference's ITP-AdamW applied to the program's own gradients and state.
    (Its gradient is not compared: after the window's sign-like ITP-AdamW
    steps a unit's bfloat16 gradient norm departs from float32 by up to
    0.43 on sound runs, as far as the float8 control's, so no limit holds.)

Numbers compared (each against its limit in ``limits/<cell>.json``); a
"unit" is one layer's slice of a stacked leaf, or a leaf outside the
blocks:

  * ``loss_gap``: the largest relative gap of a step's loss, over the three
    followed steps and the step after the window;
  * ``grad_gap``: at the first step, the worst unit's gap between the norm
    of the gradient as the optimizer got it, worked out from its first
    moment after the step (``mu / (1 - beta1)``: the clipped gradient), and
    the reference's, over the reference's norm of that unit or of the median
    unit, whichever is larger;
  * ``change_gap``: the worst unit's gap, measured alike, between the norms
    of the parameters' change over the first three steps, leaving out units
    whose reference gradient at the first step is under a thousandth of the
    median unit's (round-off alone moves those under Adam);
  * ``update_mismatches``: elements of the parameters, moments and step
    after the first step and after the step after the window that differ
    from the reference's ITP-AdamW on the program's own gradients and state,
    bit for bit; plus a step counter that does not count the steps run, a
    unit that the window left unmoved, and each recorded step in which
    ``loss_and_grads`` or ``adamw_update`` did not run.
"""
from __future__ import annotations

import math
import statistics

import torch

from port_bench import lm_inputs
from port_bench.reference import lm as ref

NUMBERS = ("loss_gap", "grad_gap", "change_gap", "update_mismatches")
FOLLOWED = 3          # set-up's steps, which the reference follows from the seed
QUIET = 1e-3          # a unit whose gradient is under this share of the median's


def unit_norms(tree, device, minus=None) -> list[float]:
    """The float32 norm of each unit of ``tree`` (less ``minus``, a tree
    alike), in sorted key order, each leaf moved to ``device`` in turn."""
    others = ref.leaves(minus) if minus is not None else None
    out = []
    for i, (path, leaf) in enumerate(lm_inputs.paths(tree)):
        x = leaf.to(device, torch.float32)
        if others is not None:
            x = x - others[i].to(device, torch.float32)
        rows = x.reshape(x.shape[0], -1) if path.startswith("blocks.") else x.reshape(1, -1)
        out.extend(torch.linalg.vector_norm(rows, dim=1).tolist())
    return out


def norm_gap(got: list[float], want: list[float], keep: list[bool] | None = None) -> float:
    """The worst unit's ``|got - want|`` over ``max(want, median of want)``."""
    floor = statistics.median(want)
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        if keep is not None and not keep[i]:
            continue
        den = max(w, floor)
        gap = abs(g - w) / den if den > 0 else (0.0 if g == w else math.inf)
        worst = max(worst, gap)
    return worst


def _rel(got: float, want: float) -> float:
    if not math.isfinite(got):
        return math.inf
    return abs(got - want) / abs(want) if want else abs(got)


def mismatches(got: dict, want: dict, device) -> int:
    """Elements of ``got``'s params, mu and nu, and its step, that differ
    from ``want``'s bit for bit (each leaf moved to ``device`` in turn)."""
    n = int(not torch.equal(got["step"].to(device), want["step"].to(device)))
    for key in ("params", "mu", "nu"):
        g_leaves, w_leaves = ref.leaves(got[key]), ref.leaves(want[key])
        if len(g_leaves) != len(w_leaves):
            return n + max(sum(w.numel() for w in w_leaves), 1)
        for g, w in zip(g_leaves, w_leaves):
            g = g.to(device)
            if g.shape != w.shape or g.dtype != w.dtype:
                n += w.numel()
            else:
                n += int((g.view(torch.int32) != w.view(torch.int32)).sum()
                         if g.dtype == torch.float32 else (g != w).sum())
    return n


def check(cfg: dict, traffic: dict, records: dict, pool: list, seed: int,
          device: torch.device) -> dict:
    """The numbers of one run from the recorder's ``records`` (the family's
    ``families/lm.py`` says what they hold)."""
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
        params, state = ref.itp_adamw(opt, before["params"], post["grads"],
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
    p0 = lm_inputs.initial_params(cfg, seed, device)
    params, state = p0, ref.fresh_state(p0, device)
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
                p1, s1 = ref.itp_adamw(opt, p0, _on(records["grads1"], device),
                                       ref.fresh_state(p0, device))
                out["update_mismatches"] += mismatches(records["after1"],
                                                       {"params": p1, **s1}, device)
                del p1, s1
        params, state = ref.itp_adamw(opt, params, g, state)
        del g
        if k == 0:
            out["grad_gap"] = norm_gap(unit_norms(records["after1"]["mu"], device),
                                       unit_norms(state["mu"], device))
        out["steps_checked"] += 1
    out["change_gap"] = norm_gap(unit_norms(records["params3"], device, minus=p0),
                                 unit_norms(params, device, minus=p0), keep)
    return out


def _on(tree, device):
    return ref.unflatten(tree, [x.to(device) for x in ref.leaves(tree)])


def verdict(numbers: dict, limits: dict) -> bool:
    """Correct when every number compared is at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
