"""The comparison that decides ``correct``: what the recorded steps of the
timed call produced, against the plain reference.

The reference follows the program step by step from the program's own
state (``PERF.md`` says why): a float32 product sums its inputs in another
order than any plain product, so a neuron at its threshold may fire on one
side and not on the other, and a trajectory followed over many steps
departs for that reason alone.  So each recorded step is checked alone,
layer by layer: the reference steps the program's state before the step
and compares what it gets with the program's state after it.  A layer's
input spikes are the spikes the program's layer below produced, once they
are judged.  The start is checked by itself: the program's state before
the first step against the reference's own fresh state from the seed's
weights, as is the reset between batches.  A batch recorded after the
window starts from the window's end state: that state must be reset
dynamics with θ kept, and weights on the grid.

Numbers compared (each against its limit in ``limits/<cell>.json``):

  * ``v_gap``: the largest membrane gap between the program and the
    reference over the neurons whose spike agrees, each relative to the
    reference's value plus the span from reset to threshold (one rounding
    of a membrane driven far below threshold by inhibition is not a gap
    that moves a spike); a spike that differs counts as its distance from
    the threshold on the reference's side, relative alike (the least gap
    that can have moved it).
  * ``dw_gap``: the largest gap of the batch-summed Δw the plan returned
    against the reference's, over the largest reference Δw of the layer.
  * ``w_gap``: the largest gap of the clipped, quantised weights against
    the reference's from the program's own Δw, in steps of the weight grid.
  * ``mismatches``: state that must agree bit for bit and does not:
    history bits and counters, reset values, θ, frozen weights, the spike
    counts against the spikes recorded, and a rerun's counts against the
    window's.
"""
from __future__ import annotations

import math

import torch

from port_bench.reference import snn as ref

NUMBERS = ("v_gap", "dw_gap", "w_gap", "mismatches")


def _on(d, device):
    if d is None:
        return None
    if isinstance(d, dict):
        return {k: _on(v, device) for k, v in d.items()}
    if isinstance(d, list):
        return [_on(v, device) for v in d]
    return d.to(device)


def _count(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    return int((a != b).sum())


def _state_mismatches(got: dict, want: dict) -> int:
    """Bits of a state that differ from ``want`` (weights, θ, neurons and
    timing state alike)."""
    n = sum(_count(g, w) for g, w in zip(got["w"], want["w"]))
    for g, w in zip(got["layers"], want["layers"]):
        if g is None or w is None:
            n += int((g is None) != (w is None))
            continue
        n += sum(_count(g[k], w[k]) for k in w)
    return n


def check_step(cfg: dict, rule: str, train: bool, x: torch.Tensor, before: dict,
               after: dict, dws: list) -> dict:
    """The numbers of one recorded step ``before → after`` on input ``x``
    ``(B, features)``, with the Δw per learnable layer the plan returned."""
    out = dict.fromkeys(NUMBERS, 0.0)
    out["mismatches"] = 0
    depth = cfg["depth"]
    B = x.shape[0]
    s = x.reshape(B, *cfg["input_shape"])
    scale = ref.threshold_scale(cfg)
    levels = (1 << (cfg["w_bits"] - 1)) - 1
    wi = 0
    for spec, l0, l1 in zip(cfg["layers"], before["layers"], after["layers"]):
        if spec["kind"].startswith("pool"):
            s = ref.or_pool(spec, s)
            continue
        # the layer's input history: this step's input shifted in
        out["mismatches"] += _count(l1["pre"], ref.record(rule, l0["pre"], s, depth))
        res = ref.layer_forward(cfg, rule, spec, before["w"][wi], l0, s)
        fired = ref.newest(rule, l1["post"]).reshape(res["spikes"].shape)
        flips = fired != res["spikes"]
        gaps = [((res["v_pre"] - res["v_th"]).abs() / (scale + res["v_pre"].abs()))[flips]]
        agree = ~flips
        for name, value in res["state"].items():
            gaps.append(((l1[name] - value).abs() / (scale + value.abs()))[agree])
        gaps = torch.cat([g.reshape(-1) for g in gaps])
        if gaps.numel():
            out["v_gap"] = max(out["v_gap"], float(gaps.max()))
        # the output history: the program's spikes shifted in
        out["mismatches"] += _count(l1["post"], ref.record(rule, l0["post"], fired, depth))
        out["mismatches"] += _count(l1["theta"], l0["theta"])
        if train:
            if wi >= len(dws):
                out["mismatches"] += 1
                out["dw_gap"] = math.inf
            else:
                dw = ref.delta(cfg, rule, spec, l0, res["patches"], fired, tuple(s.shape[1:]))
                top = float(dw.abs().max())
                gap = float((dws[wi] - dw).abs().max()) if dws[wi].shape == dw.shape else math.inf
                out["dw_gap"] = max(out["dw_gap"], gap / top if top > 0 else
                                    (0.0 if gap == 0 else math.inf))
                P = res["patches"].shape[1]
                want = ref.apply_delta(cfg, before["w"][wi], dws[wi], float(B * P))
                out["w_gap"] = max(out["w_gap"],
                                   float((after["w"][wi] - want).abs().max()) * levels)
        else:
            out["mismatches"] += _count(after["w"][wi], before["w"][wi])
        s = fired
        wi += 1
    return out


def _counts_from(cfg: dict, last: list, batch: int) -> torch.Tensor:
    """Spike counts of the net's output from the last learnable layer's
    spikes at every step, through any pooling after it."""
    tail = []
    for spec in reversed(cfg["layers"]):
        if not spec["kind"].startswith("pool"):
            break
        tail.insert(0, spec)
    shapes = ref.layer_shapes(cfg)
    out_shape = shapes[len(cfg["layers"]) - len(tail) - 1]
    total = None
    for spikes in last:
        s = spikes.reshape(batch, *out_shape)
        for spec in tail:
            s = ref.or_pool(spec, s)
        s = s.reshape(batch, -1).to(torch.float32)
        total = s if total is None else total + s
    return total


def check(cfg: dict, rule: str, train: bool, batches: list, pool: list,
          weights: list, device: torch.device) -> dict:
    """The numbers of a run: every recorded step of every recorded batch,
    the start, the resets and the counts.  ``batches`` are the recorder's,
    each with the ``counts`` the call returned (and, for a rerun, the
    window's ``window_counts``); ``weights`` are the seed's initial ones."""
    out = dict.fromkeys(NUMBERS, 0.0)
    out["mismatches"] = 0
    out["steps_checked"] = 0
    batch = pool[0].shape[1]
    weights = [w.to(device) for w in weights]
    for bi, rec in enumerate(batches):
        raster = pool[rec["raster"]].to(device)
        steps = rec["steps"]
        if bi == 0 and 0 in steps:
            start = ref.fresh_state(cfg, rule, batch, weights)
            out["mismatches"] += _state_mismatches(_on(steps[0][0], device), start)
        if (bi > 0 and rec["follows"] and 0 in steps
                and raster.shape[0] - 1 in batches[bi - 1]["steps"]):
            end = _on(batches[bi - 1]["steps"][raster.shape[0] - 1][1], device)
            want = ref.reset(cfg, rule, end, batch) if train else ref.fresh_state(
                cfg, rule, batch, end["w"])
            out["mismatches"] += _state_mismatches(_on(steps[0][0], device), want)
        if bi > 0 and not rec["follows"] and 0 in steps:
            # the window's end state: reset, and every weight on the grid
            start = _on(steps[0][0], device)
            out["mismatches"] += _state_mismatches(start, ref.reset(cfg, rule, start, batch))
            out["mismatches"] += sum(_count(w, ref.apply_delta(cfg, w, torch.zeros_like(w), 1.0))
                                     for w in start["w"])
        for t, (before, after, dws) in sorted(steps.items()):
            got = check_step(cfg, rule, train, raster[t], _on(before, device),
                             _on(after, device), _on(dws, device))
            for k in NUMBERS:
                out[k] = out[k] + got[k] if k == "mismatches" else max(out[k], got[k])
            out["steps_checked"] += 1
        if len(rec["last"]) != raster.shape[0]:
            out["mismatches"] += 1
        else:
            counts = _counts_from(cfg, [s.to(device) for s in rec["last"]], batch)
            out["mismatches"] += _count(rec["counts"].to(device), counts)
        if rec.get("window_counts") is not None:
            out["mismatches"] += _count(rec["window_counts"].to(device),
                                        rec["counts"].to(device))
    if not train:
        out["mismatches"] += sum(_count(b["steps"][t][1]["w"][i].to(device), w)
                                 for b in batches for t in b["steps"]
                                 for i, w in enumerate(weights))
    return out


def verdict(numbers: dict, limits: dict) -> bool:
    """Correct when every number compared is at or under its limit."""
    return all(numbers[k] <= limits[k] for k in limits)
