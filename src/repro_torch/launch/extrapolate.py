"""Layer-calibrated cost extrapolation (port of ``repro.launch.extrapolate``).

For homogeneous layer stacks the per-device cost is linear in the layer
count,

    F(L) = F_out + L · F_body,

so two runs at FULL width on the FULL mesh with L=2 and L=4 layers
identify (F_out, F_body) and the full-depth cost follows.  Heterogeneous
stacks solve a small linear system per layer type (hymba: sliding-window
and global bodies; llama-vision: periods of self layers and one cross
layer).

The reference needs this because XLA's cost analysis counts a scanned
layer body once; the port's forward is a Python loop, so its direct count
(``launch.dryrun.run_plan``) is already exact and extrapolation only saves
time on deep models.  The tests hold it against the direct count.
"""
from __future__ import annotations

import dataclasses
import functools
import time

from repro_torch.launch.dryrun import run_plan
from repro_torch.launch.specs import plan_cell
from repro_torch.train.train_step import TrainConfig

# metrics we extrapolate linearly in L
_COST_KEYS = ("flops", "bytes accessed", "transcendentals")


def _measure(cfg, shape, mesh, count_collectives=None, train_cfg=None,
             kv_dtype: str = "bfloat16") -> dict:
    """Run (cfg, shape)'s plan on fake tensors and return flat costs.
    ``count_collectives`` is accepted for the reference's signature;
    :func:`run_plan` applies it."""
    base = train_cfg or TrainConfig()
    plan = plan_cell(cfg, shape, mesh, train_cfg=dataclasses.replace(base, unroll=True),
                     kv_dtype=kv_dtype)
    run = run_plan(plan, mesh)
    out = {k: float(run["cost"].get(k, 0.0)) for k in _COST_KEYS}
    coll = run["collectives"]
    out["coll_operand"] = coll["total_operand_bytes"]
    out["coll_wire"] = coll["total_wire_bytes"]
    for kind, v in coll.items():
        if isinstance(v, dict):
            out[f"coll_{kind}"] = v["operand_bytes"]
    return out


def _lin(m2: dict, m4: dict, l2: int, l4: int, L: int) -> dict:
    """Solve F = F_out + L·F_body from measurements at l2 < l4 layers."""
    out = {}
    for k in m2:
        body = (m4[k] - m2[k]) / (l4 - l2)
        base = m2[k] - l2 * body
        out[k] = max(base + L * body, 0.0)
    return out


def _reduced(cfg, n_layers: int, **kw):
    return dataclasses.replace(cfg, n_layers=n_layers, **kw)


def extrapolate_cell(cfg, shape, mesh, count_collectives=None, verbose: bool = False,
                     train_cfg=None, kv_dtype: str = "bfloat16") -> dict:
    """Extrapolated full-depth per-device costs for one dry-run cell."""
    _m = functools.partial(_measure, count_collectives=count_collectives,
                           train_cfg=train_cfg, kv_dtype=kv_dtype)
    t0 = time.time()
    fam = cfg.family
    if fam == "hybrid":
        # bodies: sliding-window (swa) and global-attention layers
        swa2 = _m(_reduced(cfg, 2, global_layers=()), shape, mesh)
        swa4 = _m(_reduced(cfg, 4, global_layers=()), shape, mesh)
        mix2 = _m(_reduced(cfg, 2, global_layers=(0,)), shape, mesh)
        n_glb = len(cfg.global_layers)
        n_swa = cfg.n_layers - n_glb
        est = {}
        for k in swa2:
            body_swa = (swa4[k] - swa2[k]) / 2.0
            base = swa2[k] - 2 * body_swa
            body_glb = mix2[k] - base - body_swa
            est[k] = max(base + n_swa * body_swa + n_glb * body_glb, 0.0)
    elif fam == "vlm":
        n_cross = len(cfg.cross_attn_layers)
        period = cfg.n_layers // n_cross
        one = _m(_reduced(cfg, period, cross_attn_layers=(period - 2,)), shape, mesh)
        two = _m(_reduced(cfg, 2 * period, cross_attn_layers=(period - 2, 2 * period - 2)),
                 shape, mesh)
        est = _lin(one, two, 1, 2, n_cross)
    else:
        m2 = _m(_reduced(cfg, 2), shape, mesh)
        m4 = _m(_reduced(cfg, 4), shape, mesh)
        est = _lin(m2, m4, 2, 4, cfg.n_layers)
    est["extrapolation_seconds"] = round(time.time() - t0, 1)
    if verbose:
        print(f"    extrapolated in {est['extrapolation_seconds']}s: "
              f"flops={est['flops']:.3e} coll={est['coll_operand']:.3e}B")
    return est
