"""Quickstart on the PyTorch port: the paper's 4×4 prototype ITP-STDP
learning engine (the twin of ``examples/quickstart.py``).

Builds the prototype engine (§III-B, Table V row 1), drives it with a
Poisson spike train, and demonstrates the paper's two core claims:

  1. intrinsic timing — the weight update is read directly off the
     spike-history register (no Δt computation, no exponential);
  2. compensation — with τ' = τ·ln2 the po2 rule is numerically identical
     to exact base-e STDP.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]   # default cuda
"""
import argparse

import torch

from repro_torch.core.drift import DriftParams, update_curve_rmse
from repro_torch.core.engine import EngineConfig, init_engine, run_engine
from repro_torch.core.history import init_history, push, registers_depth_major
from repro_torch.core.stdp import magnitudes_depth_major
from repro_torch.device import resolve_device


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator().manual_seed(args.seed)

    # --- 1. the 4×4 prototype engine ---------------------------------------
    cfg = EngineConfig(n_pre=4, n_post=4, depth=7, pairing="nearest")
    w0 = torch.rand((4, 4), generator=gen) * 0.6 + 0.2
    state = init_engine(cfg, w0, device=device)
    print("prototype engine: 4 pre × 4 post, history depth 7, 8-bit weights")
    print("initial weights:\n", state.w)

    train = (torch.rand((200, 4), generator=gen) < 0.35).float()   # 200-step Poisson raster
    state, post_spikes = run_engine(state, train, cfg)
    print(f"\nafter 200 steps: {int(post_spikes.sum())} postsynaptic spikes")
    print("learned weights:\n", state.w)

    # --- 2. 'reading the register IS the update' ----------------------------
    hist = init_history(4, depth=7, device=device)
    for row in ([1, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]):
        hist = push(hist, torch.tensor(row, dtype=torch.uint8, device=device))
    regs = registers_depth_major(hist)
    print("\nspike-history registers (k=0 row = most recent):\n", regs)
    mags = magnitudes_depth_major(regs, 1.0, 4.0, pairing="nearest")
    print("Δw magnitudes read straight off the registers:", mags)
    print("  (= A·2^(-k*/τ') where k* is each neuron's most recent spike)")

    # --- 3. the compensation equivalence (eq. 18) ----------------------------
    p = DriftParams()
    print("\nupdate-curve RMSE vs exact STDP:")
    print(f"  ITP w/o compensation: {update_curve_rmse(p, device=device):.6f}  "
          f"(paper: 0.094753)")
    print(f"  ITP with τ·ln2 comp.: {update_curve_rmse(p, 'exact', 'itp', device=device):.2e}"
          f"  (paper: exactly 0)")

    # --- 4. pluggable learning rules (EngineConfig.rule) ---------------------
    # The same engine runs the conventional counter-based exact-STDP baseline
    # (per-pair Δt + base-e exponential — what the paper optimises away) by
    # swapping the rule; compensated ITP reproduces its trajectory exactly.
    # The full registry (itp, itp_nocomp, exact, linear, imstdp) is also on
    # the CLI:  python -m repro_torch.launch.train --engine --rule exact
    cfg_exact = EngineConfig(n_pre=4, n_post=4, depth=7, rule="exact")
    state_exact, _ = run_engine(init_engine(cfg_exact, w0, device=device), train, cfg_exact)
    state_itp, _ = run_engine(init_engine(cfg, w0, device=device), train, cfg)
    drift = float((state_exact.w - state_itp.w).abs().max())
    print(f"\nrule='exact' (counter Δt baseline) vs rule='itp': "
          f"max |Δw| = {drift:.2e}  (identical trajectories — eq. 18 at the "
          f"engine level)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
