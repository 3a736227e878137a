"""Serving launcher: ``python -m repro_torch.launch.serve [...]``.

Brings up the online-plasticity :class:`repro_torch.serve.Server` on
``--device`` (default ``cuda``), submits a synthetic per-session spike-raster
load (each session is one user's private network, learning continually via
the selected rule × backend), and reports the drain throughput and the
session-memory numbers: bytes per session and sessions per GiB.

``--ckpt-dir`` restores the latest checkpoint of the session store on start
and saves the store on exit, so the learned per-user state survives a
restart (the reference's format: either package's launcher restores it).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.launch.cli import (add_serve_flags, add_update_flags,
                                    engine_config_from_args, serve_config_from_args)
from repro_torch.serve import Request, Server


def synthetic_load(generator: torch.Generator, *, sessions: int, requests: int,
                   t_steps: int, n_pre: int, rate: float = 0.3) -> list[Request]:
    """A deterministic request stream over ``sessions`` round-robin users."""
    reqs = []
    for i in range(requests):
        raster = (torch.rand((t_steps, n_pre), generator=generator) < rate)
        reqs.append(Request(sid=f"user{i % sessions}",
                            raster=raster.numpy().astype(np.float32)))
    return reqs


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_serve_flags(ap)
    add_update_flags(ap)
    ap.add_argument("--sessions", type=int, default=8,
                    help="distinct synthetic users in the load")
    ap.add_argument("--requests", type=int, default=32,
                    help="total requests submitted")
    ap.add_argument("--rate", type=float, default=0.3,
                    help="per-step input spike probability of the load")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the latest checkpoint on start, save on exit")
    args = ap.parse_args(argv)

    cfg = engine_config_from_args(args)
    scfg = serve_config_from_args(args)
    server = Server(cfg, scfg, seed=args.seed, device=args.device)
    dev = server.store.device
    if args.ckpt_dir:
        try:
            server.restore(args.ckpt_dir)
            print(f"restored {len(server.store)} sessions from {args.ckpt_dir}")
        except FileNotFoundError:
            print(f"no checkpoint under {args.ckpt_dir}; starting fresh")
    reqs = synthetic_load(torch.Generator().manual_seed(args.seed + 1),
                          sessions=args.sessions, requests=args.requests,
                          t_steps=scfg.t_steps, n_pre=cfg.n_pre, rate=args.rate)
    tickets = [server.submit(r) for r in reqs]

    # the first batch builds the kernels and warms the allocator: timed apart
    t0 = time.perf_counter()
    first = server.step()
    warm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    served = server.shutdown(drain=True)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0

    done = sum(server.poll(t) is not None for t in tickets)
    store = server.store
    steps = served * scfg.t_steps
    print(f"served {done}/{args.requests} requests ({args.sessions} sessions, "
          f"rule={cfg.rule}, backend={cfg.backend}, device={dev})")
    print(f"  first batch ({first} lanes, build + warm-up): {warm_s * 1e3:.1f} ms; "
          f"drain: {served} lanes / {steps} sim-steps in {dt:.3f}s "
          f"({served / max(dt, 1e-9):.1f} requests/s, {steps / max(dt, 1e-9):.0f} steps/s)")
    print(f"  plasticity cache: {store.state_bytes_per_session()} B/session "
          f"({store.sessions_per_gb():.0f} sessions/GiB); resident "
          f"{store.resident_bytes_per_session()} B/session "
          f"({store.sessions_per_gb(resident=True):.0f} sessions/GiB)")
    if args.ckpt_dir:
        path = server.checkpoint(args.ckpt_dir)
        print(f"  checkpointed {len(store)} sessions -> {path}")


if __name__ == "__main__":
    main()
