"""Training launcher: ``python -m repro_torch.launch.train [--arch A | --snn NET | --engine]``.

With neither ``--snn`` nor ``--engine`` it runs the LM mode (ROADMAP item
18c): a synthetic-token LM run of ``--arch`` (``--smoke``: its reduced
config) on ``--device`` (default ``cuda``) with the reference's control loop:
``--steps`` train steps of ``--batch`` × ``--seq`` Zipf tokens
(``data.lm_batches``, each step's batch keyed by its step number), AdamW or
ITP-AdamW (``--po2-update``: the po2 encode/decode kernels on every leaf
every step), ``--remat`` activation checkpointing, a checkpoint every
``--ckpt-every`` steps into ``--ckpt-dir`` and restart-on-failure with
replay (``distributed.fault_tolerance.TrainingRunner``; ``--inject-failure-at``
fails one step once), a straggler watchdog, a log line every
``--log-every`` steps and a ``done: ...`` line.  ``--data D --model M``
(ROADMAP item 18d) trains on a ``data × model`` mesh, one rank per process:
inside a torchrun world (``RANK``/``WORLD_SIZE`` set) it joins that world;
with ``D·M == 1`` it runs a one-rank group in this process; otherwise it
spawns ``D·M`` local processes over a ``FileStore`` (gloo on the CPU, NCCL
with one rank per card on CUDA: more ranks than cards is refused).  Rank 0
prints ``mesh: data=D × model=M`` and the log, and :func:`main` returns its
summary.  The state is sharded by the reference's rules and gathered on use
(``train.train_step``).

``--snn <net>`` trains one of the paper's networks (2-layer SNN, 6-layer DCSNN, 5-layer
CSNN) with unsupervised STDP on ``--device`` (default ``cuda``), through the
shared train-to-accuracy loop of ``repro_torch.train.stdp_trainer`` and the
shared flag builders of ``repro_torch.launch.cli``: epochs of rate-coded
stand-in data, a label-assignment evaluation after each, and one summary
line with the synaptic-update throughput (SOP/s) and the accuracy.  With
``--backend fused`` the conv layers run the im2col conv kernel and the fc
layer the dense kernel.

``--engine`` trains a population of learning-engine replicas instead
(``--replicas`` × ``--engine-pre`` × ``--engine-post``, ``--steps`` steps of
Bernoulli rasters at ``--engine-rate``) on the selected rule and backend and
reports the synaptic-op throughput: on ``--backend fused`` every step's
update of all replicas is one launch of the dense kernel.
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import os
import tempfile
import time
import types

import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_NAMES, get_config, get_smoke_config
from repro_torch.core.engine import (EngineConfig, init_engine_population,
                                     run_engine_population)
from repro_torch.data import LMBatchSpec, lm_batches
from repro_torch.device import resolve_device
from repro_torch.distributed.fault_tolerance import (FailureInjector, RunnerConfig,
                                                     TrainingRunner)
from repro_torch.distributed.sharding import batch_axes, init_process_group
from repro_torch.launch import cli
from repro_torch.launch.mesh import describe, make_debug_mesh
from repro_torch.models import snn
from repro_torch.train import OptimizerConfig, TrainConfig, init_training, make_train_step
from repro_torch.train.stdp_trainer import train_to_accuracy


def synaptic_updates_per_step(cfg: snn.SNNConfig, batch: int) -> int:
    """Synapse updates per simulation step: every learnable layer touches its
    full ``(fan_in × out)`` matrix once per patch row."""
    updates = 0
    shapes = [tuple(cfg.input_shape)] + snn._layer_shapes(cfg)
    for spec, in_shape, out_shape in zip(cfg.layers, shapes[:-1], shapes[1:]):
        if spec.kind.startswith("pool"):
            continue
        updates += (batch * math.prod(out_shape[:-1]) * snn._fan_in(spec, in_shape)
                    * spec.out_features)
    return updates


def engine_training(args) -> tuple[dict, object, torch.Tensor]:
    """Population engine training on the selected rule and backend; returns
    ``(summary, final states, post rasters (R, T, n_post))``.

    The weights and the rasters are drawn on the host from one
    ``torch.Generator`` seeded by ``--seed`` (default 0).  The rollout runs
    twice from the same initial state: the first run loads the kernels'
    libraries (building them if the build directory lacks them) and warms
    the allocator, and its wall time is the summary's ``compile_seconds``
    (the reference's key; there is no trace to compile here); the second
    run is timed as ``run_seconds``.  Both end in a device synchronisation.
    """
    dev = resolve_device(getattr(args, "device", "cuda"))
    rule = getattr(args, "rule", "itp")
    steps = getattr(args, "steps", None) or 100
    cfg = EngineConfig(n_pre=args.engine_pre, n_post=args.engine_post, rule=rule,
                       backend=args.backend, max_events=getattr(args, "max_events", None))
    gen = torch.Generator().manual_seed(getattr(args, "seed", None) or 0)
    states0 = init_engine_population(cfg, args.replicas, generator=gen, device=dev)
    trains = (torch.rand((args.replicas, steps, cfg.n_pre), generator=gen)
              < args.engine_rate).to(torch.float32).to(dev)

    def run():
        t0 = time.perf_counter()
        out = run_engine_population(states0, trains, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    _, compile_s = run()
    (states, post), run_s = run()
    sops = args.replicas * steps * cfg.n_pre * cfg.n_post
    summary = {
        "rule": rule, "backend": args.backend, "device": str(dev),
        "replicas": args.replicas, "n_pre": cfg.n_pre, "n_post": cfg.n_post,
        "steps": steps,
        "compile_seconds": round(compile_s, 3),
        "run_seconds": round(run_s, 4),
        "sops_per_s": sops / max(run_s, 1e-9),
        "mean_post_rate": float(post.to(torch.float32).mean()),
    }
    print(f"engine training [{rule} / {args.backend} / {dev}]: {args.replicas} replicas × "
          f"{cfg.n_pre}×{cfg.n_post} × {steps} steps — {summary['sops_per_s']:.3e} SOP/s "
          f"(build + warm-up {compile_s:.2f}s, run {run_s:.3f}s, "
          f"mean post rate {summary['mean_post_rate']:.3f})", flush=True)
    return summary, states, post


def run_engine_training(args) -> dict:
    """The ``--engine`` mode: :func:`engine_training`'s summary (also printed)."""
    return engine_training(args)[0]


def run_snn_training(args) -> dict:
    """One of the paper's SNNs trained to accuracy on the selected rule and
    backend; returns the summary dict (also printed)."""
    net = cli.net_from_args(args)
    cfg = cli.snn_config_from_args(args, net=net)
    tcfg = cli.trainer_config_from_args(args)
    sampler, n_classes = cli.sampler_for(net)
    result = train_to_accuracy(cfg, sampler, n_classes, tcfg, verbose=True,
                               device=getattr(args, "device", "cuda"))
    run_s = result["train_seconds"]
    updates = synaptic_updates_per_step(cfg, tcfg.batch)
    summary = {
        "net": cfg.name, "rule": cfg.rule, "backend": cfg.backend,
        "device": str(result["state"].weights[0].device),
        "batch": tcfg.batch,
        "steps": result["sim_steps"],
        "epochs": tcfg.epochs,
        "run_seconds": round(run_s, 4),
        "sops_per_s": result["sim_steps"] * updates / max(run_s, 1e-9),
        "mean_rate": result["mean_eval_rates"][-1],
        "accuracy_curve": result["accuracy_curve"],
        "final_accuracy": result["final_accuracy"],
        "chance": result["chance"],
    }
    print(f"snn training [{cfg.name} / {cfg.rule} / {cfg.backend} / {summary['device']}]: "
          f"batch {tcfg.batch} × {result['sim_steps']} steps — "
          f"{summary['sops_per_s']:.3e} SOP/s (train {run_s:.2f}s incl. kernel build), "
          f"accuracy {summary['final_accuracy']:.3f} (chance {summary['chance']:.3f})",
          flush=True)
    return summary


def lm_training(args, mesh=None, device=None) -> tuple[dict, dict]:
    """The LM mode: ``(summary, final state {"params", "opt"})``.

    The model is drawn from a generator on the run's device seeded by
    ``--seed`` (default 0), step ``k``'s batch from one seeded by
    ``1000 + k`` (the reference's ``PRNGKey(1000 + step)``), so a replay
    after a restart trains on the same tokens.  ``tokens_per_s`` counts the
    ``--steps`` steps' tokens over the wall time of the whole loop,
    restarts and replays included.  With a ``mesh`` every rank draws the
    same model and batches and keeps its shards; rank 0 prints."""
    dev = resolve_device(args.device if device is None else device)
    verbose = mesh is None or dist.get_rank() == 0
    steps = args.steps or 100
    batch = args.batch or 8
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    opt_cfg = OptimizerConfig(lr=args.lr, total_steps=steps,
                              warmup_steps=max(steps // 20, 5), po2_update=args.po2_update)
    params, opt_state = init_training(torch.Generator(dev).manual_seed(args.seed or 0), cfg,
                                      opt_cfg, mesh=mesh, device=dev)
    step_fn = make_train_step(cfg, opt_cfg, TrainConfig(remat=args.remat), mesh)
    spec = LMBatchSpec(batch=batch, seq=args.seq, vocab=cfg.vocab_size)

    def batch_for(step: int) -> dict:
        return next(lm_batches(torch.Generator(dev).manual_seed(1000 + step), spec, n_steps=1))

    t0 = time.perf_counter()
    n_run = 0

    def logged_step(state, batch):
        nonlocal n_run
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        if verbose and n_run % args.log_every == 0:
            dt = time.perf_counter() - t0
            print(f"step {n_run:5d}  loss {float(metrics['loss']):.4f}  "
                  f"lr {float(metrics['lr']):.2e}  gnorm {float(metrics['grad_norm']):.3f}  "
                  f"({n_run / max(dt, 1e-9):.2f} it/s)", flush=True)
        n_run += 1
        return {"params": p, "opt": o}, metrics

    runner = TrainingRunner(RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
                            logged_step, batch_for)
    injector = (FailureInjector({args.inject_failure_at})
                if args.inject_failure_at >= 0 else None)
    state = runner.run({"params": params, "opt": opt_state}, steps, injector)
    wall = time.perf_counter() - t0
    losses = [r["loss"] for r in runner.log if "loss" in r]
    summary = {"arch": args.arch, "config": cfg.name, "device": str(dev), "steps": steps,
               "batch": batch, "seq": args.seq, "po2_update": args.po2_update,
               "remat": args.remat,
               "run_seconds": round(wall, 4), "tokens_per_s": steps * batch * args.seq / wall,
               "final_loss": losses[-1], "restarts": runner.restarts,
               "stragglers": len(runner.watchdog.stragglers)}
    if verbose:
        print(f"done: {steps} steps in {wall:.1f}s; restarts={runner.restarts}; "
              f"stragglers={summary['stragglers']}", flush=True)
    return summary, state


def run_lm_training(args) -> dict:
    """The LM mode: :func:`lm_training`'s summary (also printed)."""
    return lm_training(args)[0]


def _mesh_rank(args, rank: int, world: int, *, local_rank: int = 0, store=None,
               init_method: str | None = None) -> tuple[dict, dict]:
    """One rank of the LM mode on a ``--data × --model`` mesh: joins the
    group, trains, and leaves the group; ``(summary, final state gathered
    whole)``."""
    from repro_torch.distributed.sharding import gather_tree
    dev = torch.device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
    init_process_group(dev, rank=rank, world_size=world, init_method=init_method, store=store)
    try:
        mesh = make_debug_mesh(args.data, args.model, device=dev)
        if rank == 0:
            print(f"mesh: {describe(mesh)}", flush=True)
        summary, state = lm_training(args, mesh=mesh, device=dev)
        state = {"params": gather_tree(state["params"]),
                 "opt": type(state["opt"])(state["opt"].step, gather_tree(state["opt"].mu),
                                           gather_tree(state["opt"].nu))}
        return dict(summary, mesh=describe(mesh)), state
    finally:
        dist.destroy_process_group()


def _mesh_worker(arg_dict: dict, rank: int, world: int, store_path: str, out_path: str) -> None:
    """A spawned rank of :func:`mesh_lm_training`; rank 0 writes the summary."""
    if arg_dict["device"] == "cpu":      # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    summary, _ = _mesh_rank(argparse.Namespace(**arg_dict), rank, world, local_rank=rank,
                            store=dist.FileStore(store_path, world))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(summary, f)


def mesh_lm_training(args) -> tuple[dict, dict | None]:
    """The LM mode on a ``--data × --model`` mesh: ``(rank 0's summary, the
    final state gathered whole, or None when the ranks ran in spawned
    processes)``.  Refuses a batch the batch axes do not divide and, on
    CUDA, more ranks than cards."""
    world = args.data * args.model
    dev = resolve_device(args.device)
    shape = {"data": args.data, "model": args.model}
    n_batch = math.prod(shape[a] for a in batch_axes(
        types.SimpleNamespace(shape=shape, axis_names=tuple(shape))))
    if (args.batch or 8) % n_batch:
        raise ValueError(f"--batch {args.batch or 8} does not split over the batch axes "
                         f"({n_batch} ranks) of a data={args.data} × model={args.model} mesh")
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:     # inside torchrun
        if int(os.environ["WORLD_SIZE"]) != world:
            raise ValueError(f"a {args.data}x{args.model} mesh needs {world} ranks, the "
                             f"torchrun world has {os.environ['WORLD_SIZE']}")
        return _mesh_rank(args, int(os.environ["RANK"]), world, init_method="env://",
                          local_rank=int(os.environ.get("LOCAL_RANK", 0)))
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise ValueError(f"a {args.data}x{args.model} mesh needs {world} CUDA ranks, one per "
                         f"card, and this host has {torch.cuda.device_count()} (NCCL refuses "
                         f"two ranks on one card)")
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        if world == 1:
            return _mesh_rank(args, 0, 1, store=dist.FileStore(store_path, 1))
        out_path = os.path.join(tmp, "summary.json")
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_mesh_worker,
                             args=(vars(args), r, world, store_path, out_path))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        codes = [p.exitcode for p in procs]
        if codes != [0] * world:
            raise RuntimeError(f"mesh ranks exited with {codes}")
        with open(out_path) as f:
            return json.load(f), None


def build_parser() -> argparse.ArgumentParser:
    """The launcher's flags (every mode)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES, default="qwen3-0.6b",
                    help="LM architecture (LM mode)")
    ap.add_argument("--engine", action="store_true",
                    help="train a population of learning-engine replicas")
    cli.add_net_flag(ap, "--snn", default=None)
    cli.add_update_flags(ap)
    cli.add_train_flags(ap)
    cli.add_device_flag(ap)
    ap.add_argument("--engine-pre", type=int, default=256)
    ap.add_argument("--engine-post", type=int, default=256)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--engine-rate", type=float, default=0.3,
                    help="Bernoulli input spike rate (--engine mode)")
    ap.add_argument("--steps", type=int, default=None,
                    help="engine steps (--engine mode) or LM train steps (LM mode), default "
                    "100 each; with --snn, total simulation steps as one short epoch unless "
                    "epoch flags are given")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable; LM mode)")
    ap.add_argument("--seq", type=int, default=128, help="tokens per sequence (LM mode)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--remat", choices=("none", "full", "dots"), default="none")
    ap.add_argument("--po2-update", action="store_true",
                    help="ITP-AdamW: po2-quantised optimizer updates")
    ap.add_argument("--data", type=int, default=0,
                    help="data-parallel mesh axis (0 = no mesh)")
    ap.add_argument("--model", type=int, default=1, help="model-parallel mesh axis")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--inject-failure-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv: list[str] | None = None) -> dict:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.net:
        return run_snn_training(args)
    if args.engine:
        return run_engine_training(args)
    if args.data > 0:
        return mesh_lm_training(args)[0]
    return run_lm_training(args)


if __name__ == "__main__":
    main()
