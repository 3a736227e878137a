"""Worker processes of the tensor-parallel LM training tests
(tests/test_torch_lm_tp.py); this module holds no tests of its own.

Spawned processes import this module, which imports torch and the port only
(never JAX): each worker joins a ``1 × model`` gloo world through a
``FileStore``, trains its cases under ``fsdp`` and puts its results on a
queue.  The model is the port's draw from seed 0 and the batches come from
numpy seeds, so the parent rebuilds both.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

B, S, N_STEPS, N_VIS = 4, 16, 2, 8
# the launcher's optimizer at --steps 100: step 1's lr is lr / warmup
OPT = dict(lr=3e-4, total_steps=100, warmup_steps=5)
ARCHS = ("llama-3.2-vision-11b", "qwen1.5-32b", "yi-9b", "qwen3-0.6b", "qwen2-1.5b",
         "hymba-1.5b", "qwen2-moe-a2.7b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
         "musicgen-medium")
# qwen2-moe with 5 experts: the expert tables do not divide the model axis,
# so the experts' hidden is split (tensor parallelism inside the experts)
TP_EXPERTS = "qwen2-moe-a2.7b:5-experts"
# a case's replace on the smoke config, the same in both packages: the 5
# experts above; mamba2 with 2 heads (ssm_head_dim 64), which 4 ranks do
# not divide while its 128 and 160 columns do (hymba-1.5b's 50 heads on
# 16); mamba2 with 2 groups (its heads cut within each group)
CASE_REPLACE = {TP_EXPERTS: dict(n_experts=5, n_experts_padded=0),
                "mamba2-1.3b:head64": dict(ssm_head_dim=64),
                "mamba2-1.3b:groups2": dict(ssm_groups=2)}
# (case, remat) per world; the first case of each runs twice
WORLD_CASES = {
    # and one case under remat="dots" (a selective checkpoint that recomputes
    # the collectives' ops)
    2: tuple((arch, "none") for arch in ("qwen2-moe-a2.7b",) + tuple(
        a for a in ARCHS if a != "qwen2-moe-a2.7b") + (TP_EXPERTS,)) + (("qwen3-0.6b", "dots"),),
    # q heads split with kv all-gathered; columns split with heads gathered;
    # expert-parallel; the same model under remat="full"
    4: (("qwen2-moe-a2.7b", "none"), ("qwen3-0.6b", "none"), ("qwen2-1.5b", "none"),
        ("qwen3-0.6b", "full")),
}


def config(case: str):
    """A case's float32 smoke config (both packages get the same replace)."""
    from repro_torch.configs import get_smoke_config
    arch = case.split(":")[0]
    return dataclasses.replace(get_smoke_config(arch), dtype="float32",
                               **CASE_REPLACE.get(case, {}))


def batch(cfg, step: int) -> dict:
    """Step ``step``'s arrays: tokens, next-token labels with the last
    column and about 30 % of the rest ignored (-1), and for a VLM the patch
    embeddings."""
    rng = np.random.default_rng(200 + step)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    labels[rng.random((B, S)) < 0.3] = -1
    out = {"tokens": toks, "labels": labels}
    if cfg.family == "vlm":
        out["vis_embed"] = (rng.standard_normal((B, N_VIS, cfg.vis_dim)) * 0.5).astype(
            np.float32)
    return out


def _run(cfg, mesh, remat: str):
    """``N_STEPS`` steps from the seed-0 draw: (params, opt, metrics)."""
    from repro_torch.train import OptimizerConfig, TrainConfig, init_training, make_train_step
    ocfg = OptimizerConfig(**OPT)
    params, opt = init_training(torch.Generator().manual_seed(0), cfg, ocfg, mesh=mesh,
                                device="cpu")
    step = make_train_step(cfg, ocfg, TrainConfig(remat=remat), mesh)
    metrics = []
    for k in range(N_STEPS):
        params, opt, m = step(params, opt, {name: torch.from_numpy(a)
                                            for name, a in batch(cfg, k).items()})
        metrics.append({name: float(v) for name, v in m.items()})
    return params, opt, metrics


def _local_arrays(tree) -> dict:
    from repro_torch.distributed.sharding import map_with_path
    out = {}
    map_with_path(lambda path, x: out.__setitem__(path, x.to_local().numpy().copy()), tree)
    return out


def world_worker(rank: int, store_path: str, model: int, queue) -> None:
    """One rank of a ``1 × model`` world: every case of ``WORLD_CASES[model]``
    (:func:`cases_worker`)."""
    cases_worker(rank, store_path, model, WORLD_CASES[model], queue)


def cases_worker(rank: int, store_path: str, model: int, cases, queue) -> None:
    """One rank of a ``1 × model`` world: every ``(case, remat)`` of ``cases``;
    puts ``(rank, case, remat, metrics, used widths, local state, state
    arrays or None, twice bit-equal or None)`` per case: the widths of the
    leaves the step multiplies (``gather_fsdp_tree``), the rank's local
    params, mu and nu, the whole state from rank 0 only."""
    from repro_torch.distributed.sharding import (gather_fsdp_tree, gather_tree,
                                                  init_process_group, map_with_path)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.tree import tree_leaves

    torch.set_num_threads(1)
    init_process_group("cpu", rank=rank, world_size=model,
                       store=dist.FileStore(store_path, model))
    try:
        mesh = make_debug_mesh(1, model, device="cpu")
        for i, (case, remat) in enumerate(cases):
            cfg = config(case)
            params, opt, metrics = _run(cfg, mesh, remat)
            widths = {}
            map_with_path(lambda path, x: widths.__setitem__(path, tuple(x.shape)),
                          gather_fsdp_tree(params))
            local = {name: _local_arrays(tree)
                     for name, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu))}
            # every rank gathers (a collective); rank 0 reports
            state = {name: [x.numpy() for x in tree_leaves(gather_tree(tree))]
                     for name, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu))}
            twice = None
            if i == 0:
                p2, o2, m2 = _run(cfg, mesh, remat)
                twice = m2 == metrics and all(
                    torch.equal(a.to_local(), b.to_local()) for a, b in
                    zip(tree_leaves((params, opt.mu, opt.nu)), tree_leaves((p2, o2.mu, o2.nu))))
            queue.put((rank, case, remat, metrics, widths, local, state if rank == 0 else None,
                       twice))
    finally:
        dist.destroy_process_group()
