"""Worker processes of the sharded LM training tests
(tests/test_torch_lm_sharded_train.py); this module holds no tests of its own.

Spawned processes import this module, which imports torch and the port only
(never JAX): each worker joins a gloo world through a ``FileStore``, trains
the float32 smoke configs on a mesh, puts its results on a queue and leaves
the world in a ``finally``.  The model is the port's draw from seed 0 and
the batches come from numpy seeds, so the parent rebuilds both.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

B, S, N_STEPS = 4, 16, 2
# the launcher's optimizer at --steps 100: step 1's lr is lr / warmup
OPT = dict(lr=3e-4, total_steps=100, warmup_steps=5)
# (arch, sharding profile) of the 2 x 2 world; the qwen2-moe smoke config's 8
# experts divide the model axis, so its expert tables are expert-parallel
GRID_CASES = (("qwen3-0.6b", "fsdp"), ("qwen3-0.6b", "replicated"), ("qwen3-0.6b", "dp"),
              ("qwen3-0.6b", "dp_zero3"), ("qwen2-moe-a2.7b", "fsdp"))
CKPT_CASE = ("qwen3-0.6b", "fsdp")
POD_CASES = (True, False)          # pod_compression


def config(arch: str):
    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def batch(cfg, step: int) -> tuple[np.ndarray, np.ndarray]:
    """Step ``step``'s tokens and labels: next tokens, the last column and
    about 30 % of the rest ignored (-1), so the shards hold different
    token counts."""
    rng = np.random.default_rng(100 + step)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
    labels[rng.random((B, S)) < 0.3] = -1
    return toks, labels


def _torch_batch(cfg, step: int) -> dict:
    toks, labels = batch(cfg, step)
    return {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}


def _join(rank: int, world: int, store_path: str) -> None:
    from repro_torch.distributed.sharding import init_process_group
    torch.set_num_threads(1)
    init_process_group("cpu", rank=rank, world_size=world,
                       store=dist.FileStore(store_path, world))


def _state_arrays(params, opt) -> dict:
    from repro_torch.distributed.sharding import gather_tree
    from repro_torch.tree import tree_leaves
    return {name: [x.numpy() for x in tree_leaves(gather_tree(tree))]
            for name, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu))}


def _train(cfg, profile: str, mesh, steps: int, **train_kw):
    from repro_torch.distributed.sharding import use_sharding_profile
    from repro_torch.train import OptimizerConfig, TrainConfig, init_training, make_train_step
    ocfg = OptimizerConfig(**OPT)
    with use_sharding_profile(profile):
        params, opt = init_training(torch.Generator().manual_seed(0), cfg, ocfg, mesh=mesh,
                                    device="cpu")
    step = make_train_step(cfg, ocfg, TrainConfig(remat="full", sharding_profile=profile,
                                                  **train_kw), mesh)
    metrics = []
    for k in range(steps):
        params, opt, m = step(params, opt, _torch_batch(cfg, k))
        metrics.append({name: float(v) for name, v in m.items()})
    return params, opt, metrics


def _shard_layout(params, mesh) -> tuple[dict, bool]:
    """Each leaf's local shape by path, and whether the port's shard of every
    leaf equals DTensor's own ``distribute_tensor`` shard."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.distributed.sharding import local_shard, map_with_path
    shapes, same = {}, []

    def one(path, x):
        shapes[path] = tuple(x.to_local().shape)
        full = x.full_tensor()
        same.append(torch.equal(local_shard(full, x.placements, mesh),
                                distribute_tensor(full, mesh, x.placements).to_local()))
    map_with_path(one, params)
    return shapes, all(same)


def grid_worker(rank: int, store_path: str, data: int, model: int, ckpt_dir: str,
                queue) -> None:
    """One rank of a ``data × model`` world: every case of ``GRID_CASES``
    trained ``N_STEPS`` steps; puts ``("case", rank, arch, profile, metrics,
    local shapes, shards equal, state arrays or None)`` per case (the state
    from rank 0 only) and ``("ckpt", rank, restored equal)`` after saving
    ``CKPT_CASE``'s state under ``ckpt_dir`` and restoring it sharded."""
    from repro_torch.checkpoint import AsyncCheckpointer, restore_checkpoint
    from repro_torch.distributed.sharding import use_sharding_profile
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.tree import tree_leaves

    _join(rank, data * model, store_path)
    try:
        mesh = make_debug_mesh(data, model, device="cpu")
        for arch, profile in GRID_CASES:
            cfg = config(arch)
            params, opt, metrics = _train(cfg, profile, mesh, N_STEPS)
            with use_sharding_profile(profile):
                shapes, same = _shard_layout(params, mesh)
            state = _state_arrays(params, opt)
            queue.put(("case", rank, arch, profile, metrics, shapes, same,
                       state if rank == 0 else None))
            if (arch, profile) == CKPT_CASE:
                ckpt = AsyncCheckpointer(ckpt_dir)
                ckpt.save(N_STEPS, {"params": params, "opt": opt})
                ckpt.wait()
                back = restore_checkpoint(ckpt_dir, N_STEPS, {"params": params, "opt": opt})
                ok = all(type(a) is type(b) and a.placements == b.placements
                         and torch.equal(a.to_local(), b.to_local())
                         for a, b in zip(tree_leaves((params, opt.mu, opt.nu)),
                                         tree_leaves((back["params"], back["opt"].mu,
                                                      back["opt"].nu))))
                queue.put(("ckpt", rank, ok and int(back["opt"].step) == N_STEPS))
    finally:
        dist.destroy_process_group()


def pod_worker(rank: int, store_path: str, pods: int, queue) -> None:
    """One rank of a ``pods × 1 × 1`` ``('pod','data','model')`` world: one
    step of qwen3-0.6b per case of ``POD_CASES``; puts ``(rank, compress,
    metrics, state arrays)``."""
    from repro_torch.launch.mesh import make_debug_mesh

    _join(rank, pods, store_path)
    try:
        mesh = make_debug_mesh(1, 1, pod=pods, device="cpu")
        for compress in POD_CASES:
            params, opt, metrics = _train(config("qwen3-0.6b"), "fsdp", mesh, 1,
                                          pod_compression=compress)
            queue.put((rank, compress, metrics, _state_arrays(params, opt)))
    finally:
        dist.destroy_process_group()
