"""Worker processes of the port's multi-process tests (tests/test_torch_sharded.py);
this module holds no tests of its own.

Spawned processes import this module, which imports torch and the port only
(never JAX): each worker joins a gloo world through a ``FileStore``, runs
its share, puts its results on a queue and leaves the world in a
``finally``.  The inputs come from numpy seeds, so the parent can rebuild
them.
"""
import numpy as np
import torch
import torch.distributed as dist

# the 2 × 2 grid case of tests/test_distributed.py:377 (n_pre 16, n_post 8,
# eta 0.25, 30 steps at input rate 0.4), weights low enough that the posts
# fire sparsely
GRID_ENGINE = dict(n_pre=16, n_post=8, eta=0.25)
GRID_STEPS, GRID_RATE, GRID_W = 30, 0.4, 0.15
GRID_CASES = (("itp", "fused"), ("exact", "fused"), ("itp", "sparse"))


def grid_inputs(seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    w = rng.uniform(0.0, GRID_W, (GRID_ENGINE["n_pre"], GRID_ENGINE["n_post"]))
    x = rng.random((GRID_STEPS, GRID_ENGINE["n_pre"])) < GRID_RATE
    return w.astype(np.float32), x.astype(np.float32)


def grid_worker(rank: int, store_path: str, data: int, model: int, queue) -> None:
    """One rank of a ``data × model`` grid: every case of ``GRID_CASES``;
    puts ``(rank, rule, backend, w tile, post raster)`` per case."""
    from repro_torch.core.engine import EngineConfig, init_engine
    from repro_torch.core.engine_sharded import make_sharded_engine_step, shard_engine_state
    from repro_torch.distributed.sharding import init_process_group, make_grid

    init_process_group("cpu", rank=rank, world_size=data * model,
                       store=dist.FileStore(store_path, data * model))
    try:
        grid = make_grid(data, model, device="cpu")
        w0, train = grid_inputs()
        for rule, backend in GRID_CASES:
            cfg = EngineConfig(rule=rule, backend=backend, **GRID_ENGINE)
            state = shard_engine_state(init_engine(cfg, w0, device="cpu"), grid)
            step = make_sharded_engine_step(cfg, grid)
            posts = []
            for x in torch.from_numpy(train):
                state, post = step(state, x)
                posts.append(post)
            queue.put((rank, rule, backend, state.w.numpy(), torch.stack(posts).numpy()))
    finally:
        dist.destroy_process_group()


def pod_mean_grads(rank: int) -> dict:
    rng = np.random.default_rng(100 + rank)
    return {"a": rng.standard_normal((6, 5)).astype(np.float32),
            "b": [rng.standard_normal((7,)).astype(np.float32) * 1e-3]}


def pod_mean_worker(rank: int, store_path: str, world: int, queue) -> None:
    """One pod of ``pod_mean_tree``: puts ``(rank, compressed mean, plain mean)``."""
    from repro_torch.distributed.compression import pod_mean_tree
    from repro_torch.tree import tree_map

    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world)
    try:
        grads = tree_map(torch.from_numpy, pod_mean_grads(rank))
        comp = tree_map(lambda t: t.numpy(), pod_mean_tree(grads, compress=True))
        plain = tree_map(lambda t: t.numpy(), pod_mean_tree(grads, compress=False))
        queue.put((rank, comp, plain))
    finally:
        dist.destroy_process_group()
