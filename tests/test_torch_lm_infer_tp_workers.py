"""Worker processes of the tensor-parallel prefill and decode tests
(tests/test_torch_lm_infer_tp.py); this module holds no tests of its own.

Spawned processes import this module, which imports torch, numpy and the
port only (never JAX): each worker joins a ``data × model`` gloo world
through a ``FileStore``, runs every case of its world through the plans of
``launch.specs.plan_cell`` under ``fsdp`` on real DTensors, and puts its
results on a queue.  The weights (the port's seed-0 draw, every bias, norm
scale, gate and SSM vector moved off its init), the prompt, the decode
tokens and the prefilled cache (drawn whole, every slot) come from numpy
seeds, so the parent rebuilds them.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

S = 16                   # prompt length (the SSD chunk of 8 divides it)
T = 24                   # cache slots: hymba's ring holds min(16, 24)
POS = (21, 22, 23, 24)   # decode positions: 24 lies past the end of a linear cache
N_VIS = 8
PERTURBED = {"scale", "bias", "bq", "bk", "bv", "q_norm", "k_norm", "gate_attn", "conv_b",
             "d_skip", "dt_bias", "norm_scale", "up_bias", "down_bias"}
REPLACE = {"kv1": dict(n_kv_heads=1), "head64": dict(ssm_head_dim=64)}


@dataclasses.dataclass(frozen=True)
class Case:
    arch: str            # "<arch>[:<replace>]" (REPLACE)
    batch: int
    kv: str = "float32"  # the KV cache's dtype: float32 | int8
    prefill: bool = True

    @property
    def name(self) -> str:
        return f"{self.arch}-B{self.batch}-{self.kv}"


# (data, model) → cases
WORLDS = {
    # kv heads on 'model' (the smokes' 2 kv heads divide 2), the SSM heads
    # and channels split two ways, a hybrid ring, MoE, a VLM's cross K/V
    (1, 2): (Case("qwen3-0.6b", 2), Case("qwen3-0.6b", 2, "int8"), Case("mamba2-1.3b", 2),
             Case("hymba-1.5b", 2), Case("qwen2-moe-a2.7b", 2),
             Case("llama-3.2-vision-11b", 2)),
    # the batch over 'data'; B = 1 with T over 'data' (kv heads on 'model')
    # and, with one kv head, over ('data','model')
    (2, 2): (Case("qwen3-0.6b", 4), Case("qwen3-0.6b", 1, prefill=False),
             Case("qwen3-0.6b:kv1", 1, prefill=False), Case("mamba2-1.3b", 2),
             Case("qwen2-moe-a2.7b", 4)),
    # 2 kv heads on 4 ranks: T on 'model', the log-sum-exp combine; the
    # SSM's 160 / 144 channels cut 4 ways, and 2 heads that do not divide
    (1, 4): (Case("qwen3-0.6b", 2), Case("qwen3-0.6b", 2, "int8"), Case("hymba-1.5b", 2),
             Case("mamba2-1.3b", 2), Case("mamba2-1.3b:head64", 2)),
}


def config(arch: str):
    """A case's float32 smoke config (both packages get the same replace)."""
    from repro_torch.configs import get_smoke_config
    name, _, extra = arch.partition(":")
    return dataclasses.replace(get_smoke_config(name), dtype="float32",
                               **REPLACE.get(extra, {}))


def _perturbed(tree, rng):
    if isinstance(tree, dict):
        return {k: (_perturbed(v, rng) if isinstance(v, dict) else
                    (v + 0.3 * rng.standard_normal(v.shape)).astype(v.dtype)
                    if k in PERTURBED else v)
                for k, v in tree.items()}
    return tree


def model_arrays(cfg) -> dict:
    """The port's seed-0 draw as numpy arrays, vectors moved off their init."""
    from repro_torch import convert
    from repro_torch.models import transformer as TT
    arrays = convert.lm_params_to_numpy(
        TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu"))
    return _perturbed(arrays, np.random.default_rng(0))


def tokens(cfg, case: Case) -> tuple[np.ndarray, np.ndarray]:
    """(prompt (B, S), decode tokens (B, len(POS)))."""
    rng = np.random.default_rng(300)
    return (rng.integers(0, cfg.vocab_size, (case.batch, S)).astype(np.int32),
            rng.integers(0, cfg.vocab_size, (case.batch, len(POS))).astype(np.int32))


def vis_embed(cfg, case: Case) -> np.ndarray:
    rng = np.random.default_rng(301)
    return (rng.standard_normal((case.batch, N_VIS, cfg.vis_dim)) * 0.5).astype(np.float32)


def prefilled_cache(cfg, case: Case):
    """The port's ``DecodeCache`` of ``T`` slots, every slot drawn: KV
    values (int8 codes with scales), the SSM conv windows and states, a
    VLM's cross K/V."""
    from repro_torch.models import transformer as TT
    rng = np.random.default_rng(302)
    kv = torch.int8 if case.kv == "int8" else torch.float32
    cache = TT.init_decode_cache(cfg, case.batch, T, kv, device="cpu")

    def fill(x, scale=False):
        if x is None:
            return None
        if x.dtype == torch.int8:
            a = rng.integers(-127, 128, x.shape).astype(np.int8)
        elif scale:
            a = rng.uniform(0.005, 0.02, x.shape).astype(np.float32)
        else:
            a = (rng.standard_normal(x.shape) * 0.5).astype(np.float32)
        return torch.from_numpy(a)

    def fill_kv(c):
        return None if c is None else type(c)(fill(c.k), fill(c.v), fill(c.k_scale, True),
                                              fill(c.v_scale, True))
    out = cache._replace(kv=fill_kv(cache.kv), global_kv=fill_kv(cache.global_kv))
    if cache.ssm is not None:
        out = out._replace(ssm=type(cache.ssm)(fill(cache.ssm.conv),
                                               fill(cache.ssm.state) * 0.2))
    if cfg.family == "vlm":
        shape = (len(cfg.cross_attn_layers), case.batch, N_VIS, cfg.n_kv_heads,
                 cfg.resolved_head_dim)
        out = out._replace(cross_k=fill(torch.empty(shape)), cross_v=fill(torch.empty(shape)))
    return out


def _placed(tree, shardings, mesh):
    from repro_torch.distributed.sharding import distribute_like, map_with_path
    by_path: dict = {}
    map_with_path(by_path.__setitem__, shardings)
    return map_with_path(lambda path, x: distribute_like(x, mesh, by_path[path].placements),
                         tree)


def _run_case(cfg, case: Case, mesh) -> dict:
    from repro_torch import convert
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.distributed.sharding import (distribute_tree, map_with_path,
                                                  param_spec_tree, use_sharding_profile)
    from repro_torch.launch.specs import plan_cell

    with use_sharding_profile("fsdp"):
        params = convert.lm_params_from_arrays(model_arrays(cfg), device="cpu")
        params = distribute_tree(params, param_spec_tree(cfg, params, mesh), mesh)
    prompt, steps = tokens(cfg, case)
    out = {}
    if case.prefill:
        plan = plan_cell(cfg, ShapeSpec("prefill", S, case.batch, "prefill"), mesh)
        batch = {"tokens": torch.from_numpy(prompt)}
        if cfg.family == "vlm":
            batch["vis_embed"] = torch.from_numpy(vis_embed(cfg, case))
        logits = plan.fn(params, _placed(batch, plan.in_shardings[1], mesh))
        out["prefill"] = (plan.parallelism, logits.numpy().copy())
    plan = plan_cell(cfg, ShapeSpec("decode", T, case.batch, "decode"), mesh, kv_dtype=case.kv)
    cache = _placed(prefilled_cache(cfg, case), plan.in_shardings[1], mesh)
    toks = _placed({"t": torch.from_numpy(steps)}, {"t": plan.in_shardings[2]}, mesh)["t"]
    kept = cache
    logits = []
    for i, pos in enumerate(POS):
        step_toks = type(toks).from_local(toks.to_local()[:, i:i + 1], mesh, toks.placements,
                                          run_check=False)
        lg, cache = plan.fn(params, cache, step_toks, pos)
        logits.append(lg.numpy().copy())
    local = {}
    map_with_path(lambda path, x: local.__setitem__(
        path, (x.to_local().numpy().copy(), tuple(map(str, x.placements)))), cache)
    # the cache came back in place: the same local tensors, written
    same = []
    map_with_path(lambda path, x: same.append(x.to_local().data_ptr()), kept)
    ptrs = []
    map_with_path(lambda path, x: ptrs.append(x.to_local().data_ptr()), cache)
    out["decode"] = (plan.parallelism, logits, local, same == ptrs)
    return out


def infer_worker(rank: int, store_path: str, data: int, model: int, queue) -> None:
    """One rank of a ``data × model`` world: every case of ``WORLDS[data,
    model]``; puts ``(rank, case name, results)`` per case."""
    from repro_torch.distributed.sharding import init_process_group
    from repro_torch.launch.mesh import make_debug_mesh

    torch.set_num_threads(1)
    world = data * model
    init_process_group("cpu", rank=rank, world_size=world,
                       store=dist.FileStore(store_path, world))
    try:
        mesh = make_debug_mesh(data, model, device="cpu")
        for case in WORLDS[data, model]:
            queue.put((rank, case.name, _run_case(config(case.arch), case, mesh)))
    finally:
        dist.destroy_process_group()
