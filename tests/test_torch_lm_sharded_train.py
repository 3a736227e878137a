"""Sharded LM training (ROADMAP item 18d) in spawned gloo worlds, against the
JAX package.

The reference's own mesh step does not run on this JAX (ROADMAP "Reference
caveats"), so the sharded step is held to what GSPMD promises: the
reference's unsharded ``make_train_step`` on the whole batch, two steps,
within the LM float32 clause (``rtol=1e-4, atol=1e-5``).  The batches' labels
hold -1 at random, so the shards hold different token counts.  The worlds:

  * 2 × 2 ``('data','model')``, qwen3-0.6b under ``fsdp``, ``replicated``,
    ``dp`` and ``dp_zero3``, and qwen2-moe (expert tables expert-parallel)
    under ``fsdp``; each rank's shard shapes equal the reference's
    ``NamedSharding.shard_shape``; the ``fsdp`` state is checkpointed and
    restored sharded, into one process and into the JAX package;
  * 2 × 1 × 1 ``('pod','data','model')``, one step with and without
    ``pod_compression``, against the reference's functions composed: each
    pod's half batch through ``jax.value_and_grad(lm_loss)``, the mean of
    ``po2_roundtrip_ref`` over the pods (or the plain mean), then
    ``adamw_update``.  An element whose gradient code differs between the
    packages in either pod (the reference's ``jnp.log2`` rounds otherwise
    near √2·2^k, and last-bit gradient differences straddle a code) is
    counted (``-s`` prints the count) and held to two learning-rate steps.

Each world is spawned once per module (``FileStore`` under ``tmp_path``,
joined with a timeout, groups destroyed in the workers' ``finally``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

import test_torch_lm_sharded_workers as W
from repro.checkpoint import restore_checkpoint as j_restore
from repro.configs import get_smoke_config as j_smoke_config
from repro.kernels.po2_quant.ref import po2_encode_ref, po2_roundtrip_ref
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.checkpoint import restore_checkpoint
from repro_torch.distributed.sharding import (init_process_group, param_spec_tree,
                                              use_sharding_profile)
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import describe, make_debug_mesh
from repro_torch.models import transformer as TT
from repro_torch.train import optimizer as TO
from repro_torch.train import train_step as TTS
from repro_torch.tree import tree_leaves
from test_torch_po2 import correctly_rounded_codes, in_tie_band
from test_torch_sharded import _spawn

F32 = dict(rtol=1e-4, atol=1e-5)
METRICS = ("loss", "ce", "z_loss", "moe_aux", "tokens", "lr", "grad_norm")


def _reference_model(arch):
    """The reference's float32 config and the port's seed-0 draw as JAX arrays."""
    cfg = dataclasses.replace(j_smoke_config(arch), dtype="float32")
    arrays = convert.lm_params_to_numpy(
        TT.init_model(torch.Generator().manual_seed(0), W.config(arch), device="cpu"))
    return cfg, jax.tree_util.tree_map(jnp.asarray, arrays)


def _jbatch(toks, labels):
    return {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}


def _reference_steps(arch, steps):
    """The reference's unsharded step ``steps`` times: its metrics per step
    and the final params, mu and nu leaves."""
    cfg, jp = _reference_model(arch)
    jstep = jax.jit(JTS.make_train_step(cfg, JO.OptimizerConfig(**W.OPT),
                                        JTS.TrainConfig(remat="none")))
    js, metrics = JO.init_opt_state(jp), []
    for k in range(steps):
        jp, js, jm = jstep(jp, js, _jbatch(*W.batch(cfg, k)))
        metrics.append({name: float(jm[name]) for name in METRICS})
    leaves = jax.tree_util.tree_leaves
    return metrics, {"params": leaves(jp), "mu": leaves(js.mu), "nu": leaves(js.nu)}


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    base = tmp_path_factory.mktemp("lm_grid")
    n_items = 4 * len(W.GRID_CASES) + 4
    items = _spawn(W.grid_worker, 4, str(base / "store"), 2, 2, str(base / "ckpt"),
                   expect=n_items)
    cases = {(arch, profile, rank): (metrics, shapes, same, state)
             for kind, rank, arch, profile, metrics, shapes, same, state in
             (i for i in items if i[0] == "case")}
    ckpt = {rank: ok for kind, rank, ok in (i for i in items if i[0] == "ckpt")}
    return {"cases": cases, "ckpt": ckpt, "ckpt_dir": str(base / "ckpt")}


@pytest.fixture(scope="module")
def pods(tmp_path_factory):
    items = _spawn(W.pod_worker, 2, str(tmp_path_factory.mktemp("lm_pods") / "store"), 2,
                   expect=2 * len(W.POD_CASES))
    return {(rank, compress): (metrics, state) for rank, compress, metrics, state in items}


@pytest.fixture(scope="module")
def reference_runs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = _reference_steps(arch, W.N_STEPS)
        return cache[arch]
    return get


def test_the_shards_hold_different_token_counts():
    cfg = W.config("qwen3-0.6b")
    for k in range(W.N_STEPS):
        _, labels = W.batch(cfg, k)
        counts = (labels >= 0).sum(axis=1)
        assert len(set(counts.tolist())) > 1, "every row holds as many tokens"


@pytest.mark.parametrize("arch,profile", W.GRID_CASES)
def test_2x2_world_matches_the_reference_unsharded_step(grid, reference_runs, arch, profile):
    ref_metrics, ref_state = reference_runs(arch)
    per_rank = [grid["cases"][arch, profile, r][0] for r in range(4)]
    assert all(m == per_rank[0] for m in per_rank), "the ranks' metrics differ"
    for got, want in zip(per_rank[0], ref_metrics):
        for name in METRICS:
            np.testing.assert_allclose(got[name], want[name], **F32, err_msg=name)
    if arch.startswith("qwen2-moe"):
        assert per_rank[0][0]["moe_aux"] > 0
        # expert-parallel: each rank holds half the (layers, experts, d, f) table
        shapes = grid["cases"][arch, profile, 0][1]
        assert shapes["blocks/moe/gate"][1] == W.config(arch).experts_alloc // 2
    state = grid["cases"][arch, profile, 0][3]
    for name in ("params", "mu", "nu"):
        assert len(state[name]) == len(ref_state[name])
        for got, want in zip(state[name], ref_state[name]):
            np.testing.assert_allclose(got, np.asarray(want), **F32, err_msg=name)


@pytest.mark.parametrize("arch,profile", W.GRID_CASES)
def test_2x2_world_matches_the_ports_unsharded_step(grid, arch, profile):
    cfg = W.config(arch)
    ocfg = TO.OptimizerConfig(**W.OPT)
    params, opt = TTS.init_training(torch.Generator().manual_seed(0), cfg, ocfg, device="cpu")
    step = TTS.make_train_step(cfg, ocfg, TTS.TrainConfig(remat="full"))
    for k in range(W.N_STEPS):
        toks, labels = W.batch(cfg, k)
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks),
                                            "labels": torch.from_numpy(labels)})
        for name in METRICS:
            np.testing.assert_allclose(grid["cases"][arch, profile, 0][0][k][name],
                                       float(m[name]), **F32, err_msg=name)
    state = grid["cases"][arch, profile, 0][3]
    for name, tree in (("params", params), ("mu", opt.mu), ("nu", opt.nu)):
        for got, want in zip(state[name], tree_leaves(tree)):
            np.testing.assert_allclose(got, want.numpy(), **F32, err_msg=name)


@pytest.mark.parametrize("profile", ("fsdp", "replicated", "dp", "dp_zero3"))
def test_each_ranks_shards_have_the_reference_shard_shapes(grid, profile):
    """Every rank's ``to_local()`` shape is the reference's shard shape of
    the same spec on a 2 × 2 mesh, and the port's cut equals DTensor's."""
    cfg = W.config("qwen3-0.6b")
    meta = TT.init_model(None, cfg, device="meta")
    mesh = AbstractMesh((2, 2), ("data", "model"))
    with use_sharding_profile(profile):
        specs = param_spec_tree(cfg, meta, FakeMesh(data=2, model=2))
    want = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            want["/".join(path)] = NamedSharding(mesh, JP(*node)).shard_shape(
                tuple(_leaf(meta, path).shape))
    walk(specs, ())
    sharded = 0
    for rank in range(4):
        _, shapes, same, _ = grid["cases"]["qwen3-0.6b", profile, rank]
        assert same and shapes == want
        sharded += sum(s != tuple(_leaf(meta, tuple(p.split("/"))).shape)
                       for p, s in shapes.items())
    if profile != "dp":
        assert sharded > 0, "no leaf was sharded"


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _composed_pod_reference(compress):
    """The reference's functions composed for a 2-pod step: pod-local
    ``lm_loss`` gradients on each half batch, their mean over the pods
    (po2 round trip each, or plain), then ``adamw_update``."""
    cfg, jp = _reference_model("qwen3-0.6b")
    toks, labels = W.batch(cfg, 0)
    half = W.B // 2
    tc = JTS.TrainConfig(remat="none")
    vg = jax.jit(jax.value_and_grad(lambda q, b: JTS.lm_loss(q, cfg, b, train_cfg=tc),
                                    has_aux=True))
    outs = [vg(jp, _jbatch(toks[p * half:(p + 1) * half], labels[p * half:(p + 1) * half]))
            for p in range(2)]
    leaves = [jax.tree_util.tree_leaves(g) for _, g in outs]
    one = po2_roundtrip_ref if compress else (lambda x: x)
    mean = [jnp.mean(jnp.stack([one(a), one(b)]), axis=0) for a, b in zip(*leaves)]
    grads = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jp), mean)
    jp2, js2, om = JO.adamw_update(JO.OptimizerConfig(**W.OPT), jp, grads, JO.init_opt_state(jp))
    metrics = {name: float(np.mean([float(m[name]) for (_, m), _ in outs]))
               for name in ("loss", "ce", "z_loss", "moe_aux", "tokens")}
    metrics.update(lr=float(om["lr"]), grad_norm=float(om["grad_norm"]))
    state = {"params": jax.tree_util.tree_leaves(jp2), "mu": jax.tree_util.tree_leaves(js2.mu),
             "nu": jax.tree_util.tree_leaves(js2.nu)}
    return metrics, state, leaves, (toks, labels)


@pytest.mark.parametrize("compress", W.POD_CASES, ids=["po2", "plain"])
def test_pod_branch_matches_the_composed_reference(pods, compress):
    metrics, state, ref_grads, (toks, labels) = _composed_pod_reference(compress)
    got_metrics, got = pods[0, compress]
    assert pods[1, compress][0] == got_metrics, "the pods' metrics differ"
    for name in METRICS:
        np.testing.assert_allclose(got_metrics[0][name], metrics[name], **F32, err_msg=name)
    mask = [np.zeros(np.shape(g), bool) for g in ref_grads[0]]
    if compress:
        # the port's pod-local gradients: what each pod rank computes (its
        # data and model axes have one rank)
        cfg, half = W.config("qwen3-0.6b"), W.B // 2
        params = TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
        for p in range(2):
            b = {"tokens": torch.from_numpy(toks[p * half:(p + 1) * half]),
                 "labels": torch.from_numpy(labels[p * half:(p + 1) * half])}
            _, _, port = TTS.loss_and_grads(params, cfg, b, train_cfg=TTS.TrainConfig())
            for i, (g, r) in enumerate(zip(tree_leaves(port), ref_grads[p])):
                r = np.asarray(r)
                mask[i] |= ((np.asarray(po2_encode_ref(r)) & 255)
                            != correctly_rounded_codes(g.numpy())) | in_tie_band(r)
    lr = metrics["lr"]
    n_masked = sum(int(m.sum()) for m in mask)
    n_all = sum(m.size for m in mask)
    for i, (p_got, p_want) in enumerate(zip(got["params"], state["params"])):
        p_want = np.asarray(p_want)
        np.testing.assert_allclose(p_got[~mask[i]], p_want[~mask[i]], **F32)
        # a counted element moved by at most two learning-rate steps apart
        assert np.all(np.abs(p_got - p_want)[mask[i]] <= 2 * lr * (1 + 1e-6) + 1e-5)
    for name in ("mu", "nu"):
        for i, (a, b) in enumerate(zip(got[name], state[name])):
            np.testing.assert_allclose(a[~mask[i]], np.asarray(b)[~mask[i]], **F32)
    assert n_masked <= n_all // 1000
    if compress:
        print(f"[pod] qwen3-0.6b 2 pods, po2 mean: {n_masked} of {n_all} gradient elements "
              f"whose code differs between the packages in a pod: counted, held to 2·lr")


def test_sharded_checkpoint_restores_sharded_in_one_process_and_in_jax(grid):
    assert grid["ckpt"] == {r: True for r in range(4)}
    arch, _ = W.CKPT_CASE
    cfg = W.config(arch)
    state = grid["cases"][(*W.CKPT_CASE, 0)][3]
    ocfg = TO.OptimizerConfig(**W.OPT)
    # into one process: an unsharded template, then a 1 x 1 mesh
    params, opt = TTS.init_training(torch.Generator().manual_seed(1), cfg, ocfg, device="cpu")
    back = restore_checkpoint(grid["ckpt_dir"], W.N_STEPS, {"params": params, "opt": opt})
    for name, tree in (("params", back["params"]), ("mu", back["opt"].mu),
                       ("nu", back["opt"].nu)):
        assert all(np.array_equal(a.numpy(), b) for a, b in zip(tree_leaves(tree), state[name]))
    init_process_group("cpu", rank=0, world_size=1,
                       store=dist.FileStore(grid["ckpt_dir"] + "_store", 1))
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        assert describe(mesh) == "data=1 × model=1"
        params, opt = TTS.init_training(torch.Generator().manual_seed(1), cfg, ocfg, mesh=mesh,
                                        device="cpu")
        back = restore_checkpoint(grid["ckpt_dir"], W.N_STEPS, {"params": params, "opt": opt})
        leaves = tree_leaves(back["params"])
        assert all(type(x).__name__ == "DTensor" for x in leaves)
        assert all(np.array_equal(a.full_tensor().numpy(), b)
                   for a, b in zip(leaves, state["params"]))
        assert int(back["opt"].step) == W.N_STEPS
    finally:
        dist.destroy_process_group()
    # into the JAX package
    jcfg, jp = _reference_model(arch)
    jback = j_restore(grid["ckpt_dir"], W.N_STEPS, {"params": jp, "opt": JO.init_opt_state(jp)})
    for name, tree in (("params", jback["params"]), ("mu", jback["opt"].mu),
                       ("nu", jback["opt"].nu)):
        assert all(np.array_equal(np.asarray(a), b)
                   for a, b in zip(jax.tree_util.tree_leaves(tree), state[name]))
    assert int(jback["opt"].step) == W.N_STEPS


def test_launcher_on_a_2x2_mesh_equals_no_mesh(tmp_path, capfd):
    flags = ["--arch", "qwen3-0.6b", "--smoke", "--device", "cpu", "--steps", "3",
             "--batch", "4", "--seq", "16", "--log-every", "1"]
    plain = launch_train.main(flags + ["--ckpt-dir", str(tmp_path / "a")])
    capfd.readouterr()
    sharded = launch_train.main(flags + ["--data", "2", "--model", "2",
                                         "--ckpt-dir", str(tmp_path / "b")])
    out = capfd.readouterr().out
    assert "mesh: data=2 × model=2" in out
    assert out.count("done: 3 steps") == 1, "a rank other than 0 printed"
    assert sharded["mesh"] == "data=2 × model=2" and sharded["steps"] == 3
    np.testing.assert_allclose(sharded["final_loss"], plain["final_loss"], **F32)


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_joins_a_torchrun_world(tmp_path, monkeypatch, capfd):
    """With torchrun's variables set the launcher joins that world (here one
    rank) instead of starting its own, and leaves it at the end."""
    for name, value in (("RANK", "0"), ("WORLD_SIZE", "1"), ("LOCAL_RANK", "0"),
                        ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(_free_port()))):
        monkeypatch.setenv(name, value)
    out = launch_train.main(["--smoke", "--device", "cpu", "--data", "1", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert out["mesh"] == "data=1 × model=1" and not dist.is_initialized()
    assert "mesh: data=1 × model=1" in capfd.readouterr().out
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="torchrun world has 2"):
        launch_train.main(["--smoke", "--device", "cpu", "--data", "1", "--ckpt-dir",
                           str(tmp_path)])


def test_a_mesh_that_does_not_fit_is_refused(tmp_path, monkeypatch):
    """More CUDA ranks than cards, and a mesh of another size than the
    world, raise; nothing falls back."""
    monkeypatch.setattr(launch_train, "resolve_device", lambda d: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one per card"):
        launch_train.main(["--smoke", "--data", "2", "--batch", "4", "--ckpt-dir",
                           str(tmp_path)])
    monkeypatch.undo()
    init_process_group("cpu", rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        with pytest.raises(ValueError, match="needs 4 ranks, the world has 1"):
            make_debug_mesh(2, 2, device="cpu")
        with pytest.raises(ValueError, match="needs 'nccl'"):
            make_debug_mesh(1, 1, device="cuda")
    finally:
        dist.destroy_process_group()
    with pytest.raises(RuntimeError, match="no process group"):
        make_debug_mesh(1, 1, device="cpu")
