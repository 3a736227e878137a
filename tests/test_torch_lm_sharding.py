"""The LM sharding rules (ROADMAP item 18d): ``repro_torch.distributed.sharding``
against the JAX package's ``repro.distributed.sharding``.

Every leaf spec of the ten full configs (the port's ``init_model(None, cfg,
device="meta")`` beside the reference's ``jax.eval_shape``) under the four
profiles, on both production meshes, equals the reference's entry for
entry; so do the decode-cache specs of every config's decode shapes, the
batch specs, and ``launch.specs``' plans.  The eight rule tests of
``tests/test_distributed.py`` are mirrored on the same shape-only mesh."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as JP
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as j_get_config
from repro.distributed import sharding as JS
from repro.launch import specs as JSP
from repro.models import transformer as JT
from repro_torch.configs import ARCH_NAMES, get_config, shapes_for
from repro_torch.distributed.sharding import (P, NamedSharding, batch_axes, batch_spec,
                                              constrain, decode_cache_shardings, kv_cache_spec,
                                              logical_to_spec, param_shardings, param_spec_for,
                                              model_dim, on_model, param_spec_tree,
                                              placements_for, ssm_cache_specs, use_manual_axes,
                                              use_mesh, use_sharding_profile,
                                              use_tensor_parallel)
from repro_torch.launch.dryrun import _fake_group
from repro_torch.launch import specs as TSP
from repro_torch.models import transformer as TT

PROFILES = ("fsdp", "replicated", "dp", "dp_zero3")


class FakeMesh:
    """Shape-only stand-in so sharding rules are testable on 1 device."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"single": FakeMesh(data=16, model=16), "multi": FakeMesh(pod=2, data=16, model=16)}


def _entries(spec) -> tuple:
    return tuple(spec)


# ---------------------------------------------------------------------------
# the rule tests of tests/test_distributed.py, mirrored
# ---------------------------------------------------------------------------

def test_logical_to_spec_divisibility_guard():
    mesh = FakeMesh(data=16, model=16)
    spec = logical_to_spec(("fsdp", "tp"), (100, 256), mesh)
    assert spec == P(None, "model")        # 100 % 16 != 0 → dropped
    spec = logical_to_spec(("fsdp", "tp"), (160, 256), mesh)
    assert spec == P("data", "model")


def test_logical_to_spec_right_alignment():
    mesh = FakeMesh(data=4, model=4)
    spec = logical_to_spec(("fsdp", "tp"), (7, 16, 16), mesh)
    assert spec == P(None, "data", "model")   # leading stack dim replicates


def test_param_rules_dense():
    mesh = FakeMesh(data=16, model=16)
    cfg = get_config("yi-9b")
    assert param_spec_for("blocks/attn/wq", (4096, 4096), cfg, mesh) == P("data", "model")
    assert param_spec_for("blocks/attn/wo", (4096, 4096), cfg, mesh) == P("model", "data")
    assert param_spec_for("blocks/norm1/scale", (4096,), cfg, mesh) == P()


def test_param_rules_moe_ep_vs_tp():
    mesh = FakeMesh(data=16, model=16)
    phi = get_config("phi3.5-moe-42b-a6.6b")     # 16 experts % 16 == 0 → EP
    spec = param_spec_for("blocks/moe/gate", (16, 4096, 6400), phi, mesh)
    assert spec[0] == "model"                    # experts sharded
    qw = get_config("qwen2-moe-a2.7b")           # 60 padded → 64 → EP
    spec = param_spec_for("blocks/moe/gate", (64, 2048, 1408), qw, mesh)
    assert spec[0] == "model"
    # without padding, 60 % 16 != 0 → TP inside each expert
    qw_nopad = dataclasses.replace(qw, n_experts_padded=0)
    spec = param_spec_for("blocks/moe/gate", (60, 2048, 1408), qw_nopad, mesh)
    assert spec[0] is None
    assert spec[2] == "model"


def test_embed_tok_rule_drops_fsdp_on_pod_mesh():
    cfg = get_config("yi-9b")
    single = FakeMesh(data=16, model=16)
    multi = FakeMesh(pod=2, data=16, model=16)
    assert param_spec_for("embed/tok", (64000, 4096), cfg, single) == P("model", "data")
    assert param_spec_for("embed/tok", (64000, 4096), cfg, multi) == P("model", None)


def test_kv_cache_spec_preferences():
    mesh = FakeMesh(pod=2, data=16, model=16)
    # kv heads divide → heads on model, batch on (pod, data)
    s = kv_cache_spec((64, 128, 32768, 16, 128), mesh)
    assert s[3] == "model" and s[1] == ("pod", "data")
    # kv heads don't divide → sequence parallelism over model
    s = kv_cache_spec((64, 128, 32768, 40, 128), mesh)
    assert s[3] is None and s[2] in ("model", ("model",))
    # batch=1 latency decode → context over (data, model)
    s = kv_cache_spec((3, 1, 524288, 5, 64), mesh)
    assert s[1] is None and s[2] == ("data", "model")


def test_sharding_profiles():
    mesh = FakeMesh(data=16, model=16)
    cfg = get_config("qwen3-0.6b")
    shape = (1024, 3072)   # an mlp/gate-like weight
    with use_sharding_profile("fsdp"):
        assert param_spec_for("blocks/mlp/gate", shape, cfg, mesh) == P("data", "model")
    with use_sharding_profile("replicated"):
        assert param_spec_for("blocks/mlp/gate", shape, cfg, mesh) == P(None, "model")
    with use_sharding_profile("dp"):
        spec = param_spec_for("blocks/mlp/gate", shape, cfg, mesh)
        assert all(s is None for s in spec)   # fully replicated
    with use_sharding_profile("dp_zero3"):
        # weights shard over the compute-idle model axis
        assert param_spec_for("blocks/mlp/gate", shape, cfg, mesh) == P("model", None)


def test_dp_profile_batch_axes():
    mesh = FakeMesh(data=16, model=16)
    with use_sharding_profile("dp"):
        assert batch_axes(mesh) == ("data", "model")
    with use_sharding_profile("fsdp"):
        assert batch_axes(mesh) == ("data",)


# ---------------------------------------------------------------------------
# every spec of the ten full configs against the reference
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_shapes(arch):
    cfg = j_get_config(arch)
    return cfg, jax.eval_shape(lambda k: JT.init_model(k, cfg), jax.random.PRNGKey(0))


def _reference_specs(cfg, shapes, mesh) -> dict:
    tree = JS.param_spec_tree(cfg, shapes, mesh)
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, JP))
    return {JS._path_str(path): _entries(spec) for path, spec in flat}


def _port_specs(cfg, mesh) -> dict:
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            out["/".join(path)] = _entries(node)
    walk(param_spec_tree(cfg, TT.init_model(None, cfg, device="meta"), mesh), ())
    return out


@pytest.mark.parametrize("profile", PROFILES)
@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_param_specs_equal_the_reference(arch, profile):
    jcfg, shapes = _reference_shapes(arch)
    cfg = get_config(arch)
    for name, mesh in MESHES.items():
        with use_sharding_profile(profile), JS.use_sharding_profile(profile):
            want = _reference_specs(jcfg, shapes, mesh)
            got = _port_specs(cfg, mesh)
        assert got == want, f"{arch} / {profile} / {name}"
        assert any(any(e is not None for e in s) for s in got.values()) or profile == "dp"


def _cache_entries(shardings) -> list:
    """A decode cache's NamedShardings (either package's) as spec entries."""
    out = []

    def walk(node):
        if node is None:
            return
        if hasattr(node, "spec"):
            out.append(_entries(node.spec))
        else:
            for x in node:
                walk(x)
    walk(shardings)
    return out


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_decode_cache_specs_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    n = 0
    for shape in shapes_for(cfg):
        if shape.kind != "decode":
            continue
        for kv_dtype in ("bfloat16", "int8"):
            got_cache = TSP.decode_inputs(cfg, shape, kv_dtype)["cache"]
            want_cache = JSP.decode_inputs(jcfg, shape, kv_dtype)["cache"]
            for mesh in MESHES.values():
                got = _cache_entries(decode_cache_shardings(got_cache, mesh))
                want = _cache_entries(JS.decode_cache_shardings(want_cache, _jmesh(mesh)))
                assert got == want and got, f"{arch} {shape.name} {kv_dtype}"
                if got_cache.kv is not None:
                    assert (_entries(kv_cache_spec(tuple(got_cache.kv.k.shape), mesh))
                            == _entries(JS.kv_cache_spec(tuple(want_cache.kv.k.shape), mesh)))
                if got_cache.ssm is not None:
                    assert ([_entries(s) for s in ssm_cache_specs(
                        tuple(got_cache.ssm.conv.shape), tuple(got_cache.ssm.state.shape), mesh)]
                        == [_entries(s) for s in JS.ssm_cache_specs(
                            tuple(want_cache.ssm.conv.shape), tuple(want_cache.ssm.state.shape),
                            mesh)])
                n += 1
    assert n >= 4


def _jmesh(mesh):
    """The reference's ``NamedSharding`` needs a mesh object: an abstract one
    of the same shape."""
    return jax.sharding.AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)


@pytest.mark.parametrize("profile", PROFILES)
def test_batch_specs_equal_the_reference(profile):
    for mesh in MESHES.values():
        with use_sharding_profile(profile), JS.use_sharding_profile(profile):
            for ndim in (1, 2, 3):
                assert (_entries(batch_spec(mesh, ndim))
                        == _entries(JS.batch_spec(mesh, ndim)))
                assert (_entries(batch_spec(mesh, ndim, seq_axis=ndim - 1))
                        == _entries(JS.batch_spec(mesh, ndim, seq_axis=ndim - 1)))


def test_manual_pod_axes_drop_pod_as_shard_map_does():
    mesh = MESHES["multi"]
    assert logical_to_spec(("batch", None), (64, 8), mesh) == P(("pod", "data"), None)
    with use_manual_axes({"pod"}):
        assert logical_to_spec(("batch", None), (64, 8), mesh) == P("data", None)
        with use_sharding_profile("dp"):
            assert logical_to_spec(("batch",), (512,), mesh) == P(("data", "model"))


def test_partition_spec_entries_follow_jax():
    assert P(("model",)) == P("model") and JP(("model",)) == JP("model")
    assert tuple(P(("pod", "data"), None)) == tuple(JP(("pod", "data"), None))
    assert P(None, "model") != P(None, "model", None)
    assert repr(P("data", None)) == "PartitionSpec('data', None)"


def test_plan_cell_shardings_equal_the_reference():
    """``launch.specs``: the train plan's parameter and batch specs and the
    decode plan's cache specs, beside the reference's plans."""
    arch = "qwen2-moe-a2.7b"
    cfg, jcfg = get_config(arch), j_get_config(arch)
    mesh = MESHES["multi"]
    jmesh = _jmesh(mesh)
    for shape in shapes_for(cfg):
        plan = TSP.plan_cell(cfg, shape, mesh)
        jplan = JSP.plan_cell(jcfg, shape, jmesh)
        # under fsdp every plan computes tensor-parallel (ROADMAP items 19a, 19b)
        assert plan.parallelism == "tensor-parallel" and plan.donate == jplan.donate
        got = [_entries(s.spec) for s in _flat_shardings(plan.in_shardings)]
        want = [_entries(s.spec) for s in jax.tree_util.tree_leaves(
            jplan.in_shardings, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))]
        assert got == want, shape.name


def _flat_shardings(tree) -> list:
    out = []

    def walk(node):
        if node is None:
            return
        if isinstance(node, NamedSharding):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for x in node:
                walk(x)
    walk(tree)
    return out


def test_param_shardings_carry_the_specs_and_constrain_is_the_identity():
    """``constrain`` is the identity outside the tensor-parallel context (a
    mesh alone does not switch it on: the prefill and decode plans run
    under ``use_mesh``); inside, on a fake ``1 × 2`` group, it keeps a
    tensor whose 'model' dim the spec names, all-gathers one whose spec
    drops 'model', and raises on any other transition."""
    cfg = get_config("qwen3-0.6b")
    mesh = MESHES["single"]
    meta = TT.init_model(None, cfg, device="meta")
    sh = param_shardings(cfg, meta, mesh)
    assert sh["blocks"]["attn"]["wq"].spec == param_spec_for(
        "blocks/attn/wq", tuple(meta["blocks"]["attn"]["wq"].shape), cfg, mesh)
    x = torch.ones(2, 3)
    with use_mesh(mesh):
        assert constrain(x, ("batch", None)) is x
    _fake_group(2)
    try:
        tp = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
        heads = ("batch", None, "tp", None)
        with use_mesh(tp):
            h = torch.ones(2, 5, 3, 8)
            assert constrain(h, heads) is h and model_dim(h) is None
        with use_tensor_parallel(tp):
            h = on_model(torch.ones(2, 5, 3, 8), 2)          # 3 of 6 heads
            assert constrain(h, heads) is h
            g = constrain(h, ("batch", None, None, None))     # the spec drops 'model'
            assert tuple(g.shape) == (2, 5, 6, 8) and model_dim(g) is None
            # replicated → sharded, and a shard of another dim: refused
            with pytest.raises(ValueError, match="cannot move"):
                constrain(torch.ones(2, 5, 6, 8), heads)
            with pytest.raises(ValueError, match="cannot move"):
                constrain(on_model(torch.ones(2, 5, 6, 4), 3), heads)
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# placements
# ---------------------------------------------------------------------------

class _Names:
    def __init__(self, *names):
        self.mesh_dim_names = names
        self.shape = (2,) * len(names)


def test_placements_for_shards_each_named_axis():
    mesh = _Names("pod", "data", "model")
    assert placements_for(P(None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert placements_for(P(("pod", "data"), None), mesh) == (Shard(0), Shard(0), Replicate())
    assert placements_for(P("model", "data"), mesh) == (Replicate(), Shard(1), Shard(0))
    assert placements_for(P(), mesh) == (Replicate(),) * 3


def test_placements_for_refuses_what_dtensor_cannot_place():
    mesh = _Names("data", "model")
    with pytest.raises(ValueError, match="axis order"):
        placements_for(P(("model", "data")), mesh)
    with pytest.raises(ValueError, match="two dims"):
        placements_for(P("data", "data"), mesh)
    with pytest.raises(ValueError, match="names axis"):
        placements_for(P("pod"), mesh)


def test_batch_shardings_match_the_reference():
    from repro.train import train_step as JTS
    from repro_torch.train import train_step as TTS
    mesh = MESHES["multi"]
    batch = {"tokens": torch.zeros(8, 4, dtype=torch.int32), "vis": torch.zeros(8, 2, 3)}
    got = TTS.batch_shardings(mesh, batch)
    want = JTS.batch_shardings(_jmesh(mesh), {k: np.zeros(v.shape) for k, v in batch.items()})
    assert {k: _entries(v.spec) for k, v in got.items()} == \
        {k: _entries(v.spec) for k, v in want.items()}
