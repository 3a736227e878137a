"""Tensor-parallel LM training over 'model' (ROADMAP item 19a) in spawned gloo
worlds, against the JAX package.

The reference's own mesh step does not run on this JAX (ROADMAP "Reference
caveats"), so the tensor-parallel step is held to what GSPMD promises: the
reference's unsharded ``make_train_step`` on the whole batch, two steps,
within the LM float32 clause (``rtol=1e-4, atol=1e-5``; the SSM and hybrid
families ``2e-3``).  The worlds, ``fsdp`` throughout:

  * 1 × 2: the ten smoke configs, qwen2-moe with 5 experts, which the
    model axis does not divide (tensor parallelism inside the experts),
    and qwen3-0.6b under ``remat="dots"``;
  * 1 × 4: qwen3-0.6b (q heads split, its 2 kv heads' columns split and
    all-gathered), qwen2-1.5b (6 heads: the columns split, the heads
    gathered), qwen2-moe (expert-parallel) and qwen3-0.6b under
    ``remat="full"``.

Each rank multiplies weights of the spec's widths (the proof that the
compute is split), the leaves replicated over 'model' end bit-equal on every
rank, and a world's first case run twice ends bit-equal.  Each world is
spawned once per module and each reference step computed once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_lm_tp_workers as W
from repro.configs import get_smoke_config as j_smoke_config
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.distributed.sharding import param_spec_tree
from repro_torch.models import transformer as TT
from test_torch_sharded import _spawn

F32 = dict(rtol=1e-4, atol=1e-5)
SSM = dict(rtol=2e-3, atol=2e-3)
METRICS = ("loss", "ce", "z_loss", "moe_aux", "tokens", "lr", "grad_norm")
CASES = [(model, case, remat) for model, cases in W.WORLD_CASES.items()
         for case, remat in cases]


def _tol(cfg):
    return SSM if cfg.family in ("ssm", "hybrid") else F32


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Both worlds' results by (model, case, remat, rank)."""
    out = {}
    for model, cases in W.WORLD_CASES.items():
        store = str(tmp_path_factory.mktemp(f"tp_1x{model}") / "store")
        for rank, case, remat, *rest in _spawn(W.world_worker, model, store, model,
                                               expect=model * len(cases)):
            out[model, case, remat, rank] = dict(zip(("metrics", "widths", "local", "state",
                                                      "twice"), rest))
    return out


@pytest.fixture(scope="module")
def reference_runs():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _reference_steps(case)
        return cache[case]
    return get


def _reference_steps(case):
    """The reference's unsharded step ``N_STEPS`` times from the port's
    seed-0 draw: its metrics per step and the final params, mu and nu."""
    cfg = W.config(case)
    jcfg = dataclasses.replace(j_smoke_config(case.split(":")[0]), dtype="float32",
                               **W.CASE_REPLACE.get(case, {}))
    arrays = convert.lm_params_to_numpy(
        TT.init_model(torch.Generator().manual_seed(0), cfg, device="cpu"))
    jp = jax.tree_util.tree_map(jnp.asarray, arrays)
    jstep = jax.jit(JTS.make_train_step(jcfg, JO.OptimizerConfig(**W.OPT),
                                        JTS.TrainConfig(remat="none")))
    js, metrics = JO.init_opt_state(jp), []
    for k in range(W.N_STEPS):
        jp, js, jm = jstep(jp, js, {name: jnp.asarray(a) for name, a in W.batch(cfg, k).items()})
        metrics.append({name: float(jm[name]) for name in METRICS})
    leaves = jax.tree_util.tree_leaves
    return metrics, {"params": leaves(jp), "mu": leaves(js.mu), "nu": leaves(js.nu)}


class FakeMesh:
    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


def _specs(cfg, model):
    """Path → (global shape, spec) of every leaf on a ``1 × model`` mesh."""
    meta = TT.init_model(None, cfg, device="meta")
    specs = param_spec_tree(cfg, meta, FakeMesh(data=1, model=model))
    out = {}

    def walk(node, spec, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], spec[k], path + (k,))
        else:
            out["/".join(path)] = (tuple(node.shape),
                                   tuple(spec) + (None,) * (node.dim() - len(spec)))
    walk(meta, specs, ())
    return out


def _ids(case):
    model, name, remat = case
    return f"1x{model}-{name}-{remat}"


@pytest.mark.parametrize("model,case,remat", CASES, ids=map(_ids, CASES))
def test_tp_world_matches_the_reference_unsharded_step(worlds, reference_runs, model, case,
                                                       remat):
    cfg = W.config(case)
    tol = _tol(cfg)
    ref_metrics, ref_state = reference_runs(case)
    per_rank = [worlds[model, case, remat, r]["metrics"] for r in range(model)]
    assert all(m == per_rank[0] for m in per_rank), "the ranks' metrics differ"
    for got, want in zip(per_rank[0], ref_metrics):
        for name in METRICS:
            np.testing.assert_allclose(got[name], want[name], **tol, err_msg=name)
    if cfg.is_moe:
        assert per_rank[0][0]["moe_aux"] > 0
    state = worlds[model, case, remat, 0]["state"]
    for name in ("params", "mu", "nu"):
        assert len(state[name]) == len(ref_state[name])
        for got, want in zip(state[name], ref_state[name]):
            np.testing.assert_allclose(got, np.asarray(want), **tol, err_msg=name)


@pytest.mark.parametrize("model,case,remat", CASES, ids=map(_ids, CASES))
def test_each_rank_multiplies_the_specs_widths(worlds, model, case, remat):
    """The leaves the step multiplies hold the spec's 'model' shard, the SSM
    mixer's too (ROADMAP item 19b), on every rank: the compute is split."""
    cfg = W.config(case)
    want = {}
    for path, (shape, spec) in _specs(cfg, model).items():
        want[path] = tuple(n if e != "model" else n // model
                           for n, e in zip(shape, spec))
    for r in range(model):
        assert worlds[model, case, remat, r]["widths"] == want
    split = {path.split("/")[-1] for path, (shape, _) in _specs(cfg, model).items()
             if want[path] != shape}
    assert "tok" in split
    if cfg.family != "ssm":
        assert {"wq", "wo"} <= split and ({"down", "gate"} & split)
    if cfg.family in ("ssm", "hybrid"):
        assert {"wz", "wxbc", "conv_w", "conv_b", "norm_scale", "out_proj"} <= split


@pytest.mark.parametrize("model,case,remat", CASES, ids=map(_ids, CASES))
def test_replicated_leaves_are_bit_equal_across_model_ranks(worlds, model, case, remat):
    cfg = W.config(case)
    replicated = [path for path, (_, spec) in _specs(cfg, model).items()
                  if "model" not in spec]
    assert replicated, "no leaf is replicated over 'model'"
    for name in ("params", "mu", "nu"):
        for path in replicated:
            arrays = [worlds[model, case, remat, r]["local"][name][path] for r in range(model)]
            assert all(np.array_equal(a, arrays[0]) for a in arrays), (name, path)


@pytest.mark.parametrize("model", sorted(W.WORLD_CASES))
def test_two_tp_runs_are_bit_equal(worlds, model):
    case, remat = W.WORLD_CASES[model][0]
    assert [worlds[model, case, remat, r]["twice"] for r in range(model)] == [True] * model
