"""The prefill and decode plans tensor-parallel (ROADMAP item 19b, parts 2-3)
in spawned gloo worlds, against the JAX package.

``launch.specs.plan_cell``'s prefill and decode functions run under
``fsdp`` on real DTensors in three worlds (workers in
tests/test_torch_lm_infer_tp_workers.py, no JAX): 1 × 2, 2 × 2 and 1 × 4.
The reference's own mesh functions do not run on this JAX (ROADMAP
"Reference caveats"), so each is held to the reference's unsharded function
on the same inputs: ``forward(last_logits_only=True)`` on the whole prompt
batch, and four ``decode_step``s from a prefilled cache (every slot drawn)
at positions 21-24 of 24 slots (24 lies past the end of a linear cache and
is clamped to its last slot; hymba's 16-slot ring wraps).  Each rank's
logits are its batch rows of the reference's, and each rank's cache leaf is
the shard of the reference's new cache that ``decode_cache_shardings``
places on it, of the spec's shape: nothing was gathered whole.  The LM
clause holds: float32 within ``rtol=1e-4, atol=1e-5``, the SSM and hybrid
families within ``2e-3``, argmax tokens and int8 codes exactly.

The layouts: kv heads on 'model' (1 × 2, 2 × 2), T on 'model' where the
smokes' 2 kv heads do not divide 4 (1 × 4: the log-sum-exp combine), one
sequence with T over 'data' (2 × 2, kv heads on 'model') and over
``('data','model')`` (2 × 2, one kv head), int8 caches with heads and with T
cut, the SSM caches' channels and heads on 'model', MoE (the batch one
routing group) and a VLM's cross K/V.  Each world is spawned once and each
reference result computed once."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import test_torch_lm_infer_tp_workers as W
from repro.configs import get_smoke_config as j_smoke_config
from repro.models import kvcache as JK
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.distributed.sharding import decode_cache_shardings, map_with_path
from test_torch_sharded import _spawn

F32 = dict(rtol=1e-4, atol=1e-5)
SSM = dict(rtol=2e-3, atol=2e-3)
CASES = [(world, case) for world, cases in W.WORLDS.items() for case in cases]

_forward = jax.jit(JT.forward, static_argnums=(1,),
                   static_argnames=("remat", "last_logits_only", "unroll"))
_decode = jax.jit(JT.decode_step, static_argnums=(1,))


def _tol(cfg):
    return SSM if cfg.family in ("ssm", "hybrid") else F32


def _ids(item):
    (data, model), case = item
    return f"{data}x{model}-{case.name}"


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = {}
    for (data, model), cases in W.WORLDS.items():
        store = str(tmp_path_factory.mktemp(f"infer_{data}x{model}") / "store")
        for rank, name, result in _spawn(W.infer_worker, data * model, store, data, model,
                                         expect=data * model * len(cases)):
            out[(data, model), name, rank] = result
    return out


def _jcfg(arch):
    import dataclasses
    name, _, extra = arch.partition(":")
    return dataclasses.replace(j_smoke_config(name), dtype="float32",
                               **W.REPLACE.get(extra, {}))


def _jax_cache(cache):
    kv, gkv, ssm, ck, cv = convert.decode_cache_to_numpy(cache)

    def one(x):
        return None if x is None else jnp.asarray(x)

    def kvc(c):
        return None if c is None else JK.KVCache(*map(one, c))
    return JT.DecodeCache(kv=kvc(kv), global_kv=kvc(gkv),
                          ssm=None if ssm is None else JS.SSMCache(*map(one, ssm)),
                          cross_k=one(ck), cross_v=one(cv))


@pytest.fixture(scope="module")
def reference():
    memo = {}

    def get(case):
        if case in memo:
            return memo[case]
        cfg, jcfg = W.config(case.arch), _jcfg(case.arch)
        jp = jax.tree_util.tree_map(jnp.asarray, W.model_arrays(cfg))
        prompt, steps = W.tokens(cfg, case)
        kw = {}
        if cfg.family == "vlm":
            kw["vis_embed"] = jnp.asarray(W.vis_embed(cfg, case))
        out = {}
        if case.prefill:
            out["prefill"] = np.asarray(_forward(jp, jcfg, tokens=jnp.asarray(prompt),
                                                 last_logits_only=True, **kw)[0])
        port_cache = W.prefilled_cache(cfg, case)
        jc = _jax_cache(port_cache)
        logits = []
        for i, pos in enumerate(W.POS):
            lg, jc = _decode(jp, jcfg, jc, jnp.asarray(pos), tokens=jnp.asarray(steps[:, i:i + 1]))
            logits.append(np.asarray(lg))
        leaves = {}
        map_with_path(lambda path, x: leaves.__setitem__(path, np.asarray(x)),
                      convert.decode_cache_from_arrays(jax.tree_util.tree_map(np.asarray, jc),
                                                       device="cpu"))
        memo[case] = out, logits, leaves, port_cache
        return memo[case]
    return get


class _Mesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}
        self.axis_names = ("data", "model")


def _coord(rank, model):
    return {"data": rank // model, "model": rank % model}


def _shard(full: np.ndarray, spec, rank, data, model) -> np.ndarray:
    """The rank's block of ``full`` under ``spec`` on a ``data × model`` mesh."""
    sizes, coord = {"data": data, "model": model}, _coord(rank, model)
    for dim, entry in enumerate(spec):
        axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
        idx, n = 0, 1
        for a in axes:
            idx, n = idx * sizes[a] + coord[a], n * sizes[a]
        step = full.shape[dim] // n
        full = full.take(np.arange(idx * step, (idx + 1) * step), axis=dim)
    return full


def _rows(full: np.ndarray, case, rank, data, model) -> np.ndarray:
    """The rank's batch rows (the batch over 'data' where it divides)."""
    if case.batch % data:
        return full
    return _shard(full, ("data",), rank, data, model)


@pytest.mark.parametrize("world,case", [c for c in CASES if c[1].prefill],
                         ids=map(_ids, [c for c in CASES if c[1].prefill]))
def test_prefill_plan_matches_the_reference_forward(worlds, reference, world, case):
    data, model = world
    cfg = W.config(case.arch)
    want = reference(case)[0]["prefill"]
    for rank in range(data * model):
        parallelism, got = worlds[world, case.name, rank]["prefill"]
        assert parallelism == "tensor-parallel"
        rows = _rows(want, case, rank, data, model)
        assert got.shape == rows.shape
        np.testing.assert_allclose(got, rows, **_tol(cfg))
        assert np.array_equal(got.argmax(-1), rows.argmax(-1))


@pytest.mark.parametrize("world,case", CASES, ids=map(_ids, CASES))
def test_decode_plan_matches_the_reference_decode(worlds, reference, world, case):
    data, model = world
    cfg = W.config(case.arch)
    _, want, _, _ = reference(case)
    for rank in range(data * model):
        parallelism, logits, _, in_place = worlds[world, case.name, rank]["decode"]
        assert parallelism == "tensor-parallel" and in_place
        for got, full in zip(logits, want):
            rows = _rows(full, case, rank, data, model)
            assert got.shape == rows.shape
            np.testing.assert_allclose(got, rows, **_tol(cfg))
            assert np.array_equal(got.argmax(-1), rows.argmax(-1))


@pytest.mark.parametrize("world,case", CASES, ids=map(_ids, CASES))
def test_decode_cache_shards_match_the_reference_cache(worlds, reference, world, case):
    """Each rank's cache leaf is its shard of the reference's new cache, of
    the spec's shape (nothing gathered whole); int8 codes exactly."""
    data, model = world
    cfg = W.config(case.arch)
    _, _, want, port_cache = reference(case)
    specs = {}
    map_with_path(lambda path, sh: specs.__setitem__(path, tuple(sh.spec)),
                  decode_cache_shardings(port_cache, _Mesh(data, model)))
    assert set(specs) == set(want)
    for rank in range(data * model):
        local = worlds[world, case.name, rank]["decode"][2]
        assert set(local) == set(want)
        for path, (got, _) in local.items():
            full = want[path]
            shard = _shard(full, specs[path] + (None,) * (full.ndim - len(specs[path])),
                           rank, data, model)
            assert got.shape == shard.shape, (path, got.shape, shard.shape)
            if got.dtype == np.int8:
                assert np.array_equal(got, shard), path
            else:
                np.testing.assert_allclose(got, shard, **_tol(cfg), err_msg=path)


def test_the_worlds_place_the_layouts_they_name():
    """The cases cut what their comments say: kv heads, T over 'model', over
    'data' and over both, the SSM channels and heads."""
    def spec(world, arch, batch, path):
        out = {}
        cache = W.prefilled_cache(W.config(arch), W.Case(arch, batch))
        map_with_path(lambda p, sh: out.__setitem__(p, tuple(sh.spec)),
                      decode_cache_shardings(cache, _Mesh(*world)))
        return out[path]
    assert spec((1, 2), "qwen3-0.6b", 2, "kv/k") == (None, "data", None, "model", None)
    assert spec((1, 4), "qwen3-0.6b", 2, "kv/k") == (None, "data", "model", None, None)
    assert spec((2, 2), "qwen3-0.6b", 1, "kv/k") == (None, None, "data", "model", None)
    assert spec((2, 2), "qwen3-0.6b:kv1", 1, "kv/k") == (None, None, ("data", "model"), None,
                                                         None)
    assert spec((1, 4), "hymba-1.5b", 2, "kv/k")[2] == "model"
    assert spec((1, 4), "hymba-1.5b", 2, "global_kv/k")[2] == "model"
    assert spec((1, 4), "mamba2-1.3b", 2, "ssm/conv")[3] == "model"
    assert spec((1, 4), "mamba2-1.3b", 2, "ssm/state")[3] == "model"
    assert spec((1, 4), "mamba2-1.3b:head64", 2, "ssm/conv")[3] == "model"
    assert spec((1, 4), "mamba2-1.3b:head64", 2, "ssm/state")[3] is None
