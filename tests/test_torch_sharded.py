"""The weight-sharded engine of repro_torch (core/engine_sharded.py over
distributed/sharding.py) against the unsharded engines of both packages, and
pod_mean_tree against the JAX package's codec.

The reference's own sharded cells fail on this jax (ROADMAP caveats), so the
cells of tests/test_distributed.py:322-370 and tests/test_sparse_backend.py:186
run here on a 1 × 1 gloo group in-process, held against the port's unsharded
run_engine (bit for bit) and the JAX package's (post spikes exact, weights
within rtol=1e-5, atol=1e-6).  The 2 × 2 grid (tests/test_distributed.py:377's
script) runs in four spawned gloo processes, and pod_mean_tree in two.  Every
group is set up through a FileStore under the test's temporary directory and
destroyed in a ``finally``; every spawned process is joined with a timeout
and the test fails rather than hangs."""
import multiprocessing
import queue as queue_mod

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import test_torch_sharded_workers as W
from repro.core import engine as JE
from repro.distributed import compression as JC
from repro_torch.core.engine import EngineConfig, init_engine, run_engine
from repro_torch.core.engine_sharded import make_sharded_engine_step, shard_engine_state
from repro_torch.distributed.sharding import (EngineGrid, backend_for, init_process_group,
                                              make_grid)
from repro_torch.tree import tree_leaves

TOL = dict(rtol=1e-5, atol=1e-6)
JOIN_SECONDS = 120


@pytest.fixture
def grid11(tmp_path):
    init_process_group("cpu", rank=0, world_size=1,
                       store=dist.FileStore(str(tmp_path / "store"), 1))
    try:
        yield make_grid(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def _jax_run(cfg_kw, jbackend, w0, train):
    jcfg = JE.EngineConfig(backend=jbackend, **cfg_kw)
    jstate, jpost = JE.run_engine(JE.init_engine(None, jcfg, jnp.asarray(w0)),
                                  jnp.asarray(train), jcfg)
    return np.asarray(jstate.w), np.asarray(jpost)


def _sharded_run(cfg, grid, w0, train):
    state = shard_engine_state(init_engine(cfg, w0, device="cpu"), grid)
    step = make_sharded_engine_step(cfg, grid)
    posts = []
    for x in torch.from_numpy(train):
        state, post = step(state, x)
        posts.append(post)
    return state, torch.stack(posts)


def _inputs(seed, n_pre, n_post, t, rate, w_hi):
    rng = np.random.default_rng(seed)
    w0 = rng.uniform(0.0, w_hi, (n_pre, n_post)).astype(np.float32)
    return w0, (rng.random((t, n_pre)) < rate).astype(np.float32)


# (reference backend, rule) of tests/test_distributed.py:322; the port runs
# "fused" where the reference runs "fused_interpret" (the kernel wrapper runs
# its plain version on CPU tensors).  The reference's fused counter kernel
# fails on this jax, so the counter cells are held against its reference
# backend.
CELLS = (("reference", "itp"), ("reference", "exact"), ("fused_interpret", "itp"),
         ("fused_interpret", "itp_nocomp"), ("fused_interpret", "exact"),
         ("fused_interpret", "linear"), ("fused_interpret", "imstdp"))
COUNTERS = ("exact", "linear", "imstdp")


def _check_cell(grid, cfg_kw, port_backend, jbackend, w0, train):
    cfg = EngineConfig(backend=port_backend, **cfg_kw)
    st, post = _sharded_run(cfg, grid, w0, train)
    ref_st, ref_post = run_engine(init_engine(cfg, w0, device="cpu"),
                                  torch.from_numpy(train), cfg)
    assert torch.equal(post, ref_post) and torch.equal(st.w, ref_st.w)
    assert torch.equal(st.neurons.v, ref_st.neurons.v)
    jw, jpost = _jax_run(cfg_kw, jbackend, w0, train)
    np.testing.assert_array_equal(jpost, post.numpy())
    np.testing.assert_allclose(st.w.numpy(), jw, **TOL)
    return float(post.float().mean())


@pytest.mark.parametrize("backend,rule", CELLS, ids=[f"{b}-{r}" for b, r in CELLS])
def test_sharded_engine_parity_single_device(grid11, backend, rule):
    w0, train = _inputs(0, 16, 8, 20, 0.4, 0.2)
    port_backend = "fused" if backend == "fused_interpret" else backend
    jbackend = "reference" if rule in COUNTERS else backend
    rate = _check_cell(grid11, dict(n_pre=16, n_post=8, eta=0.25, rule=rule),
                       port_backend, jbackend, w0, train)
    assert 0 < rate < 1, "the posts should fire sparsely"


def test_sharded_engine_quantised_single_device(grid11):
    w0, train = _inputs(1, 8, 8, 12, 0.4, 0.3)
    _check_cell(grid11, dict(n_pre=8, n_post=8, eta=0.5, quantise=True), "fused",
                "fused_interpret", w0, train)


@pytest.mark.parametrize("max_events", [None, 5])
def test_sharded_engine_sparse_parity_single_device(grid11, max_events):
    w0, train = _inputs(2, 24, 16, 40, 0.3, 0.2)
    _check_cell(grid11, dict(n_pre=24, n_post=16, max_events=max_events), "sparse",
                "sparse", w0, train)


def test_mstdp_sharded_engine_single_device(grid11):
    """mstdp's rows (a Rank1Rule view, sliced along the neuron axis) against
    the port's unsharded engine and the reference's."""
    w0, train = _inputs(3, 16, 8, 20, 0.4, 0.2)
    _check_cell(grid11, dict(n_pre=16, n_post=8, eta=0.25, rule="mstdp"), "fused",
                "fused_interpret", w0, train)


def test_grid_refuses_what_does_not_fit(grid11):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        make_grid(2, 2, device="cpu")
    with pytest.raises(ValueError, match="does not tile"):
        EngineGrid(data=2, model=1, rank=0, device=torch.device("cpu"), row_group=None,
                   col_group=None).tile(15, 8)
    with pytest.raises(ValueError, match="needs 'nccl'"):
        make_grid(1, 1, device="cuda")
    assert backend_for("cuda") == "nccl" and backend_for("cpu") == "gloo"
    with pytest.raises(ValueError, match="no process-group backend"):
        backend_for("meta")


def _spawn(target, world, store_path, *args, expect):
    """Run ``target(rank, store_path, *args, queue)`` in ``world`` spawned
    processes; returns the ``expect`` items they put on the queue (drained
    before the joins), failing if any process hangs or fails."""
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, store_path, *args, q)) for r in range(world)]
    for p in procs:
        p.start()
    try:
        items = [q.get(timeout=JOIN_SECONDS) for _ in range(expect)]
    except queue_mod.Empty:
        items = None
    for p in procs:
        p.join(timeout=JOIN_SECONDS)
    hung = [p.pid for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=10)
    assert not hung, f"processes {hung} did not finish within {JOIN_SECONDS} s"
    assert [p.exitcode for p in procs] == [0] * world
    assert items is not None, "a worker put no result"
    return items


@pytest.fixture(scope="module")
def grid22(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("grid22") / "store")
    items = _spawn(W.grid_worker, 4, path, 2, 2, expect=4 * len(W.GRID_CASES))
    return {(rule, backend, rank): (w, post) for rank, rule, backend, w, post in items}


@pytest.mark.parametrize("rule,backend", W.GRID_CASES)
def test_sharded_engine_on_a_2x2_grid_matches_run_engine(grid22, rule, backend):
    w0, train = W.grid_inputs()
    cfg = EngineConfig(rule=rule, backend=backend, **W.GRID_ENGINE)
    ref_st, ref_post = run_engine(init_engine(cfg, w0, device="cpu"),
                                  torch.from_numpy(train), cfg)
    jbackend = {"fused": "fused_interpret"}.get(backend, backend)
    jw, jpost = _jax_run(W.GRID_ENGINE, "reference" if rule in COUNTERS else jbackend,
                         w0, train)
    assert 0 < ref_post.float().mean() < 1, "the posts should fire sparsely"
    tiles = {}
    for rank in range(4):
        w, post = grid22[rule, backend, rank]
        np.testing.assert_array_equal(post, ref_post.numpy())
        np.testing.assert_array_equal(post, jpost)
        tiles[divmod(rank, 2)] = w
    w = np.block([[tiles[0, 0], tiles[0, 1]], [tiles[1, 0], tiles[1, 1]]])
    np.testing.assert_allclose(w, ref_st.w.numpy(), **TOL)
    np.testing.assert_allclose(w, jw, **TOL)


def test_pod_mean_tree_on_two_ranks(tmp_path):
    items = _spawn(W.pod_mean_worker, 2, str(tmp_path / "store"), 2, expect=2)
    grads = [W.pod_mean_grads(r) for r in range(2)]
    for leaf in range(2):
        xs = [tree_leaves(g)[leaf] for g in grads]
        codec = [np.asarray(JC._decode_int8(JC._encode_int8(jnp.asarray(x)))) for x in xs]
        want = np.mean(np.stack(codec), axis=0)
        for _, comp, plain in items:
            np.testing.assert_array_equal(tree_leaves(comp)[leaf], want)
            np.testing.assert_allclose(tree_leaves(plain)[leaf], np.mean(np.stack(xs), axis=0),
                                       rtol=1e-6, atol=0)
