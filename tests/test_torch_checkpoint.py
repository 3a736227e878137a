"""repro_torch.checkpoint and repro_torch.distributed.fault_tolerance against
repro.checkpoint and repro.distributed.fault_tolerance: the nine tests of
tests/test_checkpoint.py on trees made from a numpy seed, the two packages'
manifests equal leaf for leaf (names, shapes, dtypes, sha256) for equal trees
and equal session stores, and each package's checkpoint restored by the
other."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as JC
from repro import serve as J
from repro.core.engine import EngineConfig as JEngineConfig
from repro.core.history import SpikeHistory as JSpikeHistory
from repro_torch import serve as T
from repro_torch.checkpoint import (AsyncCheckpointer, latest_checkpoint, list_checkpoints,
                                    load_manifest, prune_checkpoints, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import session_state_from_arrays
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.core.history import SpikeHistory
from repro_torch.distributed import (FailureInjector, RunnerConfig, TrainingRunner, Watchdog,
                                     elastic_reshard)
from repro_torch.tree import tree_leaves


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 8)).astype(np.float32),
            "opt": {"mu": np.zeros((8, 8), np.float32), "step": np.asarray(3, np.int32)}}


def _tree(seed=0):
    return {"w": torch.from_numpy(_arrays(seed)["w"]),
            "opt": {"mu": torch.zeros((8, 8)), "step": torch.tensor(3, dtype=torch.int32)}}


def _target():
    return {"w": torch.zeros((8, 8)),
            "opt": {"mu": torch.ones((8, 8)), "step": torch.tensor(0, dtype=torch.int32)}}


def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    save_checkpoint(str(tmp_path), 7, t)
    r = restore_checkpoint(str(tmp_path), 7, _target())
    for a, b in zip(tree_leaves(t), tree_leaves(r)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checksum_detects_corruption(tmp_path):
    t = _tree()
    path = save_checkpoint(str(tmp_path), 1, t)
    victim = os.path.join(path, "w.npy")
    arr = np.load(victim)
    arr[0, 0] += 1.0
    np.save(victim, arr)
    with pytest.raises(IOError, match="checksum"):
        restore_checkpoint(str(tmp_path), 1, _target())


def test_latest_and_prune(tmp_path):
    t = _tree()
    for s in (1, 5, 9, 12):
        save_checkpoint(str(tmp_path), s, t)
    assert latest_checkpoint(str(tmp_path)) == 12
    prune_checkpoints(str(tmp_path), keep=2)
    assert list_checkpoints(str(tmp_path)) == [9, 12]
    assert latest_checkpoint(str(tmp_path / "nothing")) is None


def test_partial_write_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 3, _tree())
    os.makedirs(str(tmp_path / "step_000000009.tmp"))   # a crash mid-save
    os.makedirs(str(tmp_path / "step_000000010"))       # committed-looking, no manifest
    assert latest_checkpoint(str(tmp_path)) == 3


def test_async_checkpointer(tmp_path):
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    t = _tree()
    for s in (2, 4, 6):
        ck.save(s, t)
    ck.wait()
    assert latest_checkpoint(str(tmp_path)) == 6
    assert len(list_checkpoints(str(tmp_path))) <= 2


def test_async_snapshot_is_a_copy(tmp_path):
    """An in-place write after save() does not reach the saved state: the host
    snapshot of a CPU tensor is a copy, not a view of its storage."""
    t = _tree()
    want = t["w"].clone()
    ck = AsyncCheckpointer(str(tmp_path))
    ck.save(1, t)
    t["w"].add_(1.0)
    ck.wait()
    r = restore_checkpoint(str(tmp_path), 1, _target())
    assert torch.equal(r["w"], want)


def test_watchdog_flags_straggler():
    now = [0.0]
    wd = Watchdog(threshold=3.0, clock=lambda: now[0])
    for step in range(12):
        wd.start()
        now[0] += 1.0          # normal step: 1 s
        assert not wd.stop(step)
    wd.start()
    now[0] += 10.0             # straggler: 10 s > 3 × median(1 s)
    assert wd.stop(12)
    assert wd.stragglers[0][0] == 12


def _counter_step(state, batch):
    new = {"x": state["x"] + batch["v"], "n": state["n"] + 1}
    return new, {"loss": torch.sum(new["x"])}


def _batch_fn(step):
    return {"v": torch.full((4,), float(step + 1))}


def _state0():
    return {"x": torch.zeros((4,)), "n": torch.tensor(0, dtype=torch.int32)}


def test_runner_restart_is_deterministic(tmp_path):
    """Failure + restore + replay ≡ an uninterrupted run (step-keyed data)."""
    clean = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / "clean"), ckpt_every=3),
                           _counter_step, _batch_fn)
    s_clean = clean.run(_state0(), 10)
    faulty = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path / "faulty"), ckpt_every=3),
                            _counter_step, _batch_fn)
    s_faulty = faulty.run(_state0(), 10, FailureInjector({7}))
    assert faulty.restarts == 1
    assert torch.equal(s_clean["x"], s_faulty["x"])
    assert int(s_faulty["n"]) == 10
    assert {"event": "restart", "resume_step": 6,
            "cause": "injected node failure at step 7"} in faulty.log
    assert sum("step" in e for e in faulty.log) == 10 + 1       # steps 6 replayed
    assert latest_checkpoint(str(tmp_path / "faulty")) == 10


def test_runner_gives_up_after_max_restarts(tmp_path):
    runner = TrainingRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=100,
                                         max_restarts=2), _counter_step, _batch_fn)

    class AlwaysFail(FailureInjector):
        def maybe_fail(self, step):
            if step == 3:
                raise RuntimeError("persistent failure")

    with pytest.raises(RuntimeError, match="max_restarts"):
        runner.run(_state0(), 10, AlwaysFail())


def test_manifest_schema(tmp_path):
    path = save_checkpoint(str(tmp_path), 2, _tree(), extra={"mesh": "16x16"})
    with open(os.path.join(path, "manifest.json")) as f:
        m = json.load(f)
    assert m["step"] == 2
    assert m["extra"]["mesh"] == "16x16"
    names = {leaf["name"] for leaf in m["leaves"]}
    assert "w" in names and any("mu" in n for n in names)
    for leaf in m["leaves"]:
        assert set(leaf) == {"name", "shape", "dtype", "sha256"}


# ---------------------------------------------------------------------------
# the two packages write the same checkpoint
# ---------------------------------------------------------------------------

def _jtree(arrays):
    return {"w": jnp.asarray(arrays["w"]),
            "opt": {"mu": jnp.asarray(arrays["opt"]["mu"]),
                    "step": jnp.asarray(arrays["opt"]["step"])},
            "hist": JSpikeHistory(planes=jnp.asarray(arrays["planes"]),
                                  head=jnp.asarray(arrays["head"]))}


def _ttree(arrays):
    return {"w": torch.from_numpy(arrays["w"]),
            "opt": {"mu": torch.from_numpy(arrays["opt"]["mu"]),
                    "step": torch.from_numpy(arrays["opt"]["step"])},
            "hist": SpikeHistory(planes=torch.from_numpy(arrays["planes"]),
                                 head=torch.from_numpy(arrays["head"]))}


def _mixed_arrays(seed=0):
    rng = np.random.default_rng(seed)
    return dict(_arrays(seed), planes=rng.integers(0, 2, (7, 13)).astype(np.uint8),
                head=np.asarray(4, np.int32))


def test_manifest_leaves_equal_the_reference(tmp_path):
    """Dicts, a NamedTuple and 0-d leaves: the same names (``hist__.planes``),
    shapes, dtypes and checksums from both packages."""
    arrays = _mixed_arrays()
    JC.save_checkpoint(str(tmp_path / "jax"), 4, _jtree(arrays), extra={"k": 1})
    save_checkpoint(str(tmp_path / "torch"), 4, _ttree(arrays), extra={"k": 1})
    mj = JC.load_manifest(str(tmp_path / "jax"), 4)
    mt = load_manifest(str(tmp_path / "torch"), 4)
    assert mt == mj
    assert [leaf["name"] for leaf in mt["leaves"]] == [
        "hist__.planes", "hist__.head", "opt__mu", "opt__step", "w"]


def _served_stores(rule):
    """A JAX SessionStore after two batches, and the port's store holding the
    same sessions carried across with convert.session_state_from_arrays."""
    jcfg = JEngineConfig(n_pre=16, n_post=8, rule=rule)
    jstore = J.SessionStore(jcfg)
    scfg = J.ServeConfig(max_batch=2, t_steps=4, theta_plus=0.05)
    rng = np.random.default_rng(5)
    for sids in (("u0", "u1"), ("u2", "u0")):
        J.serve_step(jstore, [J.Request(s, (rng.random((4, 16)) < 0.3).astype(np.float32))
                              for s in sids], scfg)
    tstore = T.SessionStore(TEngineConfig(n_pre=16, n_post=8, rule=rule), device="cpu")
    for sid in jstore.session_ids:
        tstore.put(sid, session_state_from_arrays(jstore.peek(sid), device="cpu"))
    return jstore, tstore


@pytest.mark.parametrize("rule", ("itp", "exact", "mstdp"))
def test_session_store_manifest_equals_the_reference(tmp_path, rule):
    jstore, tstore = _served_stores(rule)
    jstore.checkpoint(str(tmp_path / "jax"))
    tstore.checkpoint(str(tmp_path / "torch"))
    mj = JC.load_manifest(str(tmp_path / "jax"), 0)
    mt = load_manifest(str(tmp_path / "torch"), 0)
    assert mt == mj
    names = [leaf["name"] for leaf in mt["leaves"]]
    assert {"u0__.w", "u0__.pre_words__0", "u0__.post_words__0", "u0__.v", "u0__.theta",
            "u0__.t"} <= set(names)
    assert mt["extra"]["sessions"] == ["u1", "u2", "u0"]
    t_leaf = next(leaf for leaf in mt["leaves"] if leaf["name"] == "u0__.t")
    assert t_leaf["shape"] == [] and t_leaf["dtype"] == "int32"


def test_reference_checkpoint_restores_in_the_port_and_back(tmp_path):
    arrays = _mixed_arrays(1)
    JC.save_checkpoint(str(tmp_path / "jax"), 1, _jtree(arrays))
    target = _ttree(_mixed_arrays(2))
    got = restore_checkpoint(str(tmp_path / "jax"), 1, target)
    assert isinstance(got["hist"], SpikeHistory)
    for a, b in zip(tree_leaves(got), tree_leaves(_ttree(arrays))):
        assert a.dtype == b.dtype and torch.equal(a, b)

    save_checkpoint(str(tmp_path / "torch"), 3, got)
    back = JC.restore_checkpoint(str(tmp_path / "torch"), 3, _jtree(_mixed_arrays(2)))
    assert isinstance(back["hist"], JSpikeHistory)
    np.testing.assert_array_equal(np.asarray(back["hist"].planes), arrays["planes"])
    np.testing.assert_array_equal(np.asarray(back["w"]), arrays["w"])
    assert np.asarray(back["opt"]["step"]).dtype == np.int32


def test_int_leaves_and_restore_placement(tmp_path):
    """A Python int is saved as a 0-d int32 and comes back an int; ``device=``
    places every tensor; a target leaf's own device is the default."""
    save_checkpoint(str(tmp_path), 0, {"t": 7, "x": torch.arange(3.0)})
    m = load_manifest(str(tmp_path), 0)
    assert [(leaf["name"], leaf["dtype"], leaf["shape"]) for leaf in m["leaves"]] == [
        ("t", "int32", []), ("x", "float32", [3])]
    r = restore_checkpoint(str(tmp_path), 0, {"t": 0, "x": torch.zeros(3)}, device="cpu")
    assert r["t"] == 7 and type(r["t"]) is int
    assert torch.equal(r["x"], torch.arange(3.0)) and r["x"].device.type == "cpu"
    with pytest.raises(IOError, match="missing leaf"):
        restore_checkpoint(str(tmp_path), 0, {"other": torch.zeros(3)})


def test_elastic_reshard_keeps_structure():
    state = {"hist": SpikeHistory(planes=torch.ones((2, 3), dtype=torch.uint8),
                                  head=torch.tensor(1)), "t": 4}
    moved = elastic_reshard(state, "cpu")
    assert isinstance(moved["hist"], SpikeHistory) and moved["t"] == 4
    assert torch.equal(moved["hist"].planes, state["hist"].planes)
