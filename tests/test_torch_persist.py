"""Session checkpointing and the launcher's engine mode of repro_torch against
repro: the checkpoint cases of tests/test_serve.py; a JAX Server checkpoint
restored into the port's Server (and the port's into JAX's) continues as the
reference does, for itp, exact and mstdp (post rasters and words exact,
weights within rtol=1e-5, atol=1e-6); the --ckpt-dir launcher round trip; and
the five engine-mode launcher tests of the reference."""
import argparse
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as J
from repro.core.engine import EngineConfig as JEngineConfig
from repro.launch.train import run_engine_training as j_run_engine_training
from repro_torch import serve as T
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.launch import serve as launcher
from repro_torch.launch import train as launch_train

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-5, atol=1e-6)
N_PRE, N_POST, T_STEPS = 16, 8, 4


def _cfg(rule="itp", backend="reference", **kw):
    return TEngineConfig(n_pre=N_PRE, n_post=N_POST, rule=rule, backend=backend, **kw)


def _rasters(seed, count, rate=0.3):
    rng = np.random.default_rng(seed)
    return [(rng.random((T_STEPS, N_PRE)) < rate).astype(np.float32) for _ in range(count)]


def _assert_state_equal(a, b):
    for x, y in zip((a.w, *a.pre_words, *a.post_words, a.v, a.theta),
                    (b.w, *b.pre_words, *b.post_words, b.v, b.theta)):
        assert x.device == y.device and torch.equal(x, y)
    assert a.t == b.t and type(a.t) is type(b.t) is int


def _assert_state_close(jstate, tstate):
    for jw, tw in zip((*jstate.pre_words, *jstate.post_words),
                      (*tstate.pre_words, *tstate.post_words)):
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    for name in ("w", "v", "theta"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)), **TOL)
    assert int(jstate.t) == tstate.t


# ---------------------------------------------------------------------------
# tests/test_serve.py: persistence
# ---------------------------------------------------------------------------

def test_checkpoint_restore_roundtrip(tmp_path):
    cfg = _cfg("mstdp")
    scfg = T.ServeConfig(max_batch=2, t_steps=T_STEPS)
    sv = T.Server(cfg, scfg, device="cpu")
    for i, r in enumerate(_rasters(0, 4)):
        sv.submit(T.Request(f"u{i % 3}", r))
    sv.drain()
    sv.checkpoint(str(tmp_path))

    sv2 = T.Server(cfg, scfg, device="cpu")
    sv2.restore(str(tmp_path))
    assert sv2.store.session_ids == sv.store.session_ids   # LRU order too
    for sid in sv.store:
        _assert_state_equal(sv.store.peek(sid), sv2.store.peek(sid))

    # restored sessions continue bit-identically
    (x,) = _rasters(99, 1)
    ta, tb = sv.submit(T.Request("u0", x)), sv2.submit(T.Request("u0", x))
    sv.step(), sv2.step()
    np.testing.assert_array_equal(sv.poll(ta).post, sv2.poll(tb).post)
    _assert_state_equal(sv.store.peek("u0"), sv2.store.peek("u0"))


@pytest.mark.parametrize("field,other", (("rule", dict(rule="exact")),
                                         ("n_pre", dict(n_pre=12)),
                                         ("n_post", dict(n_post=6)),
                                         ("depth", dict(depth=5))))
def test_restore_rejects_mismatched_config(tmp_path, field, other):
    scfg = T.ServeConfig(max_batch=1, t_steps=2)
    sv = T.Server(_cfg("itp"), scfg, device="cpu")
    sv.submit(T.Request("u", _rasters(1, 1)[0][:2]))
    sv.drain()
    sv.checkpoint(str(tmp_path))
    kw = dict(n_pre=N_PRE, n_post=N_POST, rule="itp")
    kw.update(other)
    mismatched = T.Server(TEngineConfig(**kw), scfg, device="cpu")
    with pytest.raises(ValueError, match=field):
        mismatched.restore(str(tmp_path))


def test_restore_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        T.Server(_cfg(), T.ServeConfig(), device="cpu").restore(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# across the packages: a checkpoint written by one continues in the other
# ---------------------------------------------------------------------------

# (port backend, reference backend): the port's fused kernel runs its plain
# version on CPU tensors, the reference's Pallas kernel its interpreter; the
# reference's fused counter kernel fails on this jax (ROADMAP caveats), so
# exact is held against the reference's reference backend
CELLS = {("itp", "reference"): "reference", ("itp", "fused"): "fused_interpret",
         ("exact", "reference"): "reference", ("exact", "fused"): "reference",
         ("mstdp", "reference"): "reference", ("mstdp", "fused"): "fused_interpret"}


def _serve_both(jsv, tsv, rasters, sids) -> float:
    """The same requests on both servers: post rasters exact, every session
    within the parity tolerance; returns the port's mean post rate."""
    tj = [jsv.submit(J.Request(s, r)) for s, r in zip(sids, rasters)]
    tt = [tsv.submit(T.Request(s, r)) for s, r in zip(sids, rasters)]
    jsv.drain(), tsv.drain()
    posts = []
    for a, b in zip(tj, tt):
        posts.append(tsv.poll(b).post)
        np.testing.assert_array_equal(np.asarray(jsv.poll(a).post), posts[-1])
    for sid in tsv.store.session_ids:
        _assert_state_close(jsv.store.peek(sid), tsv.store.peek(sid))
    return float(np.mean(posts))


@pytest.mark.parametrize("rule,backend", sorted(CELLS))
def test_checkpoints_cross_between_the_packages(tmp_path, rule, backend):
    jcfg = JEngineConfig(n_pre=N_PRE, n_post=N_POST, rule=rule, backend=CELLS[rule, backend])
    jscfg = J.ServeConfig(max_batch=2, t_steps=T_STEPS, theta_plus=0.05)
    tscfg = T.ServeConfig(max_batch=2, t_steps=T_STEPS, theta_plus=0.05)
    ras = _rasters(7, 12, rate=0.15)
    sids = ("a", "b", "c", "a")

    # the reference serves slice 1 and writes; the port restores; both go on
    jsv = J.Server(jcfg, jscfg)
    for s, r in zip(sids, ras[:4]):
        jsv.submit(J.Request(s, r))
    jsv.drain()
    jsv.checkpoint(str(tmp_path / "jax"))
    tsv = T.Server(_cfg(rule, backend), tscfg, device="cpu")
    tsv.restore(str(tmp_path / "jax"))
    assert tsv.store.session_ids == jsv.store.session_ids
    for sid in tsv.store.session_ids:
        j, t = jsv.store.peek(sid), tsv.store.peek(sid)
        assert torch.equal(t.w, torch.from_numpy(np.array(j.w))) and t.t == int(j.t)
    rate = _serve_both(jsv, tsv, ras[4:8], sids)
    assert 0 < rate < 1, "the load should spike sparsely"

    # the port writes; a fresh reference server restores; both go on
    tsv.checkpoint(str(tmp_path / "torch"))
    jsv2 = J.Server(jcfg, jscfg)
    jsv2.restore(str(tmp_path / "torch"))
    assert jsv2.store.session_ids == tsv.store.session_ids
    assert all(np.asarray(jsv2.store.peek(sid).t).dtype == np.int32
               for sid in tsv.store.session_ids)
    _serve_both(jsv2, tsv, ras[8:12], sids)


# ---------------------------------------------------------------------------
# the launcher's --ckpt-dir
# ---------------------------------------------------------------------------

def test_launcher_ckpt_dir_round_trip(tmp_path, capsys):
    argv = ["--device", "cpu", "--backend", "fused", "--ckpt-dir", str(tmp_path)]
    launcher.main(argv)
    out = capsys.readouterr().out
    assert f"no checkpoint under {tmp_path}; starting fresh" in out
    assert f"checkpointed 8 sessions -> {tmp_path}/step_000000000" in out
    launcher.main(argv)
    out = capsys.readouterr().out
    assert f"restored 8 sessions from {tmp_path}" in out
    assert "served 32/32 requests" in out
    assert f"checkpointed 8 sessions -> {tmp_path}/step_000000001" in out


# ---------------------------------------------------------------------------
# the launcher's engine mode: tests/test_backend.py:149,
# test_counter_backend.py:212, test_plasticity.py:115 and :287,
# test_sparse_backend.py:263
# ---------------------------------------------------------------------------

def _engine_args(**kw):
    base = dict(rule="itp", backend="fused", engine_pre=32, engine_post=32, replicas=2,
                steps=8, engine_rate=0.3, device="cpu")
    return argparse.Namespace(**{**base, **kw})


def test_launcher_engine_mode_smoke():
    summary = launch_train.run_engine_training(_engine_args())
    assert summary["rule"] == "itp" and summary["backend"] == "fused"
    assert summary["device"] == "cpu"
    assert summary["sops_per_s"] > 0
    assert np.isfinite(summary["mean_post_rate"])
    ref = j_run_engine_training(argparse.Namespace(
        rule="itp", backend="reference", engine_pre=8, engine_post=8, replicas=1, steps=2,
        engine_rate=0.3))
    assert set(summary) == set(ref) | {"device"}


def test_launcher_engine_mode_runs_fused_counter_rule():
    summary = launch_train.run_engine_training(_engine_args(rule="exact",
                                                            backend="fused_interpret"))
    assert summary["rule"] == "exact" and summary["backend"] == "fused_interpret"
    assert summary["sops_per_s"] > 0


def test_launcher_cli_rejects_bad_rule():
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--engine",
                        "--rule", "hebbian"], capture_output=True, text=True, cwd=ROOT,
                       env={"PYTHONPATH": "src", "PATH": "/usr/bin:/bin"}, timeout=120)
    assert r.returncode != 0
    assert "--rule" in r.stderr and "itp" in r.stderr


def test_launcher_engine_mode_runs_counter_rule():
    summary = launch_train.run_engine_training(_engine_args(rule="exact", backend="reference",
                                                            engine_pre=16, engine_post=16))
    assert summary["rule"] == "exact"
    assert summary["sops_per_s"] > 0


def test_launcher_engine_mode_sparse_smoke():
    summary = launch_train.run_engine_training(_engine_args(backend="sparse", max_events=8))
    assert summary["backend"] == "sparse"
    assert summary["sops_per_s"] > 0


@pytest.mark.parametrize("rule,backend", (("itp", "fused"), ("exact", "fused"),
                                          ("itp", "sparse")))
def test_engine_mode_matches_reference_backend(rule, backend):
    """Every backend of the engine mode gives the reference backend's run:
    the same seeded weights and rasters, post rasters exact, weights within
    the parity tolerance (bit-equal in practice)."""
    args = dict(rule=rule, engine_pre=24, engine_post=16, replicas=3, steps=12,
                engine_rate=0.1, seed=3)
    s_ref, st_ref, post_ref = launch_train.engine_training(_engine_args(backend="reference",
                                                                        **args))
    s, st, post = launch_train.engine_training(_engine_args(backend=backend, **args))
    assert torch.equal(post, post_ref) and 0 < s["mean_post_rate"] < 1
    np.testing.assert_allclose(st.w.numpy(), st_ref.w.numpy(), **TOL)
    assert s["mean_post_rate"] == s_ref["mean_post_rate"]


def test_launcher_main_engine_mode_and_lm_refusal(capsys, tmp_path):
    """The engine mode through ``main``; the LM mode's data-parallel mesh
    (ROADMAP item 18d, refused before it was ported) runs a one-rank group
    in this process."""
    out = launch_train.main(["--engine", "--device", "cpu", "--backend", "fused",
                             "--replicas", "2", "--engine-pre", "16", "--engine-post", "8",
                             "--steps", "4"])
    assert out["steps"] == 4 and out["replicas"] == 2 and out["n_pre"] == 16
    assert "engine training [itp / fused / cpu]" in capsys.readouterr().out
    out = launch_train.main(["--device", "cpu", "--smoke", "--data", "1", "--steps", "2",
                             "--batch", "2", "--seq", "8", "--ckpt-dir", str(tmp_path)])
    assert out["mesh"] == "data=1 × model=1" and out["steps"] == 2
    assert "mesh: data=1 × model=1" in capsys.readouterr().out
