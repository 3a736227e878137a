"""repro_torch.serve against repro.serve: the same requests on session states
carried across with repro_torch.convert give equal post rasters and words
and weights within rtol=1e-5, atol=1e-6; plus the port's own serving
contracts (interleaved ≡ solo, 1 B/neuron, LRU, eval traffic, async drain,
the launcher)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as J
from repro.core.engine import EngineConfig as JEngineConfig
from repro_torch import serve as T
from repro_torch.convert import session_state_from_arrays, session_state_to_numpy
from repro_torch.core.engine import EngineConfig as TEngineConfig
from repro_torch.launch import serve as launcher

TOL = dict(rtol=1e-5, atol=1e-6)
N_PRE, N_POST = 16, 8


def _rasters(seed, count, t, rate=0.15):
    rng = np.random.default_rng(seed)
    return [(rng.random((t, N_PRE)) < rate).astype(np.float32) for _ in range(count)]


def _assert_state_close(jstate, tstate):
    for jw, tw in zip((*jstate.pre_words, *jstate.post_words),
                      (*tstate.pre_words, *tstate.post_words)):
        np.testing.assert_array_equal(np.asarray(jw), tw.numpy())
    np.testing.assert_allclose(tstate.w.numpy(), np.asarray(jstate.w), **TOL)
    np.testing.assert_allclose(tstate.v.numpy(), np.asarray(jstate.v), **TOL)
    np.testing.assert_allclose(tstate.theta.numpy(), np.asarray(jstate.theta), **TOL)
    assert int(jstate.t) == tstate.t


def _assert_state_equal(a, b):
    for x, y in zip((a.w, *a.pre_words, *a.post_words, a.v, a.theta),
                    (b.w, *b.pre_words, *b.post_words, b.v, b.theta)):
        assert torch.equal(x, y)
    assert a.t == b.t


@pytest.mark.parametrize("backends", (("reference", "reference"),
                                      ("fused_interpret", "fused"),
                                      ("fused_interpret", "fused_interpret")))
def test_serve_step_matches_reference_on_carried_states(backends):
    jb, tb = backends
    t = 6
    jstore = J.SessionStore(JEngineConfig(n_pre=N_PRE, n_post=N_POST, backend=jb))
    tstore = T.SessionStore(TEngineConfig(n_pre=N_PRE, n_post=N_POST, backend=tb),
                            device="cpu")
    scfg_j = J.ServeConfig(max_batch=4, t_steps=t, theta_plus=0.05)
    scfg_t = T.ServeConfig(max_batch=4, t_steps=t, theta_plus=0.05)
    sids = ("alice", "bob", "carol")
    ras = _rasters(1, 9, t)

    # slice 1 on the reference only, then carry every session into the port
    J.serve_step(jstore, [J.Request(s, r) for s, r in zip(sids, ras[:3])], scfg_j)
    for sid in sids:
        tstore.put(sid, session_state_from_arrays(jstore.peek(sid), device="cpu"))

    # slice 2 on both, two of four lanes padded: the packages' pad sessions
    # differ, the real lanes do not
    reqs = list(zip(sids[:2], ras[3:5]))
    rj = J.serve_step(jstore, [J.Request(s, r) for s, r in reqs], scfg_j)
    rt = T.serve_step(tstore, [T.Request(s, r) for s, r in reqs], scfg_t)
    spikes = 0
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(np.asarray(a.post), b.post)
        spikes += int(b.post.sum())
    assert 0 < spikes < 2 * t * N_POST, "the load should spike sparsely"
    for sid in sids:
        _assert_state_close(jstore.peek(sid), tstore.peek(sid))

    # carry the port's states back; slice 3 on both
    for sid in sids:
        w, pre, post, v, theta, steps = session_state_to_numpy(tstore.peek(sid))
        jstore.put(sid, J.SessionState(jnp.asarray(w), tuple(map(jnp.asarray, pre)),
                                       tuple(map(jnp.asarray, post)), jnp.asarray(v),
                                       jnp.asarray(theta), jnp.asarray(steps)))
    reqs = list(zip(sids, ras[5:8]))
    rj = J.serve_step(jstore, [J.Request(s, r) for s, r in reqs], scfg_j)
    rt = T.serve_step(tstore, [T.Request(s, r) for s, r in reqs], scfg_t)
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(np.asarray(a.post), b.post)
    for sid in sids:
        _assert_state_close(jstore.peek(sid), tstore.peek(sid))


@pytest.mark.parametrize("backend", ("reference", "fused"))
def test_interleaved_matches_solo_bitwise(backend):
    cfg = TEngineConfig(n_pre=N_PRE, n_post=N_POST, backend=backend)
    scfg = T.ServeConfig(max_batch=4, t_steps=6, theta_plus=0.05)
    ras = _rasters(2, 6, 6)
    inter = T.Server(cfg, scfg, device="cpu")
    t0 = inter.submit(T.Request("alice", ras[0]))
    inter.submit(T.Request("bob", ras[1]))
    inter.submit(T.Request("carol", ras[2]))
    inter.step()
    t1 = inter.submit(T.Request("alice", ras[3]))
    inter.submit(T.Request("bob", ras[4]))
    inter.step()
    solo = T.Server(cfg, scfg, device="cpu")
    s0 = solo.submit(T.Request("alice", ras[0]))
    solo.step()
    s1 = solo.submit(T.Request("alice", ras[3]))
    solo.step()
    np.testing.assert_array_equal(inter.poll(t0).post, solo.poll(s0).post)
    np.testing.assert_array_equal(inter.poll(t1).post, solo.poll(s1).post)
    _assert_state_equal(inter.store.peek("alice"), solo.store.peek("alice"))


def test_one_byte_per_neuron_plasticity_cache():
    cfg = TEngineConfig(n_pre=N_PRE, n_post=N_POST)
    store = T.SessionStore(cfg, device="cpu")
    jstore = J.SessionStore(JEngineConfig(n_pre=N_PRE, n_post=N_POST))
    state = store.init("u")
    assert store.plan.words_per_neuron() == 1
    assert all(x.dtype == torch.uint8 for x in (*state.pre_words, *state.post_words))
    assert store.state_bytes_per_session() == N_PRE + N_POST == jstore.state_bytes_per_session()
    assert store.resident_bytes_per_session() == jstore.resident_bytes_per_session()
    assert store.sessions_per_gb() == jstore.sessions_per_gb()


def test_store_lru_and_deterministic_init():
    cfg = TEngineConfig(n_pre=N_PRE, n_post=N_POST)
    store = T.SessionStore(cfg, capacity=2, device="cpu")
    a = store.init("a")
    store.init("b")
    store.get("a")
    store.init("c")                       # evicts b, the least recently used
    assert store.session_ids == ("a", "c")
    other = T.SessionStore(cfg, device="cpu")
    assert torch.equal(other.init("a").w, a.w)
    assert not torch.equal(other.init("b").w, a.w)
    assert not torch.equal(T.SessionStore(cfg, seed=1, device="cpu").init("a").w, a.w)
    for bad in ("", "x/y"):
        with pytest.raises(ValueError, match="invalid session id"):
            store.init(bad)
    with pytest.raises(ValueError, match="capacity"):
        T.SessionStore(cfg, capacity=0, device="cpu")


def test_eval_traffic_and_batch_validation():
    cfg = TEngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused")
    scfg = T.ServeConfig(max_batch=2, t_steps=4)
    store = T.SessionStore(cfg, device="cpu")
    ras = _rasters(3, 3, 4)
    T.serve_step(store, [T.Request("u", ras[0])], scfg)
    before = store.peek("u")
    res = T.serve_step(store, [T.Request("u", ras[1], learn=False)], scfg)
    assert not res[0].learned and res[0].post.shape == (4, N_POST)
    _assert_state_equal(store.peek("u"), before)
    with pytest.raises(ValueError, match="exceeds max_batch"):
        T.serve_step(store, [T.Request(s, ras[0]) for s in "abc"], scfg)
    with pytest.raises(ValueError, match="duplicate session"):
        T.serve_step(store, [T.Request("u", ras[0]), T.Request("u", ras[1])], scfg)
    with pytest.raises(ValueError, match="mixed learn"):
        T.serve_step(store, [T.Request("u", ras[0]), T.Request("v", ras[1], learn=False)], scfg)
    with pytest.raises(ValueError, match="raster shape"):
        T.serve_step(store, [T.Request("u", ras[0][:2])], scfg)
    with pytest.raises(ValueError, match="max_batch"):
        T.ServeConfig(max_batch=0)


def test_async_server_drain_matches_sync_stepping():
    cfg = TEngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused")
    scfg = T.ServeConfig(max_batch=3, t_steps=5, theta_plus=0.05)
    ras = _rasters(4, 10, 5)
    load = [T.Request(f"u{i % 4}", r, learn=i != 7) for i, r in enumerate(ras)]

    sync = T.Server(cfg, scfg, device="cpu")
    ts = [sync.submit(r) for r in load]
    assert sync.pending == len(load)
    assert sync.drain() == len(load)
    threaded = T.Server(cfg, scfg, device="cpu")
    threaded.start()
    tt = [threaded.submit(r) for r in load]
    threaded.shutdown(drain=True)
    assert sync.batches == threaded.batches > 0
    for a, b in zip(ts, tt):
        ra, rb = sync.poll(a), threaded.poll(b)
        assert ra is not None and rb is not None and ra.sid == rb.sid
        np.testing.assert_array_equal(ra.post, rb.post)
        assert sync.poll(a) is None            # a ticket is redeemed once
    for sid in sync.store.session_ids:
        _assert_state_equal(sync.store.peek(sid), threaded.store.peek(sid))


def test_launcher_serves_on_cpu(capsys):
    launcher.main(["--device", "cpu", "--backend", "fused", "--n-pre", "32",
                   "--n-post", "8", "--sessions", "3", "--requests", "7",
                   "--t-steps", "4", "--max-batch", "2", "--theta-plus", "0.05"])
    out = capsys.readouterr().out
    assert "served 7/7 requests" in out
    assert "plasticity cache: 40 B/session" in out
    with pytest.raises(SystemExit):
        launcher.main(["--device", "cpu", "--rule", "bogus"])
    launcher.main(["--device", "cpu", "--rule", "mstdp"])
    out = capsys.readouterr().out
    assert "served 32/32 requests" in out and "rule=mstdp" in out
    assert "plasticity cache: 160 B/session" in out          # 2 B × (64 + 16)


def test_lru_eviction_and_capacity():
    jstore = J.SessionStore(JEngineConfig(n_pre=N_PRE, n_post=N_POST), capacity=2)
    store = T.SessionStore(TEngineConfig(n_pre=N_PRE, n_post=N_POST), capacity=2,
                           device="cpu")
    for s in (jstore, store):
        s.init("a")
        s.init("b")
        s.get("a")                       # refresh: b is now LRU
        s.init("c")                      # evicts b
        assert s.session_ids == ("a", "c")
        assert "b" not in s and len(s) == 2
        s.touch("a")                     # c is now LRU, a not read
        assert s.evict() == "c"
    assert store.session_ids == jstore.session_ids == ("a",)


def test_server_cfg_is_the_store_cfg():
    cfg = TEngineConfig(n_pre=N_PRE, n_post=N_POST, backend="fused")
    server = T.Server(cfg, T.ServeConfig(max_batch=2, t_steps=4), device="cpu")
    assert server.cfg is server.store.cfg is cfg
    jcfg = JEngineConfig(n_pre=N_PRE, n_post=N_POST)
    assert J.Server(jcfg, J.ServeConfig(max_batch=2, t_steps=4)).cfg is jcfg
