"""repro_torch.core.history against repro.core.history: every readout
bit-exact for depth 1..8 and every ring head, per-lane heads on a batched
ring, and the word round trip."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import history as JH
from repro_torch.core import history as TH

DEPTHS = list(range(1, 9))


def _eq(jax_arr, torch_arr):
    np.testing.assert_array_equal(np.asarray(jax_arr), torch_arr.numpy())


def _pair(planes: np.ndarray, head: int):
    j = JH.SpikeHistory(planes=jnp.asarray(planes), head=jnp.asarray(head, jnp.int32))
    t = TH.SpikeHistory(planes=torch.from_numpy(planes), head=torch.tensor(head))
    return j, t


@pytest.mark.parametrize("depth", DEPTHS)
def test_push_trajectory_matches_reference(depth):
    rng = np.random.default_rng(depth)
    n = 13
    jh, th = JH.init_history(n, depth), TH.init_history(n, depth)
    _eq(jh.planes, th.planes)
    for _ in range(2 * depth + 3):
        s = rng.random(n) < 0.4
        jh, th = JH.push(jh, jnp.asarray(s)), TH.push(th, torch.from_numpy(s))
        _eq(jh.planes, th.planes)
        assert int(jh.head) == int(th.head)
        _eq(JH.pack_words(jh), TH.pack_words(th))
        _eq(JH.latest(jh), TH.latest(th))


@pytest.mark.parametrize("depth", DEPTHS)
def test_readouts_at_every_head(depth):
    rng = np.random.default_rng(100 + depth)
    for head in range(depth):
        planes = (rng.random((depth, 11)) < 0.5).astype(np.uint8)
        jh, th = _pair(planes, head)
        _eq(JH.registers_depth_major(jh), TH.registers_depth_major(th))
        _eq(JH.as_register(jh), TH.as_register(th))
        _eq(JH.latest(jh), TH.latest(th))
        _eq(JH.pack_words(jh), TH.pack_words(th))
        _eq(JH.pack_bitplanes(JH.registers_depth_major(jh)),
            TH.pack_bitplanes(TH.registers_depth_major(th)))


@pytest.mark.parametrize("depth", DEPTHS)
def test_word_round_trip_matches_reference(depth):
    rng = np.random.default_rng(200 + depth)
    words = (rng.integers(0, 256, 17) & (0xFF << (8 - depth))).astype(np.uint8)
    _eq(JH.unpack_words(jnp.asarray(words), depth), TH.unpack_words(torch.from_numpy(words), depth))
    jh, th = JH.from_words(jnp.asarray(words), depth), TH.from_words(torch.from_numpy(words), depth)
    _eq(jh.planes, th.planes)
    assert int(jh.head) == int(th.head) == depth - 1
    _eq(JH.pack_words(jh), TH.pack_words(th))
    np.testing.assert_array_equal(TH.pack_words(th).numpy(), words)
    _eq(JH.fixed_point_value(jnp.asarray(words), depth),
        TH.fixed_point_value(torch.from_numpy(words), depth))


@pytest.mark.parametrize("depth", DEPTHS)
def test_batched_lanes_keep_their_own_heads(depth):
    """A leading lane axis is the reference's vmap: each lane's ring, with its
    own head, pushes and reads exactly like a lone reference ring."""
    rng = np.random.default_rng(300 + depth)
    lanes, n = 4, 9
    planes = (rng.random((lanes, depth, n)) < 0.5).astype(np.uint8)
    heads = rng.integers(0, depth, lanes)
    th = TH.SpikeHistory(planes=torch.from_numpy(planes), head=torch.from_numpy(heads))
    spikes = rng.random((lanes, n)) < 0.5
    th2 = TH.push(th, torch.from_numpy(spikes))
    for i in range(lanes):
        jh, _ = _pair(planes[i], int(heads[i]))
        jh2 = JH.push(jh, jnp.asarray(spikes[i]))
        _eq(jh2.planes, th2.planes[i])
        assert int(jh2.head) == int(th2.head[i])
        _eq(JH.registers_depth_major(jh2), TH.registers_depth_major(th2)[i])
        _eq(JH.pack_words(jh2), TH.pack_words(th2)[i])
        _eq(JH.latest(jh2), TH.latest(th2)[i])
    # from_words rebuilds every lane with the uniform head depth-1
    rebuilt = TH.from_words(TH.pack_words(th2), depth)
    assert (rebuilt.head == depth - 1).all()
    assert torch.equal(TH.registers_depth_major(rebuilt), TH.registers_depth_major(th2))


def test_depth_above_eight_has_no_word_layout():
    th = TH.init_history(4, 9)
    with pytest.raises(ValueError, match="depth <= 8"):
        TH.pack_words(th)
    with pytest.raises(ValueError, match="depth <= 8"):
        TH.unpack_words(torch.zeros(4, dtype=torch.uint8), 9)
