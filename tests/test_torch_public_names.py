"""The port's last three public names of the JAX package (ROADMAP item 20):
``kernels.dispatch.default_fused_backend`` / ``default_interpret`` and
``kernels.itp_counter.kernel.counter_delays``, each held to the reference's
own tests (``tests/test_kernels.py:176-181``,
``tests/test_counter_backend.py:249,269``); ``counter_delays`` also against
the reference's, which builds no Pallas call."""
import jax.numpy as jnp
import numpy as np
import torch
from _hypothesis_compat import given, settings, st

from repro.kernels.dispatch import default_fused_backend as j_default_fused_backend
from repro.kernels.itp_counter.kernel import counter_delays as j_counter_delays
from repro_torch.kernels.dispatch import (default_fused_backend, default_interpret,
                                          resolve_backend)
from repro_torch.kernels.itp_counter.kernel import counter_delays
from repro_torch.plasticity import get_rule


def test_interpret_default_derives_from_host():
    """The interpret default comes from the dispatch layer: the plain
    versions where no card is present, the CUDA kernels where one is."""
    assert default_interpret() == resolve_backend(default_fused_backend())[1]
    if torch.cuda.is_available():   # pragma: no cover - hosts with a card only
        assert default_fused_backend() == "fused"
        assert default_interpret() is False
    else:
        assert default_fused_backend() == "fused_interpret" == j_default_fused_backend()
        assert default_interpret() is True


def _check(words: torch.Tensor, depth: int, ts) -> None:
    dt, valid = counter_delays(words, depth)
    assert dt.dtype == torch.int32 and valid.dtype == torch.float32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(ts))
    np.testing.assert_array_equal(valid.numpy(), (np.asarray(ts) <= depth - 1).astype(np.float32))
    jdt, jvalid = j_counter_delays(jnp.asarray(words.numpy()), depth)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(jdt))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


@settings(max_examples=40, deadline=None)
@given(data=st.data(), depth=st.integers(1, 8), n=st.integers(1, 16))
def test_counter_word_round_trips_through_delay_formation(data, depth, n):
    """A counter value (the saturated ``depth`` included) survives the uint8
    word readout and the Δt formation; the validity gate opens exactly for
    the live delays 0..depth-1."""
    ts = data.draw(st.lists(st.integers(0, depth), min_size=n, max_size=n))
    (words,) = get_rule("exact").to_words(torch.tensor(ts, dtype=torch.int32))
    assert words.dtype == torch.uint8
    _check(words, depth, ts)


@settings(max_examples=20, deadline=None)
@given(data=st.data(), depth=st.integers(1, 8), steps=st.integers(0, 12))
def test_counter_state_saturates_and_round_trips_under_stepping(data, depth, steps):
    """The rule's own step (reset on spike, saturate at ``depth``) never
    leaves the word range, and the readout stays the identity on the state."""
    rule = get_rule("exact")
    n = 4
    state = rule.init_state(n, depth)
    for _ in range(steps):
        spikes = torch.tensor(data.draw(st.lists(st.integers(0, 1), min_size=n, max_size=n)))
        state = rule.step(state, spikes, depth=depth)
    assert int(state.max()) <= depth
    _check(rule.to_words(state)[0], depth, state.tolist())
