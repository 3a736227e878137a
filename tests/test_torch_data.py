"""repro_torch.data and repro_torch.core.encoding against repro.data and
repro.core.encoding: the digit prototypes, and each synthetic dataset built
from the reference's own random draws (rtol=1e-5, atol=1e-5: float32
transcendental functions of two libraries; the fault signals within
atol=1e-4, because torch.linspace and jnp.linspace round the time grid
differently, by one ulp, 6e-8 near t=1, and the 54 Hz sideband's phase
2π·54·t magnifies that 340 times); min-max normalisation; the rate
code's statistics (the two packages' random streams cannot match); the
spike stream; and the prefetcher's order, error and shutdown behaviour."""
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import encoding as JE
from repro.data import synthetic as JD
from repro_torch.core import encoding as TE
from repro_torch.data import Prefetcher, encode_batch, spike_stream
from repro_torch.data import synthetic as TD

TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("side,n_classes", [(28, 10), (16, 4)])
def test_digit_prototypes_match_reference(side, n_classes):
    np.testing.assert_allclose(TD._digit_prototypes(side, n_classes).numpy(),
                               np.asarray(JD._digit_prototypes(side, n_classes)), **TOL)


def test_digits_from_the_reference_draws():
    key, n = jax.random.PRNGKey(3), 12
    k_lbl, k_shift, k_noise = jax.random.split(key, 3)
    labels = jax.random.randint(k_lbl, (n,), 0, 10)
    shifts = jax.random.randint(k_shift, (n, 2), -2, 3)
    z = jax.random.normal(k_noise, (n, 28, 28))
    ref, ref_labels = JD.synthetic_digits(key, n)
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(ref_labels))
    got = TD.digits_from_draws(_t(labels), _t(shifts), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fashion_from_the_reference_draws():
    key, n = jax.random.PRNGKey(4), 12
    k_lbl, k_tex, k_noise = jax.random.split(key, 3)
    labels = jax.random.randint(k_lbl, (n,), 0, 10)
    phase_u = jax.random.uniform(k_tex, (n, 1, 1))
    z = jax.random.normal(k_noise, (n, 28, 28))
    ref, _ = JD.synthetic_fashion(key, n)
    got = TD.fashion_from_draws(_t(labels), _t(phase_u), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_fault_from_the_reference_draws():
    key, n, length = jax.random.PRNGKey(5), 8, 512
    k_lbl, k_ph, k_noise, k_imp = jax.random.split(key, 4)
    labels = jax.random.randint(k_lbl, (n,), 0, 4)
    phase_u = jax.random.uniform(k_ph, (n, 1, 1))
    z = jax.random.normal(k_noise, (n, length, 2))
    imp_u = jax.random.uniform(k_imp, (n, length, 1))
    ref, _ = JD.synthetic_fault(key, n)
    got = TD.fault_from_draws(_t(labels), _t(phase_u), _t(imp_u), _t(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("make,shape,n_classes", [
    (TD.synthetic_digits, (28, 28), 10), (TD.synthetic_fashion, (28, 28), 10),
    (TD.synthetic_fault, (512, 2), 4)])
def test_samplers_are_seeded_and_shaped(make, shape, n_classes):
    x, y = make(torch.Generator().manual_seed(0), 9)
    x2, y2 = make(torch.Generator().manual_seed(0), 9)
    assert x.shape == (9, *shape) and x.dtype == torch.float32
    assert y.shape == (9,) and 0 <= int(y.min()) and int(y.max()) < n_classes
    assert torch.equal(x, x2) and torch.equal(y, y2)
    if make is not TD.synthetic_fault:
        assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0


def test_digits_keep_their_class_structure():
    x, y = TD.synthetic_digits(torch.Generator().manual_seed(1), 200)
    protos = TD._digit_prototypes(28, 10).reshape(10, -1)
    scores = x.reshape(200, -1) @ protos.T
    assert float((scores.argmax(dim=1) == y).float().mean()) > 0.5


@pytest.mark.parametrize("axis", [None, -1])
def test_minmax_normalise_matches_reference(axis):
    x = np.random.default_rng(0).normal(size=(5, 40)).astype(np.float32)
    np.testing.assert_allclose(TE.minmax_normalise(torch.from_numpy(x), axis=axis).numpy(),
                               np.asarray(JE.minmax_normalise(jnp.asarray(x), axis=axis)),
                               rtol=1e-6, atol=1e-6)


def test_rate_code_statistics():
    x = torch.tensor([0.0, 0.1, 0.5, 0.9, 1.0])
    spikes = TE.rate_code(torch.Generator().manual_seed(0), x, 4000)
    assert spikes.shape == (4000, 5) and spikes.dtype == torch.uint8
    rate = spikes.float().mean(dim=0)
    assert rate[0] == 0.0 and rate[-1] == 1.0
    np.testing.assert_allclose(rate.numpy(), x.numpy(), atol=0.03)


def test_encode_batch_and_spike_stream():
    sampler = TD.synthetic_digits
    stream = list(spike_stream(torch.Generator().manual_seed(2), sampler, batch=4,
                               t_steps=7, n_steps=3))
    again = list(spike_stream(torch.Generator().manual_seed(2), sampler, batch=4,
                              t_steps=7, n_steps=3))
    assert len(stream) == 3
    for b, c in zip(stream, again):
        assert b["spikes"].shape == (7, 4, 784) and b["spikes"].dtype == torch.uint8
        assert torch.equal(b["spikes"], c["spikes"]) and torch.equal(b["labels"], c["labels"])
    x, _ = sampler(torch.Generator().manual_seed(0), 2)
    raster = encode_batch(torch.Generator().manual_seed(0), x, 500)
    norm = TE.minmax_normalise(x.reshape(2, -1), axis=-1)
    np.testing.assert_allclose(raster.float().mean(dim=0).numpy(), norm.numpy(), atol=0.1)


def test_prefetcher_preserves_order_and_moves_to_device():
    items = [{"x": torch.full((2,), float(i))} for i in range(9)]
    with Prefetcher(iter(items), depth=2, device="cpu") as pf:
        got = [b["x"][0].item() for b in pf]
    assert got == list(range(9))


def test_prefetcher_close_stops_an_unfinished_source():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    pf = Prefetcher(endless(), depth=2)
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()
    n = len(produced)
    time.sleep(0.05)
    assert len(produced) == n
    pf.close()                                   # idempotent


def test_prefetcher_hands_over_every_item_under_fast_thread_switching():
    """Producer and consumer share one queue: with the interpreter switching
    threads as often as it can, no item is lost, repeated or reordered, and
    neither side waits on a wake-up that already happened."""
    got = []

    def consume():
        with Prefetcher(iter(range(3000)), depth=2) as pf:
            got.extend(pf)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        worker = threading.Thread(target=consume, daemon=True)
        worker.start()
        worker.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not worker.is_alive()
    assert got == list(range(3000))


def test_prefetcher_reraises_the_source_error():
    def broken():
        yield 1
        raise RuntimeError("source failed")

    pf = Prefetcher(broken())
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="source failed"):
        next(pf)
    pf.close()


# ---------------------------------------------------------------------------
# LM token streams (test_data.py's LM tests mirrored)
# ---------------------------------------------------------------------------

def test_zipf_tokens():
    t = TD.zipf_tokens(torch.Generator().manual_seed(0), 4, 512, vocab=1000)
    assert t.shape == (4, 512) and t.dtype == torch.int32
    assert int(t.min()) >= 0 and int(t.max()) < 1000
    # zipf: low ids much more frequent
    flat = t.numpy().ravel()
    assert (flat < 10).mean() > (flat >= 500).mean()
    again = TD.zipf_tokens(torch.Generator().manual_seed(0), 4, 512, vocab=1000)
    assert torch.equal(t, again)


def test_zipf_marginal_matches_reference_law():
    """Both packages draw ids from p(r) ∝ (r + 1)^-1.1 (streams differ, the
    law does not): the id-0 share and the share of ids below 10 agree."""
    t = TD.zipf_tokens(torch.Generator().manual_seed(1), 8, 4096, vocab=1000).numpy().ravel()
    j = np.asarray(JD.zipf_tokens(jax.random.PRNGKey(1), 8, 4096, vocab=1000)).ravel()
    p = np.arange(1, 1001, dtype=np.float64) ** -1.1
    p /= p.sum()
    for share, want in (((t == 0).mean(), p[0]), ((t < 10).mean(), p[:10].sum())):
        assert abs(share - want) < 0.01
    assert abs((t < 10).mean() - (j < 10).mean()) < 0.02


def test_lm_batches_labels_shifted():
    spec = TD.LMBatchSpec(batch=2, seq=16, vocab=100)
    b = next(TD.lm_batches(torch.Generator().manual_seed(0), spec))
    assert torch.equal(b["labels"][:, :-1], b["tokens"][:, 1:])
    assert (b["labels"][:, -1] == -1).all() and b["labels"].dtype == torch.int32
    stream = list(TD.lm_batches(torch.Generator().manual_seed(0), spec, n_steps=3))
    assert len(stream) == 3 and torch.equal(stream[0]["tokens"], b["tokens"])
    assert not torch.equal(stream[1]["tokens"], stream[0]["tokens"])


def test_host_shard():
    batch = {"tokens": torch.arange(8)[:, None]}
    s0 = TD.host_shard(batch, 0, 2)
    s1 = TD.host_shard(batch, 1, 2)
    assert s0["tokens"].ravel().tolist() == [0, 1, 2, 3]
    assert s1["tokens"].ravel().tolist() == [4, 5, 6, 7]
    ref = JD.host_shard({"tokens": jnp.arange(8)[:, None]}, 1, 2)
    assert np.asarray(ref["tokens"]).ravel().tolist() == s1["tokens"].ravel().tolist()
