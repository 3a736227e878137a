"""The port's profiler spans (``repro_torch.spans``) around the SNN's layers:
free with no profiler running, live under ``torch.profiler.profile``, each
where ``models/snn.py`` puts it, every op of a call inside one, and no
effect on the numbers.  On the tiny 2-layer net and the DCSNN, training and
frozen."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.models import snn
from repro_torch.tree import tree_leaves

T, B = 3, 2
NETS = {"2layer-snn": lambda: snn.mnist_2layer(n_hidden=24, backend="fused"),
        "6layer-dcsnn": lambda: snn.fmnist_dcsnn(backend="fused")}
CASES = [(net, train) for net in NETS for train in (True, False)]
IDS = [f"{net}-{'train' if train else 'frozen'}" for net, train in CASES]
LAYER_SPANS = ("product", "neurons", "update", "timing")


def _inputs(net):
    cfg = NETS[net]()
    state = snn.init_snn(cfg, B, generator=torch.Generator().manual_seed(0), device="cpu")
    raster = (torch.rand((T, B, 784), generator=torch.Generator().manual_seed(1))
              < 0.4).to(torch.float32)
    return cfg, state, raster


def _call(cfg, state, raster, train):
    """The trainer's batch: the run, then the reset between samples."""
    state, counts = snn.run_snn(state, raster, cfg, train=train)
    return state, counts, snn.reset_dynamics(state, cfg, B)


def _profiled(net, train):
    cfg, state, raster = _inputs(net)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _call(cfg, state, raster, train)
    return cfg, out, prof.events()


def _named(events, name):
    return [e for e in events if e.name == f"repro_torch.snn.{name}"]


def _within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def test_span_outside_a_profiler_is_the_shared_noop(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function constructed with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert spans.span("repro_torch.snn.step") is spans.span("anything") is spans._OFF
    for net, train in CASES:
        cfg, state, raster = _inputs(net)
        _call(cfg, state, raster, train)


def test_span_under_a_profiler_is_a_record_function():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("repro_torch.test"):
            torch.ones(2).add_(1)
    assert spans.span("repro_torch.test") is spans._OFF
    assert [e.name for e in prof.events()].count("repro_torch.test") == 1


@pytest.mark.parametrize("net,train", CASES, ids=IDS)
def test_spans_count_and_nest(net, train):
    cfg, _, events = _profiled(net, train)
    learnable = sum(not s.kind.startswith("pool") for s in cfg.layers)
    (run,) = _named(events, "run")
    (reset,) = _named(events, "reset")
    steps = _named(events, "step")
    assert len(steps) == T and all(_within(s, run) for s in steps)
    assert not _within(reset, run)
    for name in LAYER_SPANS:
        got = _named(events, name)
        want = T * learnable if train or name != "update" else 0
        assert len(got) == want, name
        for e in got:
            assert sum(_within(e, s) for s in steps) == 1, name
    names = {e.name for e in events if e.name.startswith("repro_torch.")}
    assert names <= {f"repro_torch.snn.{n}" for n in ("run", "reset", "step", *LAYER_SPANS)}


@pytest.mark.parametrize("net,train", CASES, ids=IDS)
def test_every_op_of_the_call_lies_in_a_span(net, train):
    _, _, events = _profiled(net, train)
    outer = _named(events, "run") + _named(events, "reset")
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    stray = [e.name for e in ops if not any(_within(e, s) for s in outer)]
    assert not stray


@pytest.mark.parametrize("net,train", CASES, ids=IDS)
def test_states_and_counts_bit_equal_with_the_profiler_on(net, train):
    cfg, state, raster = _inputs(net)
    plain = _call(cfg, state, raster, train)
    _, traced, _ = _profiled(net, train)
    a, b = tree_leaves(plain), tree_leaves(traced)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y
    # the run did work: spikes were pushed into the histories
    assert any(isinstance(x, torch.Tensor) and x.dtype == torch.uint8 and x.any()
               for x in tree_leaves(plain[0].layers))
