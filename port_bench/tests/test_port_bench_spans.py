"""The program's own spans as the benchmark reads them
(``port_bench/program_spans.py``): the attribution of launches to nested
spans, the pairing of device operations with their launching calls, a tiny
traced run on the CPU, and, on the card, each cell's traced stretch held to
the profiler's correlation ids."""
from __future__ import annotations

import dataclasses
import types

import pytest
import torch
from tiny import ROOT, SNN_CELLS, tiny_root

from port_bench import inputs, program_spans, run, system
from port_bench import trace as tracing
from port_bench.families import snn as snn_family
from port_bench.reference import snn as ref

NEW = ("product_device_ms_per_step", "neuron_device_ms_per_step",
       "timing_device_ms_per_step", "update_device_ms_per_step", "device_ops_per_step")
OLD = ("host_ms_per_step", "mfu", "update_launches_per_step", "update_roofline_pct",
       "device_idle_pct")


def _stretch(spec, device, seed=5, keep_prof=None):
    """Set-up as a run makes it, then ``snn_family.TRACE_BATCHES`` traced
    batches; ``keep_prof`` (a dict) receives the profiler."""
    cfg, traffic = spec["cfg"], spec["traffic"]
    mode = traffic["mode"]
    weights = inputs.initial_weights(ref.weight_shapes(cfg), seed, device)
    pool = inputs.raster_pool(traffic, snn_family.POOL[mode], seed, device)
    net = system.ProgramNet(cfg, traffic, weights, device)
    first = snn_family.SETUP_BATCHES[mode]
    for i in range(first):
        net.run_batch(pool[i])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if keep_prof is None:
        return tracing.capture(net, pool, first, snn_family.TRACE_BATCHES, cfg, traffic,
                               {}, device)
    launched_in_update = tracing._launched_in_update

    def kept(prof):
        keep_prof["prof"] = prof
        return launched_in_update(prof)

    tracing._launched_in_update = kept
    try:
        return tracing.capture(net, pool, first, snn_family.TRACE_BATCHES, cfg, traffic,
                               {}, device)
    finally:
        tracing._launched_in_update = launched_in_update


def test_attribute_nested_edges_and_outside():
    spans = [(0.0, 100.0, "outer"), (10.0, 20.0, "inner"), (30.0, 40.0, "inner")]
    launched = [(20.0, 2.0), (10.0, 1.0),      # on the inner span's end and start
                (25.0, 4.0),                   # in the outer span alone
                (100.0, 8.0),                  # on the outer span's end
                (35.0, 64.0),                  # in the second inner span
                (-1.0, 16.0), (101.0, 32.0)]   # outside every span
    got = program_spans.attribute(spans, launched)
    assert got == {"outer": {"calls": 1, "device_us": 79.0, "device_ops": 5},
                   "inner": {"calls": 2, "device_us": 67.0, "device_ops": 3}}
    assert program_spans.attribute(spans, []) == {
        "outer": {"calls": 1, "device_us": 0.0, "device_ops": 0},
        "inner": {"calls": 2, "device_us": 0.0, "device_ops": 0}}


def _fake(calls, ops, others=()):
    return types.SimpleNamespace(
        runtime=[(t, t + 1.0, "cudaLaunchKernel") for t in calls]
        + [(t, t + 1.0, "cudaDeviceSynchronize") for t in others],
        host_ops=[(0.0, 99.0, "aten::add")], device=[(s, e, "k") for s, e in ops])


def test_launches_pair_by_order_from_the_end():
    ops = [(5.0, 6.0), (6.0, 8.5), (9.0, 13.0)]
    want = [(1.0, 1.0), (2.0, 2.5), (3.0, 4.0)]
    assert program_spans.launches(_fake([3.0, 1.0, 2.0], ops, others=[0.5])) == want
    # the device records of the first launches can be missing: those calls
    # stay unpaired
    assert program_spans.launches(_fake([0.0, 0.2, 1.0, 2.0, 3.0], ops)) == want
    # the device's clock may lie off the host's: only the order counts
    skewed = [(s - 4.5, e - 4.5) for s, e in ops]
    assert program_spans.launches(_fake([1.0, 2.0, 3.0], skewed)) == want
    assert program_spans.launches(_fake([1.0, 2.0], ops)) is None
    assert program_spans.launches(_fake([], [])) == []


@pytest.mark.parametrize("cell", SNN_CELLS)
def test_tiny_traced_run_on_the_cpu(tmp_path, cell):
    spec = run.load_cell(cell, tiny_root(tmp_path))
    tr = _stretch(spec, torch.device("cpu"))
    train = spec["traffic"]["mode"] == "train"
    learnable = sum(layer["kind"] != "pool2d" for layer in spec["cfg"]["layers"])
    got = program_spans.read(tr)
    calls = {name.rsplit(".", 1)[1]: row["calls"] for name, row in got.items()}
    n = snn_family.TRACE_BATCHES
    want = {"run": n, "reset": n, "step": tr.steps, "product": tr.steps * learnable,
            "neurons": tr.steps * learnable, "timing": tr.steps * learnable}
    if train:
        want["update"] = tr.steps * learnable
    assert calls == want
    assert all(row["device_ops"] == 0 for row in got.values())
    readers = {m["name"]: run.metric_reader(ROOT, m["name"]) for m in spec["per_layer"]}
    assert all(readers[name].read(tr) is None for name in NEW if name in readers)
    # the old readings are those of the same trace without the program's spans
    bare = dataclasses.replace(tr, host_ops=[x for x in tr.host_ops
                                             if not x[2].startswith("repro_torch.")])
    assert program_spans.read(bare) == {}
    for name in OLD:
        if name in readers:
            assert readers[name].read(tr) == readers[name].read(bare), name
    line, _ = run.run_cell(spec, 7, 0.0, 1, "cpu")
    assert line["correct"]
    assert not set(NEW) & set(line["metrics"])


def _by_correlation(prof) -> dict:
    """The spans' device time and operations linked by the profiler's
    correlation ids: each device operation names the host operation that
    launched it, whose start must lie inside the span."""
    DeviceType = torch.autograd.DeviceType
    raw = prof.profiler.kineto_results.events()
    started, spans = {}, []
    for k in raw:
        if k.device_type() == DeviceType.CPU and k.linked_correlation_id() == 0:
            started[k.correlation_id()] = k.start_ns() / 1e3
            if k.name().startswith(program_spans.PREFIX):
                spans.append((k.start_ns() / 1e3, (k.start_ns() + k.duration_ns()) / 1e3,
                              k.name()))
    launched = [(started[k.linked_correlation_id()], k.duration_ns() / 1e3) for k in raw
                if k.device_type() == DeviceType.CUDA and not k.is_user_annotation()
                and k.linked_correlation_id() in started]
    return program_spans.attribute(spans, launched)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", SNN_CELLS)
def test_stretch_on_the_card(cell):
    """Each SNN cell at its size: the order pairing agrees with the correlation ids, the program's
    spans hold the stretch's device time, and ``repro_torch.snn.update`` the
    benchmark's own ``port_bench.update``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    kept: dict = {}
    spec = run.load_cell(cell)
    tr = _stretch(spec, torch.device("cuda", 0), keep_prof=kept)
    assert not any(name.startswith(program_spans.PREFIX) for _, _, name in tr.device)
    assert not any(name.startswith(program_spans.PREFIX)
                   for name, _ in tr.breakdown()["device_ops"])
    got, truth = program_spans.read(tr), _by_correlation(kept["prof"])
    assert set(got) == set(truth)
    for name, row in truth.items():
        assert got[name]["calls"] == row["calls"], name
        # a launch just after the profiler starts whose record is missing
        # while an earlier one's is not shifts one small operation
        assert got[name]["device_us"] == pytest.approx(row["device_us"], rel=1e-3), name
        assert abs(got[name]["device_ops"] - row["device_ops"]) <= 1, name
    device_us = sum(e - s for s, e, _ in tr.device)
    top = got["repro_torch.snn.run"]["device_us"] + got["repro_torch.snn.reset"]["device_us"]
    assert top >= 0.99 * device_us
    if spec["traffic"]["mode"] == "train":
        assert got["repro_torch.snn.update"]["device_us"] == pytest.approx(
            tr.update_device_us, rel=5e-3)
    else:
        assert "repro_torch.snn.update" not in got
