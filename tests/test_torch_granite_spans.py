"""The port's spans around the Mamba-2 mixer (``models/ssm.py``):
``repro_torch.lm.ssm`` around ``apply_ssm_train``'s whole mixer and
``repro_torch.lm.ssd_scan`` around its scan.  Under a CPU profiler one
training step of granite-4.0-h-micro's SMOKE config opens each once per
Mamba layer without remat and twice under ``remat="full"`` (the forward
and its recompute), each scan inside a mixer; with no profiler running
they are the shared no-op and nothing is recorded."""
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs import get_smoke_config
from repro_torch.models import transformer
from repro_torch.train import train_step
from repro_torch.train.optimizer import OptimizerConfig, init_opt_state

NAMES = ("repro_torch.lm.ssm", "repro_torch.lm.ssd_scan")


def _step(remat: str):
    cfg = dataclasses.replace(get_smoke_config("granite-4.0-h-micro"), dtype="float32")
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_model(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    step = train_step.make_train_step(cfg, OptimizerConfig(po2_update=True),
                                      train_step.TrainConfig(remat=remat), use_kernel=False)
    return cfg, lambda: step(params, init_opt_state(params), batch)


def _within(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("remat,per_layer", [("full", 2), ("none", 1)])
def test_a_training_step_opens_each_span_per_mamba_layer(remat, per_layer):
    cfg, run = _step(remat)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = prof.events()
    mixers = [e for e in events if e.name == NAMES[0]]
    scans = [e for e in events if e.name == NAMES[1]]
    n_mamba = cfg.layer_types.count("mamba")
    assert n_mamba == 3
    assert len(mixers) == len(scans) == per_layer * n_mamba
    assert all(sum(_within(s, m) for m in mixers) == 1 for s in scans)
    assert {e.name for e in events if e.name.startswith("repro_torch.lm.")} == set(NAMES)


def test_spans_are_the_shared_noop_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function constructed with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert all(spans.span(n) is spans._OFF for n in NAMES)
    _, run = _step("full")
    _, _, metrics = run()
    assert torch.isfinite(metrics["loss"])
