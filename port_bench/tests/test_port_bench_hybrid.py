"""The hybrid family (granite-4.0-h-micro on the port's LM training step):
its module found by the configuration's ``family`` key, the configuration
file against the port's registry, the frozen counts, the three metrics on a
synthetic trace, the cell end to end on the CPU at the port's SMOKE widths,
the control and every fault failing it, a program without the
configuration exiting at once, and, on the card, the tiny cell and its
control.  Run on the card with
``python -m pytest -q -p no:cacheprovider -m gpu port_bench/tests``."""
from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch
from tiny import ROOT, tiny_root

from port_bench import hybrid_counts, hybrid_inputs, hybrid_system, lm_faults, run
from port_bench import trace as tracing
from port_bench.reference import granite as ref

CELL = "granite-h-train-4x4096"
GRANITE = json.loads((ROOT / "port_bench/configs/granite-4.0-h-micro.json").read_text())
TRAFFIC = json.loads((ROOT / "port_bench/traffic/lm-train-4x4096.json").read_text())
# the configuration cut to the port's SMOKE widths (granite_4_0_h_micro.SMOKE)
HYBRID_TINY = {"num_hidden_layers": 4, "layer_types": ["mamba", "mamba", "attention", "mamba"],
               "hidden_size": 64, "intermediate_size": 128, "shared_intermediate_size": 128,
               "num_attention_heads": 4, "num_key_value_heads": 2, "vocab_size": 256,
               "mamba_n_heads": 8, "mamba_d_head": 16, "mamba_d_state": 16,
               "mamba_chunk_size": 8, "attention_multiplier": 0.0625}


def tiny_cfg() -> dict:
    cfg = json.loads(json.dumps(GRANITE))
    cfg.update(HYBRID_TINY)
    cfg["assumed"].update(compute_dtype="float32", head_dim=16)
    return cfg


def hybrid_root(tmp):
    """``tiny.tiny_root`` with the granite configuration cut to
    ``HYBRID_TINY`` in float32 (its traffic is cut there to 4 × 32)."""
    root = tiny_root(tmp)
    (root / "port_bench/configs/granite-4.0-h-micro.json").write_text(json.dumps(tiny_cfg()))
    return root


def test_the_family_loads_by_its_key():
    spec = run.load_cell(CELL)
    family = run.family_module(spec)
    assert family.__name__ == "port_bench.families.hybrid"
    assert family.NUMBERS == ("loss_gap", "grad_gap", "change_gap", "update_mismatches")
    assert family.CONTROL is hybrid_system.ReferenceTrainer
    assert set(spec["limits"]) == set(family.NUMBERS)
    assert {m["name"] for m in spec["per_layer"]} == {
        "ssm_device_ms_per_step", "ssd_scan_roofline_pct", "hybrid_lm_mfu", "device_idle_pct"}


def test_config_file_is_the_ports_config_cut_as_reduced_says():
    from repro_torch.configs import get_config, get_smoke_config

    full = get_config("granite-4.0-h-micro")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "granite-4.0-h-micro")
    assert entry["reduced"] == ["num_hidden_layers", "layer_types"]
    assert GRANITE["num_hidden_layers"] == 10
    assert GRANITE["layer_types"] == list(full.layer_types[:10])
    assert hybrid_system.model_config(GRANITE) == dataclasses.replace(
        full, n_layers=10, layer_types=full.layer_types[:10])
    smoke = dataclasses.replace(get_smoke_config("granite-4.0-h-micro"),
                                name="granite-4.0-h-micro", dtype="float32")
    assert hybrid_system.model_config(tiny_cfg()) == smoke


def test_parameter_tree_is_the_programs():
    from repro_torch.models.transformer import init_model

    from port_bench.lm_inputs import paths

    mcfg = hybrid_system.model_config(GRANITE)
    meta = init_model(None, mcfg, device="meta")
    got = {p: tuple(x.shape) for p, x in paths(meta)}
    assert got == dict(paths(ref.leaf_shapes(GRANITE)))
    assert sum(math.prod(s) for s in got.values()) == mcfg.param_count() == 951_991_232


def test_counts_on_hand_worked_shapes():
    # x and y: 64 heads × 64 in bf16; B and C: 128 each in bf16; Δ: 64 float32
    assert hybrid_counts.scan_bytes_per_token(GRANITE) == 2 * (2 * 4096 + 2 * 128) + 4 * 64 \
        == 17_152
    # Q·G·N + Q·H·P + 4·H·N·P at Q = 256
    assert hybrid_counts.scan_ops_per_token(GRANITE) == \
        256 * 128 + 256 * 64 * 64 + 4 * 64 * 128 * 64 == 3_178_496
    # 16,384 tokens: 281 MB over 3.35 TB/s outweighs 52.1 GFLOP over 989.4 TFLOP/s
    assert hybrid_counts.scan_bound_s(GRANITE, TRAFFIC) == pytest.approx(
        16384 * 17_152 / 3.35e12, rel=1e-12)
    mamba = 2048 * (4096 + 4352 + 64) + 4096 * 2048          # z, xBC, dt, out
    attention = 2048 * 2048 + 2 * 2048 * 512 + 2048 * 2048   # q, k, v, o
    assert hybrid_counts.matrix_params(GRANITE) == \
        9 * mamba + attention + 10 * 3 * 2048 * 8192 + 100352 * 2048 == 951_713_792
    assert hybrid_counts.flops_per_token(GRANITE, 4096) == \
        6 * 951_713_792 + 6 * 4096 * 32 * 64 + 3 * 9 * 3_178_496 == 5_846_433_792
    assert hybrid_counts.step_flops(GRANITE, TRAFFIC) == 16384 * 5_846_433_792


def _trace(cfg, traffic, device_us: float) -> tracing.Trace:
    """Two steps, each with one Mamba mixer span holding a scan span: per
    step a launch in the scan (``device_us``), one in the mixer outside the
    scan (10 µs) and one outside both (5 µs)."""
    host, runtime, device = [], [], []
    for k in range(2):
        t = 1000.0 * k
        host += [(t + 10, t + 100, "repro_torch.lm.ssm"),
                 (t + 20, t + 50, "repro_torch.lm.ssd_scan")]
        runtime += [(t + c, t + c + 1, "cudaLaunchKernel") for c in (30, 60, 200)]
        device += [(t + 300, t + 300 + device_us, "scan"), (t + 400, t + 410, "proj"),
                   (t + 500, t + 505, "mlp")]
    return tracing.Trace(cfg=cfg, traffic=traffic, batches=2, steps=2, window=(0.0, 2.0e6),
                         device=device, run_spans=[], update_device_us=0.0, runtime=runtime,
                         host_ops=host, launches={})


def test_metrics_read_a_synthetic_trace():
    read = {m: run.metric_reader(ROOT, m).read
            for m in ("ssm_device_ms_per_step", "ssd_scan_roofline_pct", "hybrid_lm_mfu")}
    tr = _trace(GRANITE, TRAFFIC, 1000.0)
    assert read["ssm_device_ms_per_step"](tr) == pytest.approx(1.010)
    bound = hybrid_counts.scan_bound_s(GRANITE, TRAFFIC)
    assert read["ssd_scan_roofline_pct"](tr) == pytest.approx(100 * 2 * bound / 2e-3)
    assert read["hybrid_lm_mfu"](tr) == pytest.approx(
        100 * hybrid_counts.step_flops(GRANITE, TRAFFIC) / 1.0 / 989.4e12)
    empty = dataclasses.replace(tr, device=[])
    assert all(f(empty) is None for f in read.values())
    no_span = dataclasses.replace(tr, host_ops=[])
    assert read["ssm_device_ms_per_step"](no_span) is None     # a program without spans
    assert read["ssd_scan_roofline_pct"](no_span) is None


def test_inputs_follow_the_seed():
    cfg, dev = tiny_cfg(), torch.device("cpu")
    a, b = (hybrid_inputs.initial_params(cfg, 2**31 + 7, dev) for _ in range(2))
    c = hybrid_inputs.initial_params(cfg, 8, dev)
    la, lb, lc = (ref.leaves(t) for t in (a, b, c))
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    assert not torch.equal(a["mamba_blocks"]["ssm"]["wz"], c["mamba_blocks"]["ssm"]["wz"])
    ssm = a["mamba_blocks"]["ssm"]
    assert torch.equal(ssm["a_log"][1], torch.log(torch.linspace(1.0, 16.0, 8)))
    assert not ssm["conv_b"].any() and not ssm["dt_bias"].any()
    assert torch.equal(ssm["d_skip"], torch.ones(3, 8))


def test_cell_end_to_end(tmp_path, capsys):
    root = hybrid_root(tmp_path)
    for trace in (0, 1):
        rc = run.main(["--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "0",
                       "--trace", str(trace)], look_for_chip=False, device="cpu", root=root)
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is True, err
        assert list(line)[-1] == "checks"
        assert line["checks"]["update_mismatches"]["value"] == 0
        assert "check steps 4 correct True" in err
        if trace:
            assert line["attempted"] == 4 * 3
            assert not line["metrics"]            # no device events on the CPU
        else:
            assert set(line["metrics"]) == {"samples_per_s", "setup_s"}


def test_control_is_not_correct(tmp_path):
    spec = run.load_cell(CELL, hybrid_root(tmp_path))
    line, numbers = run.run_cell(spec, 5, 0.0, 0, "cpu",
                                 make_net=run.family_module(spec).CONTROL)
    assert not line["correct"]
    assert numbers["grad_gap"] > spec["limits"]["grad_gap"]


@pytest.mark.parametrize("fault", lm_faults.FAULTS)
def test_fault_is_not_correct(tmp_path, capsys, fault):
    root = hybrid_root(tmp_path)
    spec = run.load_cell(CELL, root)
    with run.family_module(spec).plant(fault, spec):
        rc = run.main(["--workload", CELL, "--seed", "5", "--seconds", "0", "--trace", "0"],
                      look_for_chip=False, device="cpu", root=root)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False
    assert "FAILED" in err


def test_a_program_without_the_configuration_exits_at_once(tmp_path, monkeypatch):
    from repro_torch import configs

    root = hybrid_root(tmp_path)
    monkeypatch.setattr(configs, "_MODULES", {k: v for k, v in configs._MODULES.items()
                                              if k != "granite-4.0-h-micro"})

    def refuse(*args, **kwargs):
        raise AssertionError("set-up began")

    monkeypatch.setattr(hybrid_inputs, "initial_params", refuse)
    with pytest.raises(SystemExit, match="has no architecture 'granite-4.0-h-micro'"):
        run.main(["--workload", CELL, "--seed", "1", "--seconds", "0"],
                 look_for_chip=False, device="cpu", root=root)


@pytest.mark.gpu
def test_cell_and_control_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    device = torch.device("cuda", 0)
    spec = run.load_cell(CELL, hybrid_root(tmp_path))
    line, numbers = run.run_cell(spec, 9, 0.0, 1, device)
    assert line["correct"], numbers
    assert line["device"]["busy_s"] > 0
    assert line["metrics"]["ssm_device_ms_per_step"]["value"] > 0
    assert 0 < line["metrics"]["ssd_scan_roofline_pct"]["value"] < 100
    assert 0 < line["metrics"]["hybrid_lm_mfu"]["value"] < 100
    line, _ = run.run_cell(spec, 9, 0.0, 0, device,
                           make_net=run.family_module(spec).CONTROL)
    assert not line["correct"]
