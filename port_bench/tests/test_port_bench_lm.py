"""The LM family and the seam by family: the plain reference against the
port's ``loss_and_grads`` and ``adamw_update`` on qwen3-0.6b's smoke
widths, the LM cell end to end on the CPU, the configuration file against
the port's registry, the dispatch of a configuration to its family, and a
family that is only a new file under the run's root."""
from __future__ import annotations

import dataclasses
import json
import math

import pytest
import torch
from tiny import LM_TINY, ROOT, tiny_root

from port_bench import check, counts, lm_inputs, lm_system, run
from port_bench.reference import lm as ref

CELL = "qwen3-train-4x2048"
QWEN3 = json.loads((ROOT / "port_bench" / "configs" / "qwen3-0.6b.json").read_text())


def _smoke_cfg() -> dict:
    """qwen3-0.6b's file cut to the port's SMOKE widths, computing in float32."""
    cfg = json.loads(json.dumps(QWEN3))
    cfg.update(LM_TINY)
    cfg["assumed"]["compute_dtype"] = "float32"
    return cfg


def test_config_file_is_the_ports_qwen3():
    from repro_torch.configs import get_config, get_smoke_config

    assert lm_system.model_config(QWEN3) == get_config("qwen3-0.6b")
    smoke = dataclasses.replace(get_smoke_config("qwen3-0.6b"), name="qwen3-0.6b",
                                dtype="float32")
    assert lm_system.model_config(_smoke_cfg()) == smoke


def test_parameter_tree_is_the_programs():
    """The harness's tree has the program's keys and shapes (meta tensors:
    no memory), at the published widths."""
    from repro_torch.models.transformer import init_model

    meta = init_model(None, lm_system.model_config(QWEN3), device="meta")
    got = {p: tuple(x.shape) for p, x in lm_inputs.paths(meta)}
    assert got == dict(lm_inputs.paths(lm_inputs.leaf_shapes(QWEN3)))
    assert sum(math.prod(s) for s in got.values()) == 596_049_920


def test_model_flops_of_qwen3():
    traffic = json.loads((ROOT / "port_bench/traffic/lm-train-4x2048.json").read_text())
    assert counts.lm_matrix_params(QWEN3) == 595_984_384
    assert counts.lm_flops_per_token(QWEN3, 2048) == 4_280_549_376
    assert counts.lm_step_flops(QWEN3, traffic) == 8192 * 4_280_549_376


def test_reference_against_the_ports_step():
    """Loss and gradients agree to float32 rounding; ITP-AdamW (kernels
    9-10's plain path) agrees bit for bit, on a first and a second step."""
    from repro_torch.train import train_step
    from repro_torch.train.optimizer import OptimizerConfig, adamw_update, init_opt_state

    cfg = _smoke_cfg()
    traffic = {"batch": 3, "seq": 24, "tokens": "zipf-1.1"}
    dev = torch.device("cpu")
    params = lm_inputs.initial_params(cfg, 3, dev)
    batches = lm_inputs.token_pool(cfg, traffic, 2, 3, dev)
    mcfg = lm_system.model_config(cfg)
    tcfg = train_step.TrainConfig(remat="none", z_loss=cfg["assumed"]["z_loss"])
    opt = cfg["assumed"]["optimizer"]
    prog_state, ref_state = init_opt_state(params), ref.fresh_state(params, dev)
    for batch in batches:
        loss, _, grads = train_step.loss_and_grads(params, mcfg, batch, train_cfg=tcfg)
        want_loss, want_grads = ref.loss_and_grads(params, cfg, batch,
                                                   cfg["assumed"]["z_loss"])
        assert float(loss) == pytest.approx(want_loss, rel=1e-5)
        assert want_loss == pytest.approx(ref.loss(params, cfg, batch, cfg["assumed"]["z_loss"]),
                                          rel=1e-6)
        for g, w in zip(ref.leaves(grads), ref.leaves(want_grads)):
            assert float((g - w).norm()) <= 1e-4 * float(w.norm()) + 1e-9
        new, new_state, _ = adamw_update(OptimizerConfig(**opt, po2_update=True), params,
                                         grads, prog_state, use_kernel=True)
        want, want_state = ref.itp_adamw(opt, params, grads, ref_state)
        got = [*ref.leaves(new), *ref.leaves(new_state.mu), *ref.leaves(new_state.nu)]
        for g, w in zip(got, [*ref.leaves(want), *ref.leaves(want_state["mu"]),
                              *ref.leaves(want_state["nu"])]):
            assert torch.equal(g.view(torch.int32), w.view(torch.int32))
        assert int(new_state.step) == int(want_state["step"])
        params, prog_state, ref_state = new, new_state, want_state


def test_po2_snap_is_the_ports():
    from repro_torch.kernels.po2_quant.ops import po2_quantize

    edge = [0.0, -0.0, 1.0, -1.0, 1.4142135, 1.4142137, 3e-39, -3e-39, float("inf"),
            float("-inf"), float("nan"), 2.0 ** -70, 2.0 ** 70, 5e-324]
    x = torch.cat([torch.tensor(edge, dtype=torch.float32),
                   torch.randn(4096, generator=torch.Generator().manual_seed(1)) * 1e-3])
    got, want = ref.po2(x), po2_quantize(x, use_kernel=False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_lm_cell_end_to_end(tmp_path, capsys):
    root = tiny_root(tmp_path)
    for trace in (0, 1):
        rc = run.main(["--workload", CELL, "--seed", str(2**31 + 11), "--seconds", "0",
                       "--trace", str(trace)], look_for_chip=False, device="cpu", root=root)
        out, err = capsys.readouterr()
        line = json.loads(out.strip().splitlines()[-1])
        assert rc == 0 and line["correct"] is True, err
        assert list(line)[-1] == "checks"
        assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                       "update_mismatches"}
        assert line["checks"]["update_mismatches"]["value"] == 0
        assert "check steps 4 correct True" in err
        if trace:
            assert line["attempted"] == 4 * 3     # the traced steps' sequences
            assert "lm_mfu" not in line["metrics"]          # no device events here
        else:
            assert set(line["metrics"]) == {"samples_per_s", "setup_s"}


def test_no_family_key_runs_as_snn():
    spec = run.load_cell("snn6400-eval-b4096")
    assert "family" not in spec["cfg"]
    family = run.family_module(spec)
    assert family.__name__ == "port_bench.families.snn"
    assert family.NUMBERS == check.NUMBERS
    assert run.family_module(run.load_cell(CELL)).NUMBERS == (
        "loss_gap", "grad_gap", "change_gap", "update_mismatches")


def test_a_family_is_a_new_file(tmp_path, capsys):
    """A configuration of a family that only a file under the run's root
    defines runs through it: no file already there is edited."""
    root = tiny_root(tmp_path)
    (root / "port_bench" / "families" / "echo.py").write_text(
        "def run_cell(spec, seed, seconds, trace, device, make_net=None, t_start=None):\n"
        "    line = {'correct': True, 'attempted': seed, 'failed': 0,\n"
        "            'metrics': {'setup_s': {'value': 1.0, 'unit': 's'}},\n"
        "            'device': {'platform': 'cpu'}, 'checks': {'n': {'value': 0, 'limit': 0}}}\n"
        "    return line, {'n': 0, 'steps_checked': 1}\n")
    cfg = dict(json.loads((root / "port_bench/configs/qwen3-0.6b.json").read_text()),
               name="echo-model", family="echo")
    (root / "port_bench/configs/echo-model.json").write_text(json.dumps(cfg))
    (root / "port_bench/limits/echo-cell.json").write_text('{"n": 0}')
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "echo-model", "source": "a test",
                             "file": "port_bench/configs/echo-model.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "echo-cell", "config": "echo-model",
                               "traffic": "lm-train-4x2048", "chips": 1, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc = run.main(["--workload", "echo-cell", "--seed", "17", "--seconds", "0"],
                  look_for_chip=False, device="cpu", root=root)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["attempted"] == 17
    (root / "port_bench/configs/echo-model.json").write_text(
        json.dumps(dict(cfg, family="absent")))
    with pytest.raises(SystemExit):
        run.main(["--workload", "echo-cell", "--seed", "17", "--seconds", "0"],
                 look_for_chip=False, device="cpu", root=root)
