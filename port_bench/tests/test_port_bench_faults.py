"""The comparison fails what it must: the control (the plain reference in the
program's place, its product in TF32) and each fault a cell can have,
planted in the timed path, with the look for a chip skipped and the rest of
the run driven as on the card."""
from __future__ import annotations

import json

import pytest
from tiny import CELLS, tiny_root

from port_bench import faults, run, system


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    spec = run.load_cell(cell, tiny_root(tmp_path))
    line, numbers = run.run_cell(spec, 5, 0.0, 0, "cpu", make_net=system.ReferenceNet)
    assert not line["correct"]
    assert numbers["v_gap"] > spec["limits"]["v_gap"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(tmp_path, capsys, cell, fault):
    root = tiny_root(tmp_path)
    train = run.load_cell(cell, root)["traffic"]["mode"] == "train"
    with faults.plant(fault, train):
        rc = run.main(["--workload", cell, "--seed", "5", "--seconds", "0", "--trace", "0"],
                      look_for_chip=False, device="cpu", root=root)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and line["correct"] is False
    assert list(line)[-1] == "checks" and "FAILED" in err


def test_no_card_no_result(tmp_path, capsys):
    """Without a CUDA device the run exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    rc = run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_faults_are_taken_out_again(tmp_path):
    spec = run.load_cell("snn6400-train-b256", tiny_root(tmp_path))
    for fault in faults.FAULTS:
        with faults.plant(fault, True):
            pass
    line, _ = run.run_cell(spec, 5, 0.0, 0, "cpu")
    assert line["correct"]


class _WindowFault(system.ProgramNet):
    """The program's net with a fault in the batches after set-up only, so
    that only the batch recorded after the window can see it."""

    fault = ""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.calls = 0

    def run_batch(self, raster):
        self.calls += 1
        if self.calls <= run.SETUP_BATCHES["train"]:
            return super().run_batch(raster)
        if self.fault == "no_reset":
            self.state, counts = self.snn.run_snn(self.state, raster, self.pcfg, train=True)
            return counts
        counts = super().run_batch(raster)
        self.state = self.state._replace(weights=tuple(w + 1e-3 for w in self.state.weights))
        return counts


@pytest.mark.parametrize("fault", ["no_reset", "off_grid"])
@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c])
def test_window_fault_is_not_correct(tmp_path, cell, fault):
    """A fault in the window's batches alone fails the run: the batch
    recorded after the window starts from the window's end state."""
    spec = run.load_cell(cell, tiny_root(tmp_path))
    net = type("Net", (_WindowFault,), {"fault": fault})
    line, numbers = run.run_cell(spec, 5, 0.0, 0, "cpu", make_net=net)
    assert not line["correct"] and numbers["mismatches"] > 0
