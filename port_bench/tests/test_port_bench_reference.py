"""The SNN's plain reference agrees with the port on the CPU at a tiny
width: each SNN cell, cut by ``tiny.tiny_root``, runs its timed path and its
comparison and comes out correct under the cell's own limits (the LM's:
``test_port_bench_lm.py``)."""
from __future__ import annotations

import pytest
import torch
from tiny import SNN_CELLS, tiny_root

from port_bench import run
from port_bench.reference import snn as ref


@pytest.mark.parametrize("cell", SNN_CELLS)
def test_cell_correct_on_cpu(tmp_path, cell):
    spec = run.load_cell(cell, tiny_root(tmp_path))
    line, numbers = run.run_cell(spec, 2**31 + 7, 0.0, 0, "cpu")
    assert line["correct"], numbers
    assert numbers["steps_checked"] >= 6
    assert numbers["mismatches"] == 0 and numbers["w_gap"] == 0
    assert 0 < numbers["v_gap"] <= spec["limits"]["v_gap"]


def test_tf32_rounding():
    # 10 stored mantissa bits; a tie goes to the even neighbour
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, 1.0 + 3 * 2**-12,
                      -(1.0 + 3 * 2**-11)])
    assert ref.to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, 1.0, 1.0 + 2**-10,
                                       -(1.0 + 2**-9)]


def test_reference_step_follows_history_and_counters():
    cfg = {"depth": 3}
    regs = ref.fresh_timing("itp", 4, 3, "cpu")
    regs = ref.record("itp", regs, torch.tensor([1, 0, 1, 0]), 3)
    regs = ref.record("itp", regs, torch.tensor([0, 0, 1, 1]), 3)
    assert regs.tolist() == [[0, 0, 1, 1], [1, 0, 1, 0], [0, 0, 0, 0]]
    mags = ref.magnitudes("itp", regs, 1.0, 4.0, cfg["depth"])
    tau = 4.0 * 0.6931471805599453
    assert mags.tolist() == pytest.approx([2 ** (-1 / tau), 0.0, 1.0, 1.0])
    cnt = ref.fresh_timing("exact", 3, 3, "cpu")
    for s in ([1, 0, 0], [0, 0, 0], [0, 1, 0]):
        cnt = ref.record("exact", cnt, torch.tensor(s), 3)
    assert cnt.tolist() == [2, 0, 3]
    assert ref.magnitudes("exact", cnt, 1.0, 4.0, 3).tolist() == pytest.approx(
        [float(torch.tensor(-0.5, dtype=torch.float64).exp()), 1.0, 0.0])
