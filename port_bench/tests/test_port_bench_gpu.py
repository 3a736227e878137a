"""On the card: each cell, cut as in the CPU tests, is correct, its control
is not, and the look for a chip passes.  Run there with
``python -m pytest -q -p no:cacheprovider -m gpu port_bench/tests``."""
from __future__ import annotations

import shutil
import subprocess
import sys

import pytest
from tiny import CELLS, ROOT, tiny_root

from port_bench import run


def _cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_cell_and_control_on_the_card(tmp_path, cell):
    device = _cuda()
    spec = run.load_cell(cell, tiny_root(tmp_path))
    line, numbers = run.run_cell(spec, 9, 0.0, 1, device)
    assert line["correct"], numbers
    assert line["device"]["busy_s"] > 0
    line, _ = run.run_cell(spec, 9, 0.0, 0, device,
                           make_net=run.family_module(spec).CONTROL)
    assert not line["correct"]


@pytest.mark.gpu
def test_no_program_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and ``port_bench/``
    the run fails and prints no result."""
    _cuda()
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench")
    out = subprocess.run([sys.executable, "port_bench/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and not out.stdout.strip()
