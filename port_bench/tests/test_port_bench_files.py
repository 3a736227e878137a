"""Every configuration, cell and metric of the benchmark loads by name, and
a new one is picked up from new files (and entries in ``BENCHMARK.json``)
with no edit to any file already there."""
from __future__ import annotations

import json
import re

import pytest
from tiny import CELLS, ROOT, tiny_root

from port_bench import run
from port_bench.reference import snn as ref

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_contract_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert {m["name"] for m in BENCH["end_to_end"]} == {"samples_per_s", "setup_s"}
    assert all(m["moves"] == "samples_per_s" for m in BENCH["per_layer"])
    assert [c["name"] for c in BENCH["workloads"]] == list(CELLS)
    assert all(c["chips"] == 1 for c in BENCH["workloads"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    spec = run.load_cell(cell)
    assert spec["cfg"]["name"] == spec["cell"]["config"]
    assert set(spec["limits"]) <= {"v_gap", "dw_gap", "w_gap", "mismatches"}
    for m in spec["per_layer"]:
        assert callable(run.metric_reader(ROOT, m["name"]).read)
    assert {m["name"] for m in spec["end_to_end"]} == {"samples_per_s", "setup_s"}


@pytest.mark.parametrize("cfg_name", ["2layer-snn-6400", "6layer-dcsnn"])
def test_config_is_the_programs_maker(cfg_name):
    """The configuration file holds the net as the port's maker builds it."""
    from repro_torch.models import snn

    from port_bench.system import program_config

    entry = next(c for c in BENCH["configs"] if c["name"] == cfg_name)
    cfg = json.loads((ROOT / entry["file"]).read_text())
    maker = {"2layer-snn": lambda: snn.mnist_2layer(n_hidden=6400, backend="fused"),
             "6layer-dcsnn": lambda: snn.fmnist_dcsnn(backend="fused")}[cfg["net"]]
    assert program_config(cfg, "itp") == maker()
    shapes = ref.weight_shapes(cfg)
    assert shapes == {"2layer-snn": [(784, 6400)],
                      "6layer-dcsnn": [(25, 12), (108, 24), (600, 128)]}[cfg["net"]]


def test_new_metric_and_cell_from_new_files(tmp_path):
    """A metric and a cell added as new files (and entries) run with no edit
    to the harness or to any data file already there."""
    root = tiny_root(tmp_path)
    (root / "port_bench" / "metrics" / "batches_traced.py").write_text(
        "def read(tr):\n    return float(tr.batches)\n")
    traffic = json.loads((root / "port_bench/traffic/train-b256.json").read_text())
    traffic.update(batch=6)
    (root / "port_bench/traffic/train-b6.json").write_text(json.dumps(traffic))
    (root / "port_bench/limits/snn64-train-b6.json").write_text(
        (root / "port_bench/limits/dcsnn-train-b2048.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "snn64-train-b6", "config": "2layer-snn-6400",
                               "traffic": "train-b6", "chips": 1, "why": "a test cell"})
    bench["per_layer"].append({"name": "batches_traced", "unit": "batches",
                               "better": "higher", "source": "program_counter",
                               "layer": "net step, whole", "moves": "samples_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = run.load_cell("snn64-train-b6", root)
    line, _ = run.run_cell(spec, 11, 0.0, 1, "cpu")
    assert line["correct"]
    assert line["metrics"]["batches_traced"]["value"] == run.TRACE_BATCHES
    # metrics without a list of cells reach the new cell; listed ones do not
    assert {"host_ms_per_step", "mfu"} <= set(line["metrics"])
    assert "update_launches_per_step" not in line["metrics"]
